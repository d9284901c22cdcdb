"""Architecture configuration schema (one instance per --arch): the
port's copy of the JAX package's models/config.py, pure Python."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str              # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    vocab: int
    # attention
    attention: str = "gqa"      # gqa | mla | none
    n_heads: int = 0
    n_kv_heads: int = 0
    d_head: int = 0
    rope_theta: float = 1e6
    sliding_window: int = 0     # 0 = full attention
    swa_pattern: int = 0        # >0: every swa_pattern-th layer is FULL attn,
                                # the rest sliding-window (llama4 iRoPE style)
    # mlp
    d_ff: int = 0
    mlp: str = "swiglu"         # swiglu | gelu
    # moe
    n_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25
    moe_shared_expert: bool = False
    moe_every: int = 1          # 2 = MoE on every 2nd layer (llama4 style)
    # mla (minicpm3 / deepseek-style)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    # ssm (mamba2 SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 64
    ssm_conv: int = 4
    ssm_groups: int = 1
    # hybrid (zamba2): shared attention block every attn_every mamba layers
    attn_every: int = 0
    # encoder-decoder (whisper)
    encoder_layers: int = 0
    frontend: str = "none"      # none | audio_stub | vision_stub
    frontend_seq: int = 0       # audio frames / vision patches per sample
    # misc
    use_rope: bool = True       # False: sinusoidal absolute positions
    norm: str = "rmsnorm"       # rmsnorm | layernorm
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    kv_cache_dtype: str = "bfloat16"  # bfloat16 | int8 (quantized KV cache:
                                      # the paper's quantizers applied to
                                      # inference state; per-vector scales)
    use_fsdp: bool = False      # >100B archs: shard params over the data axis
    train_microbatch: int = 1   # gradient-accumulation steps per train step

    @property
    def d_q(self) -> int:
        return self.n_heads * self.d_head

    @property
    def d_kv(self) -> int:
        return self.n_kv_heads * self.d_head

    @property
    def is_causal_lm(self) -> bool:
        return self.arch_type in ("dense", "moe", "ssm", "hybrid", "vlm")

    def supports_decode(self) -> bool:
        return True  # all assigned archs have a decoder

    def supports_long_context(self) -> bool:
        """long_500k eligibility per the assignment: SSM/hybrid natively,
        dense/moe only with a sliding-window variant."""
        if self.arch_type in ("ssm", "hybrid"):
            return True
        return self.sliding_window > 0

    def param_count(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS = 6·N·D)."""
        d = self.d_model
        n = 0
        # embeddings (+ head unless tied)
        n += self.vocab * d * (1 if self.tie_embeddings else 2)
        L = self.n_layers

        def attn_params() -> int:
            if self.attention == "none":
                return 0
            if self.attention == "mla":
                a = d * self.q_lora_rank
                a += self.q_lora_rank * self.n_heads * (self.qk_nope_dim + self.qk_rope_dim)
                a += d * (self.kv_lora_rank + self.qk_rope_dim)
                a += self.kv_lora_rank * self.n_heads * (self.qk_nope_dim + self.v_head_dim)
                a += self.n_heads * self.v_head_dim * d
                return a
            return d * self.d_q + 2 * d * self.d_kv + self.d_q * d

        def dense_mlp_params() -> int:
            mult = 3 if self.mlp == "swiglu" else 2
            return mult * d * self.d_ff

        def mlp_params() -> int:
            mult = 3 if self.mlp == "swiglu" else 2
            if self.n_experts:
                e = self.n_experts * mult * d * self.d_ff + d * self.n_experts
                if self.moe_shared_expert:
                    e += mult * d * self.d_ff
                # interleaved MoE: only L/moe_every layers are MoE
                if self.moe_every > 1:
                    frac = 1.0 / self.moe_every
                    return int(e * frac + dense_mlp_params() * (1 - frac))
                return e
            return mult * d * self.d_ff

        def ssm_params() -> int:
            d_in = self.ssm_expand * d
            nh = d_in // self.ssm_head_dim
            conv_dim = d_in + 2 * self.ssm_groups * self.ssm_state
            p = d * (2 * d_in + 2 * self.ssm_groups * self.ssm_state + nh)
            p += conv_dim * self.ssm_conv
            p += 3 * nh          # A_log, D, dt_bias
            p += d_in            # gated norm
            p += d_in * d        # out_proj
            return p

        if self.arch_type == "ssm":
            n += L * (ssm_params() + d)
        elif self.arch_type == "hybrid":
            n += L * (ssm_params() + d)
            if self.attn_every:
                n += attn_params() + 2 * d  # one shared attention block
        elif self.arch_type == "audio":
            n += self.encoder_layers * (attn_params() + mlp_params() + 4 * d)
            n += L * (2 * attn_params() + mlp_params() + 6 * d)  # self+cross
            n += self.frontend_seq * d  # learned positions (encoder)
        else:
            n += L * (attn_params() + mlp_params() + 4 * d)
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed experts) for
        MODEL_FLOPS = 6·N_active·D."""
        if not self.n_experts:
            return self.param_count()
        d = self.d_model
        mult = 3 if self.mlp == "swiglu" else 2
        full = self.param_count()
        n_moe_layers = self.n_layers // max(1, self.moe_every)
        all_experts = n_moe_layers * self.n_experts * mult * d * self.d_ff
        active = n_moe_layers * self.experts_per_token * mult * d * self.d_ff
        return full - all_experts + active


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}
