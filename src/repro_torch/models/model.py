"""Model assembly: parameter declaration for every architecture family and
the train forward of the attention families on one device (the JAX
package's models/model.py).

`declare_params` ports every branch, so shapes, stacked masks and
UnitPlans equal the reference's for all ten archs. `Model.loss` runs the
dense (GQA / MQA / MLA), MoE (interleaved too) and VLM families; the SSM,
hybrid and audio losses, prefill / decode and the caches are ROADMAP Queue
1 item 3b and raise. Layers run in a Python loop over the stacked leaves
(the reference's lax.scan), each under torch.utils.checkpoint when
`remat` (the reference's jax.checkpoint with nothing saveable); the
reference's optimization barrier, a guard against XLA hoisting, has no
counterpart.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.utils.checkpoint as checkpoint

from repro_torch.core.wire import not_ported
from repro_torch.models import blocks as B
from repro_torch.models.config import ModelConfig
from repro_torch.models.dist import (DistConfig, tp_region_in, vp_embed,
                                     vp_xent_chunked)
from repro_torch.models.layers import apply_norm, sinusoid_positions
from repro_torch.models.params import LeafMeta, ParamBuilder

ITEM_3B = B.ITEM_3B


def _ceil_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# ==========================================================================
# parameter declaration
# ==========================================================================

def _add_norm(pb: ParamBuilder, path: str, shape, cfg, stacked):
    pb.add(path + "_g", shape, (None,) * len(shape), stacked=stacked,
           init="ones")
    if cfg.norm == "layernorm":
        pb.add(path + "_b", shape, (None,) * len(shape), stacked=stacked,
               init="zeros")


def _add_attn(pb: ParamBuilder, base: str, cfg: ModelConfig, tp_size: int,
              L: Optional[int], F, prefix: str = ""):
    """GQA attention tensors. L=None -> non-stacked (shared block)."""
    d = cfg.d_model
    Hp = _ceil_to(cfg.n_heads, tp_size)
    dh = cfg.d_head
    stk = L is not None
    lead = (L,) if stk else ()
    la = (None,) if stk else ()
    _add_norm(pb, f"{base}/{prefix}attn_norm", lead + (d,), cfg, stk)
    pb.add(f"{base}/{prefix}wq", lead + (d, Hp * dh), la + (F, "tp"),
           stacked=stk, fan_in_dim=len(lead))
    pb.add(f"{base}/{prefix}wk", lead + (d, cfg.n_kv_heads * dh),
           la + (F, None), stacked=stk, tp_grad_sync=True,
           fan_in_dim=len(lead))
    pb.add(f"{base}/{prefix}wv", lead + (d, cfg.n_kv_heads * dh),
           la + (F, None), stacked=stk, tp_grad_sync=True,
           fan_in_dim=len(lead))
    pb.add(f"{base}/{prefix}wo", lead + (Hp * dh, d), la + ("tp", F),
           stacked=stk, fan_in_dim=len(lead))


def _add_mla(pb: ParamBuilder, base: str, cfg: ModelConfig, tp_size: int,
             L: int, F):
    d = cfg.d_model
    Hp = _ceil_to(cfg.n_heads, tp_size)
    qr, r = cfg.q_lora_rank, cfg.kv_lora_rank
    nope, rd, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    _add_norm(pb, f"{base}/attn_norm", (L, d), cfg, True)
    pb.add(f"{base}/wq_down", (L, d, qr), (None, F, None), stacked=True,
           tp_grad_sync=True, fan_in_dim=1)
    pb.add(f"{base}/q_norm_g", (L, qr), (None, None), stacked=True,
           init="ones")
    pb.add(f"{base}/wq_up", (L, qr, Hp * (nope + rd)), (None, None, "tp"),
           stacked=True, fan_in_dim=1)
    pb.add(f"{base}/wkv_down", (L, d, r + rd), (None, F, None), stacked=True,
           tp_grad_sync=True, fan_in_dim=1)
    pb.add(f"{base}/kv_norm_g", (L, r), (None, None), stacked=True,
           init="ones")
    pb.add(f"{base}/wk_up", (L, r, Hp * nope), (None, None, "tp"),
           stacked=True, fan_in_dim=1)
    pb.add(f"{base}/wv_up", (L, r, Hp * vd), (None, None, "tp"),
           stacked=True, fan_in_dim=1)
    pb.add(f"{base}/wo", (L, Hp * vd, d), (None, "tp", F), stacked=True,
           fan_in_dim=1)


def _add_mlp(pb: ParamBuilder, base: str, cfg: ModelConfig, L: Optional[int],
             F, names=("w_gate", "w_in", "w_out"), d_ff=None,
             prefix: str = ""):
    d = cfg.d_model
    ff = d_ff or cfg.d_ff
    stk = L is not None
    lead = (L,) if stk else ()
    la = (None,) if stk else ()
    _add_norm(pb, f"{base}/{prefix}mlp_norm", lead + (d,), cfg, stk)
    if cfg.mlp == "swiglu":
        pb.add(f"{base}/{prefix}{names[0]}", lead + (d, ff), la + (F, "tp"),
               stacked=stk, fan_in_dim=len(lead))
    pb.add(f"{base}/{prefix}{names[1]}", lead + (d, ff), la + (F, "tp"),
           stacked=stk, fan_in_dim=len(lead))
    pb.add(f"{base}/{prefix}{names[2]}", lead + (ff, d), la + ("tp", F),
           stacked=stk, fan_in_dim=len(lead))


def _add_moe(pb: ParamBuilder, base: str, cfg: ModelConfig, L: int, F,
             prefix: str = ""):
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    _add_norm(pb, f"{base}/{prefix}mlp_norm", (L, d), cfg, True)
    pb.add(f"{base}/{prefix}router", (L, d, E), (None, None, None),
           stacked=True, tp_grad_sync=True, fan_in_dim=1)
    if cfg.mlp == "swiglu":
        pb.add(f"{base}/{prefix}w_gate", (L, E, d, ff), (None, "tp", F, None),
               stacked=True, fan_in_dim=2)
    pb.add(f"{base}/{prefix}w_in", (L, E, d, ff), (None, "tp", F, None),
           stacked=True, fan_in_dim=2)
    pb.add(f"{base}/{prefix}w_out", (L, E, ff, d), (None, "tp", None, F),
           stacked=True, fan_in_dim=2)
    if cfg.moe_shared_expert:
        pb.add(f"{base}/{prefix}shared_w_gate", (L, d, ff), (None, F, "tp"),
               stacked=True, fan_in_dim=1)
        pb.add(f"{base}/{prefix}shared_w_in", (L, d, ff), (None, F, "tp"),
               stacked=True, fan_in_dim=1)
        pb.add(f"{base}/{prefix}shared_w_out", (L, ff, d), (None, "tp", F),
               stacked=True, fan_in_dim=1)


def _add_ssm(pb: ParamBuilder, base: str, cfg: ModelConfig, L: int, F):
    d = cfg.d_model
    d_in = cfg.ssm_expand * d
    nh = d_in // cfg.ssm_head_dim
    N, K, G = cfg.ssm_state, cfg.ssm_conv, cfg.ssm_groups
    _add_norm(pb, f"{base}/norm_in", (L, d), cfg, True)
    pb.add(f"{base}/w_z", (L, d, d_in), (None, F, "tp"), stacked=True,
           fan_in_dim=1)
    pb.add(f"{base}/w_x", (L, d, d_in), (None, F, "tp"), stacked=True,
           fan_in_dim=1)
    pb.add(f"{base}/w_bc", (L, d, 2 * G * N), (None, F, None), stacked=True,
           tp_grad_sync=True, fan_in_dim=1)
    pb.add(f"{base}/w_dt", (L, d, nh), (None, F, "tp"), stacked=True,
           fan_in_dim=1)
    pb.add(f"{base}/conv_x", (L, d_in, K), (None, "tp", None), stacked=True,
           scale=0.5, fan_in_dim=2)
    pb.add(f"{base}/conv_bc", (L, 2 * G * N, K), (None, None, None),
           stacked=True, tp_grad_sync=True, scale=0.5, fan_in_dim=2)
    pb.add(f"{base}/A_log", (L, nh), (None, "tp"), stacked=True, init="zeros")
    pb.add(f"{base}/D", (L, nh), (None, "tp"), stacked=True, init="ones")
    pb.add(f"{base}/dt_bias", (L, nh), (None, "tp"), stacked=True,
           init="zeros")
    pb.add(f"{base}/norm_g", (L, d_in), (None, "tp"), stacked=True,
           init="ones")
    pb.add(f"{base}/w_out", (L, d_in, d), (None, "tp", F), stacked=True,
           fan_in_dim=1)


def declare_params(cfg: ModelConfig, tp_size: int) -> ParamBuilder:
    pb = ParamBuilder(cfg.dtype)
    F = "fsdp" if cfg.use_fsdp else None
    d, L = cfg.d_model, cfg.n_layers
    Vp = _ceil_to(cfg.vocab, 128)

    pb.add("embed", (Vp, d), ("tp", F), fan_in_dim=1)
    if not cfg.tie_embeddings:
        pb.add("head", (d, Vp), (F, "tp"), fan_in_dim=0)
    _add_norm(pb, "final_norm", (d,), cfg, False)

    if cfg.arch_type in ("dense", "vlm", "moe"):
        if cfg.n_experts and cfg.moe_every > 1:
            # interleaved MoE (llama4): one stacked unit = dense block + MoE
            # block; params carry a_/b_ prefixes within the unit.
            if cfg.moe_every != 2 or L % 2:
                raise ValueError("interleaved MoE needs moe_every == 2 and "
                                 f"an even n_layers, got {cfg.moe_every} / "
                                 f"{L}")
            Lu = L // 2
            _add_attn(pb, "blocks", cfg, tp_size, Lu, F, prefix="a_")
            _add_mlp(pb, "blocks", cfg, Lu, F, prefix="a_")
            _add_attn(pb, "blocks", cfg, tp_size, Lu, F, prefix="b_")
            _add_moe(pb, "blocks", cfg, Lu, F, prefix="b_")
        else:
            if cfg.attention == "gqa":
                _add_attn(pb, "blocks", cfg, tp_size, L, F)
            else:
                _add_mla(pb, "blocks", cfg, tp_size, L, F)
            if cfg.n_experts:
                _add_moe(pb, "blocks", cfg, L, F)
            else:
                _add_mlp(pb, "blocks", cfg, L, F)
    elif cfg.arch_type == "ssm":
        _add_ssm(pb, "blocks", cfg, L, F)
    elif cfg.arch_type == "hybrid":
        G = L // cfg.attn_every
        tail = L - G * cfg.attn_every
        _add_ssm(pb, "blocks", cfg, G * cfg.attn_every, F)
        if tail:
            _add_ssm(pb, "tail_blocks", cfg, tail, F)
        _add_attn(pb, "shared", cfg, tp_size, None, F)
        _add_mlp(pb, "shared", cfg, None, F)
    elif cfg.arch_type == "audio":
        Le = cfg.encoder_layers
        pb.add("enc_pos", (cfg.frontend_seq, d), (None, None), scale=0.02,
               fan_in_dim=1)
        _add_attn(pb, "encoder_blocks", cfg, tp_size, Le, F)
        _add_mlp(pb, "encoder_blocks", cfg, Le, F)
        _add_norm(pb, "enc_final_norm", (d,), cfg, False)
        _add_attn(pb, "decoder_blocks", cfg, tp_size, L, F)
        _add_norm(pb, "decoder_blocks/cross_norm", (L, d), cfg, True)
        pb.add("decoder_blocks/cwq",
               (L, d, _ceil_to(cfg.n_heads, tp_size) * cfg.d_head),
               (None, F, "tp"), stacked=True, fan_in_dim=1)
        pb.add("decoder_blocks/cwk", (L, d, cfg.d_kv), (None, F, None),
               stacked=True, tp_grad_sync=True, fan_in_dim=1)
        pb.add("decoder_blocks/cwv", (L, d, cfg.d_kv), (None, F, None),
               stacked=True, tp_grad_sync=True, fan_in_dim=1)
        pb.add("decoder_blocks/cwo",
               (L, _ceil_to(cfg.n_heads, tp_size) * cfg.d_head, d),
               (None, "tp", F), stacked=True, fan_in_dim=1)
        _add_mlp(pb, "decoder_blocks", cfg, L, F)
    else:
        raise ValueError(cfg.arch_type)
    return pb


# ==========================================================================
# the Model
# ==========================================================================

class Model:
    """One architecture's parameters and train loss on one device. Params
    are nested dicts of tensors in the JAX layout (stacked leaves lead
    with the layer count), so UnitPlan ids, PRNG folds and bucket order
    equal the reference's."""

    def __init__(self, cfg: ModelConfig, dist: DistConfig,
                 mesh_axis_sizes: Optional[Dict[str, int]] = None):
        """`mesh_axis_sizes` is the reference's; one device has no mesh
        (DistConfig refuses a tp axis), so the TP size is 1."""
        self.cfg = cfg
        self.dist = dist
        self.tp_size = 1
        self.pb = declare_params(cfg, self.tp_size)
        self.meta = self.pb.meta()
        self.vocab_padded = _ceil_to(cfg.vocab, 128)

    # ---- plumbing ------------------------------------------------------
    def init(self, key: torch.Tensor, device="cuda") -> Dict:
        return self.pb.init(key, device=device)

    def param_shapes(self) -> Dict:
        return self.pb.shapes()

    def stacked(self) -> Dict:
        return self.pb.stacked_mask()

    def fsdp_mask(self) -> Dict:
        """True for leaves aggregated inside the backward (an FSDP hook):
        none on one device."""
        def walk(t):
            if isinstance(t, LeafMeta):
                return t.fsdp_dim() is not None and self.dist.fsdp is not None
            return {k: walk(v) for k, v in t.items()}
        return walk(self.meta)

    def _layer_window(self, idx: int) -> int:
        """Layer idx's sliding window (0 = full attention): every
        swa_pattern-th layer full, the rest cfg.sliding_window."""
        cfg = self.cfg
        if cfg.swa_pattern > 0:
            return 0 if (idx + 1) % cfg.swa_pattern == 0 \
                else cfg.sliding_window
        return cfg.sliding_window

    # ---- embedding / head ----------------------------------------------
    def _embed(self, params, tokens):
        return vp_embed(params["embed"], tokens, self.dist.tp,
                        self.vocab_padded)

    def _head_weight(self, params):
        """(d, V) head matrix (the tied embedding transposed)."""
        if self.cfg.tie_embeddings:
            return params["embed"].transpose(0, 1)
        return params["head"]

    def _lm_loss(self, params, x, targets):
        """Final norm, then the chunked fused head + cross-entropy (the
        full logits never materialized), mean over the tokens."""
        cfg = self.cfg
        Bt, S_tot = targets.shape
        x = apply_norm(params, "final_norm", x, cfg)
        xi = tp_region_in(x, self.dist.tp)
        s = vp_xent_chunked(xi.reshape(-1, cfg.d_model),
                            self._head_weight(params), targets.reshape(-1),
                            self.dist.tp, cfg.vocab)
        return s / (Bt * S_tot)

    # ---- decoder stack (train) -----------------------------------------
    def _run_stack(self, p_blocks, x, *, block_kind: str, pos_offset=0,
                   causal=True, remat=True):
        """x through every stacked layer of p_blocks -> (x, aux f32)."""
        cfg = self.cfg
        if block_kind != "decoder":
            raise not_ported(f"the {block_kind} stack", ITEM_3B)
        dist = self.dist
        interleaved = cfg.n_experts and cfg.moe_every > 1
        names = list(p_blocks)
        layers = zip(*(p_blocks[k].unbind(0) for k in names))

        def apply(g, x, idx):
            if interleaved:
                ga = {k[2:]: v for k, v in g.items() if k.startswith("a_")}
                gb = {k[2:]: v for k, v in g.items() if k.startswith("b_")}
                cfg_a = dataclasses.replace(cfg, n_experts=0)
                x, aux_a, _ = B.decoder_block(
                    ga, x, cfg_a, dist, window=self._layer_window(2 * idx),
                    pos_offset=pos_offset, causal=causal,
                    use_rope=cfg.use_rope, tp_size=self.tp_size)
                x, aux_b, _ = B.decoder_block(
                    gb, x, cfg, dist, window=self._layer_window(2 * idx + 1),
                    pos_offset=pos_offset, causal=causal,
                    use_rope=cfg.use_rope, tp_size=self.tp_size)
                return x, aux_a + aux_b
            x, aux, _ = B.decoder_block(
                g, x, cfg, dist, window=self._layer_window(idx),
                pos_offset=pos_offset, causal=causal, use_rope=cfg.use_rope,
                tp_size=self.tp_size)
            return x, aux

        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for idx, leaves in enumerate(layers):
            g = dict(zip(names, leaves))
            if remat and torch.is_grad_enabled():
                x, aux_l = checkpoint.checkpoint(apply, g, x, idx,
                                                 use_reentrant=False)
            else:
                x, aux_l = apply(g, x, idx)
            aux = aux + aux_l
        return x, aux

    # ---- top-level forward: train loss ----------------------------------
    def loss(self, params, batch, key=None, comp=None, remat: bool = True):
        """Mean next-token cross-entropy + 0.01 x the MoE aux loss. `key`
        and `comp` are the reference's (they drive its FSDP gradient hook,
        which one device does not have)."""
        cfg = self.cfg
        if cfg.arch_type not in ("dense", "moe", "vlm"):
            raise not_ported(f"the {cfg.arch_type} family's loss", ITEM_3B)
        tokens = batch["tokens"]
        x = self._embed(params, tokens)
        if cfg.arch_type == "vlm":
            patches = batch["patch_embeds"].to(x.dtype)
            x = torch.cat([patches, x[:, patches.shape[1]:]], dim=1)
        if not cfg.use_rope:
            pos = torch.arange(x.shape[1], device=x.device)
            x = x + sinusoid_positions(pos, cfg.d_model).to(x.dtype)[None]
        x, aux = self._run_stack(params["blocks"], x, block_kind="decoder",
                                 remat=remat)
        return self._lm_loss(params, x, batch["targets"]) + 0.01 * aux

    # ---- the serving path: ROADMAP Queue 1 item 3b -----------------------
    def prefill(self, *args, **kwargs):
        raise not_ported("Model.prefill", ITEM_3B)

    def decode_step(self, *args, **kwargs):
        raise not_ported("Model.decode_step", ITEM_3B)

    def init_cache(self, *args, **kwargs):
        raise not_ported("Model.init_cache", ITEM_3B)
