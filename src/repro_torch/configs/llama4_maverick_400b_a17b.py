"""Llama-4 Maverick 400B-A17B — MoE 128 experts top-1 + shared expert,
iRoPE-style attention (every 4th layer full-attention, the rest sliding
window 8192), early fusion [hf:meta-llama/Llama-4-Scout-17B-16E family].

40 heads pad to 48 for the 16-way TP axis. LONG_CONTEXT makes every layer
sliding-window (ring cache) so long_500k decode keeps O(window) state."""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b", arch_type="moe",
    n_layers=48, d_model=5120, vocab=202048,
    n_heads=40, n_kv_heads=8, d_head=128, rope_theta=5e5,
    d_ff=8192, n_experts=128, experts_per_token=1,
    moe_shared_expert=True, moe_every=2,
    sliding_window=8192, swa_pattern=4,
    use_fsdp=True,
    train_microbatch=8,
)

LONG_CONTEXT = dataclasses.replace(CONFIG,
                                   name="llama4-maverick-400b-a17b-swa",
                                   swa_pattern=0)

SMOKE = ModelConfig(
    name="llama4-smoke", arch_type="moe",
    n_layers=2, d_model=128, vocab=512,
    n_heads=4, n_kv_heads=2, d_head=32,
    d_ff=96, n_experts=4, experts_per_token=1, moe_shared_expert=True,
    moe_every=2, sliding_window=16, swa_pattern=2, dtype="float32",
)
