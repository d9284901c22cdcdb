"""Phi-4-mini 3.8B — dense, RoPE SwiGLU GQA [arXiv:2412.08905].

24 heads do not divide the 16-way TP axis; the runtime pads to 32 heads
(zero-masked outputs). LONG_CONTEXT is the sliding-window variant that
qualifies this dense arch for long_500k per the assignment's carve-out.
"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b", arch_type="dense",
    n_layers=32, d_model=3072, vocab=200064,
    n_heads=24, n_kv_heads=8, d_head=128, rope_theta=1e4,
    d_ff=8192,
)

LONG_CONTEXT = dataclasses.replace(CONFIG, name="phi4-mini-3.8b-swa",
                                   sliding_window=8192, swa_pattern=0)

SMOKE = ModelConfig(
    name="phi4-smoke", arch_type="dense",
    n_layers=2, d_model=96, vocab=512,
    n_heads=3, n_kv_heads=1, d_head=32, d_ff=256,
    dtype="float32",
)
