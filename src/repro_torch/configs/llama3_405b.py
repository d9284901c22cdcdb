"""Llama-3.1 405B — dense, GQA, 128k vocab [arXiv:2407.21783]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b", arch_type="dense",
    n_layers=126, d_model=16384, vocab=128256,
    n_heads=128, n_kv_heads=8, d_head=128, rope_theta=5e5,
    d_ff=53248,
    use_fsdp=True,
    train_microbatch=16,
)

SMOKE = ModelConfig(
    name="llama3-smoke", arch_type="dense",
    n_layers=2, d_model=128, vocab=512,
    n_heads=4, n_kv_heads=2, d_head=32, d_ff=256,
    dtype="float32",
)
