"""Zamba2-7B — hybrid: Mamba2 backbone + shared attention block every 6
layers [arXiv:2411.15242]. 81 SSM layers = 13 groups of 6 + 3 tail."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", arch_type="hybrid",
    n_layers=81, d_model=3584, vocab=32000,
    n_heads=32, n_kv_heads=32, d_head=112, rope_theta=1e4,
    d_ff=14336,
    ssm_state=64, ssm_expand=2, ssm_head_dim=64, ssm_chunk=64,
    attn_every=6,
)

SMOKE = ModelConfig(
    name="zamba2-smoke", arch_type="hybrid",
    n_layers=5, d_model=128, vocab=512,
    n_heads=4, n_kv_heads=4, d_head=32, d_ff=256,
    ssm_state=16, ssm_expand=2, ssm_head_dim=32, ssm_chunk=8,
    attn_every=2, dtype="float32",
)
