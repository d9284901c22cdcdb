"""Qwen3-235B-A22B — MoE, 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B family,
scaled per assignment: 94L d_model=4096 64H (GQA kv=4) expert d_ff=1536
vocab=151936]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", arch_type="moe",
    n_layers=94, d_model=4096, vocab=151936,
    n_heads=64, n_kv_heads=4, d_head=128, rope_theta=1e6,
    d_ff=1536, n_experts=128, experts_per_token=8,
    use_fsdp=True,
    train_microbatch=2,
)

SMOKE = ModelConfig(
    name="qwen3-moe-smoke", arch_type="moe",
    n_layers=2, d_model=128, vocab=512,
    n_heads=4, n_kv_heads=2, d_head=32,
    d_ff=96, n_experts=4, experts_per_token=2,
    dtype="float32",
)
