"""Granite-20B (code) — dense llama-arch with MQA (kv=1)
[arXiv:2405.04324]. The single kv head is TP-replicated (tp_shared grad
sync); the decode cache is sequence-sharded over the model axis."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b", arch_type="dense",
    n_layers=52, d_model=6144, vocab=49152,
    n_heads=48, n_kv_heads=1, d_head=128, rope_theta=1e4,
    d_ff=24576,
)

SMOKE = ModelConfig(
    name="granite-smoke", arch_type="dense",
    n_layers=2, d_model=128, vocab=512,
    n_heads=4, n_kv_heads=1, d_head=32, d_ff=256,
    dtype="float32",
)
