"""InternVL2-2B — VLM: InternViT vision encoder (STUB per assignment —
input_specs provides projected patch embeddings) + InternLM2-1.8B language
backbone [arXiv:2404.16821]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b", arch_type="vlm",
    n_layers=24, d_model=2048, vocab=92553,
    n_heads=16, n_kv_heads=8, d_head=128, rope_theta=1e6,
    d_ff=8192,
    frontend="vision_stub", frontend_seq=256,
)

SMOKE = ModelConfig(
    name="internvl2-smoke", arch_type="vlm",
    n_layers=2, d_model=128, vocab=512,
    n_heads=4, n_kv_heads=2, d_head=32, d_ff=256,
    frontend="vision_stub", frontend_seq=8, dtype="float32",
)
