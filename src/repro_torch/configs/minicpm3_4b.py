"""MiniCPM3-4B — dense with Multi-head Latent Attention
[hf:openbmb/MiniCPM3-4B]: q_lora_rank=768, kv_lora_rank=256,
qk_nope/rope=64/32, v_head=64. Decode uses the absorbed-MLA trick against
a latent cache (256+32 floats per position instead of 40 full kv heads)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b", arch_type="dense", attention="mla",
    n_layers=62, d_model=2560, vocab=73448,
    n_heads=40, n_kv_heads=40, d_head=96, rope_theta=1e4,
    d_ff=6400,
    q_lora_rank=768, kv_lora_rank=256,
    qk_nope_dim=64, qk_rope_dim=32, v_head_dim=64,
)

SMOKE = ModelConfig(
    name="minicpm3-smoke", arch_type="dense", attention="mla",
    n_layers=2, d_model=128, vocab=512,
    n_heads=4, n_kv_heads=4, d_head=48, d_ff=256,
    q_lora_rank=48, kv_lora_rank=32,
    qk_nope_dim=32, qk_rope_dim=16, v_head_dim=32,
    dtype="float32",
)
