"""Mamba2-1.3B — attention-free SSD (state-space duality)
[arXiv:2405.21060]. d_inner=4096, 64 heads of 64, state N=128, chunk 64.
Decode state is O(1) in sequence length: long_500k runs natively."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b", arch_type="ssm", attention="none",
    n_layers=48, d_model=2048, vocab=50280,
    d_ff=0, tie_embeddings=True,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_chunk=64,
)

SMOKE = ModelConfig(
    name="mamba2-smoke", arch_type="ssm", attention="none",
    n_layers=2, d_model=128, vocab=512,
    d_ff=0, tie_embeddings=True,
    ssm_state=16, ssm_expand=2, ssm_head_dim=32, ssm_chunk=8,
    dtype="float32",
)
