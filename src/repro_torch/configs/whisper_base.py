"""Whisper-base — encoder-decoder audio model [arXiv:2212.04356].

The mel-spectrogram + conv frontend is a STUB per the assignment:
input_specs provides precomputed frame embeddings (B, 1500, 512). The
transformer backbone (encoder + decoder with cross-attention) is real.
Deviation: decoder uses sinusoidal positions (whisper uses learned) so
decode shapes beyond 448 positions remain well-defined."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", arch_type="audio",
    n_layers=6, encoder_layers=6, d_model=512, vocab=51865,
    n_heads=8, n_kv_heads=8, d_head=64,
    d_ff=2048, mlp="gelu", norm="layernorm", use_rope=False,
    tie_embeddings=True,
    frontend="audio_stub", frontend_seq=1500,
)

SMOKE = ModelConfig(
    name="whisper-smoke", arch_type="audio",
    n_layers=2, encoder_layers=2, d_model=96, vocab=512,
    n_heads=4, n_kv_heads=4, d_head=24,
    d_ff=192, mlp="gelu", norm="layernorm", use_rope=False,
    tie_embeddings=True,
    frontend="audio_stub", frontend_seq=24, dtype="float32",
)
