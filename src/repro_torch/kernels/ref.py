"""Plain-torch oracles of the compression kernels: the arithmetic the CUDA
kernels in csrc/ perform, written as tensor ops (the JAX package's
kernels/ref.py, lines 68-153).

Integer codes and uint32 words are carried in int64 tensors (values
< 2**32) because torch on the CPU has no uint32 arithmetic. At buffer
boundaries words are held as int32 tensors with the uint32 bit pattern
(`words_to_i32` / `words_from_i32`), which is what the kernels write.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.prng import MASK32


def words_per_unit(d: int, width: int) -> int:
    """uint32 payload words of one unit's packed field leg."""
    return -(-d * width // 32)


def qsgd_codes_ref(x, u, nrm, levels: int) -> torch.Tensor:
    """QSGD offset-binary codes in [0, 2*levels]: stochastic-round
    |x|/nrm*levels with uniform u, then sign*level + levels. `nrm` is the
    unit l2 norm WITH the compressor's +1e-12 already added (broadcasts)."""
    y = x.abs() / nrm * levels
    lo = torch.floor(y)
    lev = lo + (u < (y - lo)).to(y.dtype)
    return (torch.sign(x) * lev).to(torch.int64) + levels


def terngrad_codes_ref(x, u, scale) -> torch.Tensor:
    """TernGrad codes in {0, 1, 2}: sign(x)*Bernoulli(|x|/scale) + 1.
    `scale` is max|x| WITH the compressor's +1e-12 already added."""
    b = (u < x.abs() / scale).to(torch.int64)
    return torch.sign(x).to(torch.int64) * b + 1


def sign_codes_ref(x) -> torch.Tensor:
    """signSGD 1-bit codes: x >= 0 (-0.0 gives 1, NaN gives 0)."""
    return (x >= 0).to(torch.int64)


def qsgd_decode_ref(codes, fac, levels: int) -> torch.Tensor:
    """(codes - levels) * fac, with fac = nrm / levels divided by the caller."""
    return (codes - levels).to(torch.float32) * fac


def terngrad_decode_ref(codes, scale) -> torch.Tensor:
    return (codes - 1).to(torch.float32) * scale


def sign_decode_ref(codes) -> torch.Tensor:
    """1-bit codes -> f32 +1 / -1."""
    return (2 * codes - 1).to(torch.float32)


def pack_fields_tile(fields: torch.Tensor, width: int) -> torch.Tensor:
    """(R, C) int64 fields with C % 32 == 0, values < 2**width ->
    (R, C*width//32) int64 words (little-endian bit order: field i's low
    bit lands at bit-stream position i*width). Every 32-field chunk spans
    exactly `width` whole words, so chunks never straddle."""
    R, C = fields.shape
    nc = C // 32
    v = fields.reshape(R, nc, 32)
    words = []
    for t in range(width):
        w = torch.zeros((R, nc), dtype=torch.int64, device=fields.device)
        for j in range(32):
            lo, hi = j * width, (j + 1) * width      # field j's bit span
            if hi <= 32 * t or lo >= 32 * (t + 1):   # no overlap with word t
                continue
            s = lo - 32 * t
            f = v[:, :, j]
            w = w | (((f << s) & MASK32) if s >= 0 else (f >> -s))
        words.append(w)
    return torch.stack(words, dim=2).reshape(R, nc * width)


def unpack_fields_tile(words: torch.Tensor, width: int) -> torch.Tensor:
    """(R, nc*width) int64 words -> (R, nc*32) int64 fields. Inverse of
    pack_fields_tile."""
    R, W = words.shape
    nc = W // width
    v = words.reshape(R, nc, width)
    mask = (1 << width) - 1
    fields = []
    for j in range(32):
        lo = j * width
        t0, s = lo // 32, lo % 32
        f = v[:, :, t0] >> s
        if lo + width > 32 * (t0 + 1):               # straddles into t0+1
            f = f | (v[:, :, t0 + 1] << (32 - s))
        fields.append(f & mask)
    return torch.stack(fields, dim=2).reshape(R, nc * 32)


def words_to_i32(w: torch.Tensor) -> torch.Tensor:
    """int64 words (values < 2**32) -> int32 tensor with the same bits."""
    return torch.where(w >= (1 << 31), w - (1 << 32), w).to(torch.int32)


def words_from_i32(w: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 words in [0, 2**32)."""
    return w.to(torch.int64) & MASK32
