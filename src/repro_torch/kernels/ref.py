"""Plain-torch oracles of the compression kernels: the arithmetic the CUDA
kernels in csrc/ perform, written as tensor ops (the JAX package's
kernels/ref.py).

Integer codes and uint32 words are carried in int64 tensors (values
< 2**32) because torch on the CPU has no uint32 arithmetic. At buffer
boundaries words are held as int32 tensors with the uint32 bit pattern
(`words_to_i32` / `words_from_i32`), which is what the kernels write.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.prng import MASK32

_EPS = 1e-12
TOPK_ITERS = 24


def sign(x: torch.Tensor) -> torch.Tensor:
    """jnp.sign: +-1, and x itself for +-0.0 and NaN (torch.sign maps
    -0.0 and NaN to +0.0)."""
    return torch.where(x > 0, 1.0, torch.where(x < 0, -1.0, x))


# ---- compress-only oracles (kernels/ref.py:16-58) ---------------------------

def fma_f32(a, b, c) -> torch.Tensor:
    """fl32(a * b + c) rounded once (fmaf), for f32 tensors a, c and b an
    f32 tensor (broadcast) or a small integer. The product is exact in
    f64; the f64 sum is made round-to-odd (TwoSum error, then a step to the
    odd neighbour when inexact), so rounding it to f32 rounds the exact sum
    correctly."""
    p = a.to(torch.float64) * (b.to(torch.float64)
                               if isinstance(b, torch.Tensor) else float(b))
    c = c.to(torch.float64)
    s = p + c
    t = s - p
    err = (p - (s - t)) + (c - t)
    even = (s.view(torch.int64) & 1) == 0
    step = (err != 0) & even & torch.isfinite(s)
    away = torch.where(err > 0, torch.inf, -torch.inf).to(torch.float64)
    return torch.where(step, torch.nextafter(s, away), s).to(torch.float32)


def qsgd_ref(x, noise, norm, levels: int) -> torch.Tensor:
    """QSGD quantize+dequantize against an l2 norm (a scalar, or one per row
    as an (R, 1) column): n = max(norm, 1e-12),
    sign(x) * floor(|x| / n * levels + u) * fac, as the reference's jitted
    code computes it on XLA's CPU backend: the multiply-add is contracted
    into one fma, and fac = n / levels is n * f32(1 / levels), a multiply
    by the rounded reciprocal."""
    n = norm.clamp_min(_EPS)            # f32(1e-12); a NaN norm stays NaN
    lev = torch.floor(fma_f32(x.abs() / n, levels, noise))
    return sign(x) * lev * (n * (1.0 / levels))   # f32(1 / levels)


def terngrad_ref(x, noise, scale) -> torch.Tensor:
    """TernGrad quantize+dequantize: s = max(scale, 1e-12),
    sign(x) * [u < |x| / s] * s. XLA turns the reference's multiply by the
    0/1 mask into a select, so a dropped entry is +0.0 (not -0.0 or NaN)."""
    s = scale.clamp_min(_EPS)
    return torch.where(noise < x.abs() / s, sign(x), 0.0) * s


def topk_mask_ref(x, k: int, iters: int = TOPK_ITERS) -> torch.Tensor:
    """Per-row top-k by magnitude: `iters` bisection halvings of [0, row
    max] for the threshold lo with count(|x| >= lo) > k (ties at the
    threshold keep more than k), then x where |x| >= lo, else +0.0 (XLA
    turns the reference's multiply by the mask into this select)."""
    mag = x.abs()
    hi = mag.amax(dim=-1, keepdim=True)
    lo = torch.zeros_like(hi)
    for _ in range(iters):
        thr = 0.5 * (lo + hi)
        pred = (mag >= thr).sum(dim=-1, keepdim=True) > k
        lo, hi = torch.where(pred, thr, lo), torch.where(pred, hi, thr)
    return torch.where(mag >= lo, x, 0.0)


def rmsnorm_ref(x, gamma, eps: float = 1e-5) -> torch.Tensor:
    """Row-wise RMSNorm over the last axis, computed in f32 and cast back
    to x's dtype."""
    xf = x.to(torch.float32)
    ms = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps)
            * gamma.to(torch.float32)).to(x.dtype)


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


def pack_bits_ref(bits: torch.Tensor) -> torch.Tensor:
    """(R, C) {0,1} int64 bits with C % 32 == 0 -> (R, C//32) int64 words:
    bit i of a row lands in word i//32 at position i%32 (little-endian;
    the JAX package's ref.pack_bits_ref)."""
    R, C = bits.shape
    w = bits.reshape(R, C // 32, 32)
    weights = 1 << torch.arange(32, dtype=torch.int64, device=bits.device)
    return (w * weights).sum(dim=-1)


def unpack_bits_ref(words: torch.Tensor) -> torch.Tensor:
    """(R, W) int64 words -> (R, 32*W) {0,1} int64 bits. Inverse of
    pack_bits_ref."""
    R, W = words.shape
    sh = torch.arange(32, dtype=torch.int64, device=words.device)
    return ((words[..., None] >> sh) & 1).reshape(R, W * 32)


def majority_words_ref(words: torch.Tensor) -> torch.Tensor:
    """(n_workers, W) int64 packed sign words -> (W,) majority words (the
    JAX package's ref.py:177-192, word for word). Per bit position the
    vote count lives in bit_length(n) word-wide bit planes, added with a
    ripple carry per worker; a borrow chain then compares it with
    thr = ceil(n/2), so a bit is set where 2*count >= n (ties -> +1).
    All-zero (padding) columns vote 0."""
    n = words.shape[0]
    planes = [torch.zeros_like(words[0])
              for _ in range(max(1, n.bit_length()))]
    for i in range(n):
        c = words[i]
        for pi in range(len(planes)):                # ripple-carry add 1 bit
            planes[pi], c = planes[pi] ^ c, planes[pi] & c
    thr = (n + 1) // 2
    borrow = torch.zeros_like(words[0])
    for pi, a in enumerate(planes):                  # borrow of count - thr
        na = ~a & MASK32
        borrow = (na | borrow) if (thr >> pi) & 1 else (na & borrow)
    return ~borrow & MASK32                          # count >= thr


def words_to_i32(w: torch.Tensor) -> torch.Tensor:
    """int64 words (values < 2**32) -> int32 tensor with the same bits."""
    return torch.where(w >= (1 << 31), w - (1 << 32), w).to(torch.int32)


def words_from_i32(w: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 words in [0, 2**32)."""
    return w.to(torch.int64) & MASK32
