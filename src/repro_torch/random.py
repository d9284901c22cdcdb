"""The jax.random calls the reference makes, bit for bit, in plain torch.

A key is the key DATA of a jax threefry key: an int64 tensor of shape
(..., 2) holding two uint32 words (k0, k1). It is not a torch.Generator,
because the wire payloads depend on jax's exact threefry stream. Draws
follow jax's NON-partitionable layout (the reference's kernels/prng.py
reproduces that layout in-kernel; jax >= 0.5 needs
`jax.threefry_partitionable(False)` to draw the same numbers). `fold_in`
does not depend on that flag.

Keys are small control data; the port computes them on the host and
moves the per-unit tables to the card once per step.

`normal` and `randint` draw jax.random.normal / randint's numbers on the
CPU, as the reference's jitted CPU code computes them: the erf_inv, log1p
and log expansions XLA emits, with the multiply-adds it contracts into
fmas (read off the optimized HLO of jax.jit(jax.random.normal)).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.prng import MASK32, bits_to_uniform, threefry2x32
from repro_torch.kernels.ref import fma_f32


def key(seed: int, device="cpu") -> torch.Tensor:
    """jax.random.key(seed)'s key data: [0, seed] for a 32-bit seed."""
    if not -(1 << 31) <= int(seed) < (1 << 31):
        raise ValueError(f"seed must fit in int32, got {seed}")
    return torch.tensor([0, int(seed) & MASK32], dtype=torch.int64,
                        device=device)


def generator(key: torch.Tensor, device="cpu") -> torch.Generator:
    """A torch.Generator on `device` seeded from a key's two words, for
    draws that need not be jax's (initial weights, synthetic data)."""
    k = key.tolist()
    return torch.Generator(device=device).manual_seed(
        (int(k[0]) << 32) | int(k[1]))


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """jax.random.fold_in: threefry2x32(key, [0, data]). Broadcasts keys
    (..., 2) against integer `data` (int or tensor) -> (..., 2)."""
    d = torch.as_tensor(data, dtype=torch.int64, device=key.device) & MASK32
    o0, o1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack([o0, o1], dim=-1)


def _bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """jax.random.bits(key, (n,)) (32-bit) for one (2,) key."""
    count = torch.arange(n + n % 2, dtype=torch.int64, device=key.device)
    h = count.shape[0] // 2
    if n % 2:
        count[-1] = 0
    o0, o1 = threefry2x32(key[0], key[1], count[:h], count[h:])
    return torch.cat([o0, o1])[:n]


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """jax.random.split (non-partitionable) -> (num, 2) keys."""
    return _bits(key, 2 * num).reshape(num, 2)


def uniform(key: torch.Tensor, shape) -> torch.Tensor:
    """jax.random.uniform(key, shape) in f32, [0, 1)."""
    shape = tuple(shape) if not isinstance(shape, int) else (shape,)
    n = 1
    for s in shape:
        n *= s
    return bits_to_uniform(_bits(key, n)).reshape(shape)


def bernoulli(key: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """jax.random.bernoulli(key, p): uniform(key, p.shape) < p."""
    return uniform(key, p.shape).to(p.device) < p



def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def _shape(shape) -> tuple:
    return tuple(shape) if not isinstance(shape, int) else (shape,)


def _f32(v: float) -> float:
    return float(np.float32(v))


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """fl32(a * b + c) rounded once, for f32 `a` and f32 values `b` / `c`
    (tensors or Python floats). a * b is exact in f64 and the f64 sum
    rounds once; rounding that to f32 is the fma's own rounding unless the
    f64 sum landed exactly on a midpoint of two f32 neighbours (its low 29
    mantissa bits 1 followed by 28 zeros), where the rare entries take
    kernels.ref.fma_f32's round-to-odd."""
    s = a.to(torch.float64) * b + c
    r = s.to(torch.float32)
    tie = (s.view(torch.int64) & 0x1FFFFFFF) == 0x10000000
    if bool(tie.any()):
        def full(v):
            return v if isinstance(v, torch.Tensor) else torch.full_like(a, v)
        r = torch.where(tie, fma_f32(a, full(b), full(c)), r)
    return r


def _horner(x: torch.Tensor, coeffs) -> torch.Tensor:
    """c0 x^n + ... + cn in f32, each step one fma (XLA's contraction)."""
    p = torch.full_like(x, _f32(coeffs[0]))
    for c in coeffs[1:]:
        p = _fma(p, x, _f32(c))
    return p


def _sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root (XLA's; torch's CPU f32 sqrt
    is not always)."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


# XLA's CPU log: Cephes' logf polynomial, split three ways and fused
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)


def _log_f32(y: torch.Tensor) -> torch.Tensor:
    """log(y) for normal positive f32 y, as XLA's CPU backend computes it:
    the mantissa in [sqrt(1/2), sqrt(2)) minus 1, three fused Horner
    pieces of Cephes' polynomial combined with x^3, then the exponent's
    two-part ln 2."""
    m, e = torch.frexp(y)
    e = e.to(torch.float32)
    low = m < _f32(0.707106781186547524)
    x = (m - 1.0) + torch.where(low, m, 0.0)
    e = e - low.to(torch.float32)
    x2 = x * x
    x3 = x2 * x

    p = [_f32(c) for c in _LOG_P]
    ya = _fma(_fma(x, p[0], p[1]), x, p[2])
    yb = _fma(_fma(x, p[3], p[4]), x, p[5])
    yc = _fma(_fma(x, p[6], p[7]), x, p[8])
    yv = _fma(_fma(ya, x3, yb), x3, yc)
    yv = _fma(yv, x3, e * _f32(-2.12194440e-4))
    x = (x - x2 * 0.5) + yv
    return x + e * _f32(0.693359375)


# XLA's log1p below sqrt(2) - 1: Cephes' rational approximation
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)


def _log1p_f32(x: torch.Tensor) -> torch.Tensor:
    """log1p on XLA's CPU backend: for |x| < sqrt(2) - 1 the rational
    approximation x - x^2 / 2 + x^3 P(x) / Q(x), else log(1 + x) (each
    branch evaluated on its own entries only)."""
    lo = x.abs() < 0.41421356237309504880
    out = torch.empty_like(x)
    xs = x[lo]
    x2 = xs * xs
    small = (xs * x2) * (_horner(xs, _LOG1P_NUM) / _horner(xs, _LOG1P_DEN))
    out[lo] = xs + _fma(x2, -0.5, small)
    out[~lo] = _log_f32(x[~lo] + 1.0)
    return out


# XLA's ErfInv f32 expansion (Giles), w < 5 and w >= 5
_ERFINV_LT = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
              -4.39150654e-06, 0.00021858087, -0.00125372503,
              -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GT = (-0.000200214257, 0.000100950558, 0.00134934322,
              -0.00367342844, 0.00573950773, -0.0076224613, 0.00943887047,
              1.00167406, 2.83297682)


def _erf_inv_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's ErfInv on f32 x in [-1, 1]: w = -log1p(-x^2), a degree-8
    polynomial in w - 2.5 (w < 5) or sqrt(w) - 3, times x; +-1 -> +-inf."""
    w = -_log1p_f32(x * -x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, _sqrt_f32(w) - 3.0)
    p = torch.where(lt, _f32(_ERFINV_LT[0]), _f32(_ERFINV_GT[0]))
    for a, b in zip(_ERFINV_LT[1:], _ERFINV_GT[1:]):
        p = _fma(p, w, torch.where(lt, _f32(a), _f32(b)))
    return torch.where(x.abs() == 1.0, x * torch.inf, p * x)


def normal(key: torch.Tensor, shape) -> torch.Tensor:
    """jax.random.normal(key, shape) in f32 on the CPU: a uniform on
    [nextafter(-1, 0), 1) from the key's bits, then sqrt(2) erf_inv(u).
    Bitwise the reference's jitted CPU draw (tests/test_torch_draws.py)."""
    shape = _shape(shape)
    u = bits_to_uniform(_bits(key.cpu(), _numel(shape)))
    return _normal_from_uniform(u).reshape(shape)


def _normal_from_uniform(u: torch.Tensor) -> torch.Tensor:
    """normal's transform of uniforms on [0, 1): onto [nextafter(-1, 0),
    1), then sqrt(2) erf_inv."""
    lo = _f32(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = torch.clamp_min(u * 2.0 + lo, lo)          # u * 2 is exact: one fma
    return _erf_inv_f32(u) * _f32(np.sqrt(2.0))


def randint(key: torch.Tensor, shape, minval: int, maxval: int
            ) -> torch.Tensor:
    """jax.random.randint(key, shape, minval, maxval) (int32) -> int64
    values: two 32-bit draws from split(key), hi % span times
    (2^32 mod span) plus lo % span, mod span, in wrapping uint32
    arithmetic. Bitwise the reference's."""
    shape = _shape(shape)
    n = _numel(shape)
    k1, k2 = split(key.cpu(), 2)
    hi, lo = _bits(k1, n), _bits(k2, n)
    span = (maxval - minval) & MASK32 if maxval > minval else 1
    mult = (1 << 16) % span
    mult = ((mult * mult) & MASK32) % span
    off = (((hi % span) * mult) & MASK32) + (lo % span)
    off = (off & MASK32) % span
    return (minval + off).reshape(shape)


# ---- gumbel, categorical and dirichlet (the non-IID samplers' draws) --------

_TINY_F32 = float(np.finfo(np.float32).tiny)


def gumbel(key: torch.Tensor, shape) -> torch.Tensor:
    """jax.random.gumbel(key, shape) in f32 (jax's default mode="low"):
    u uniform on [f32 tiny, 1) (the uniform's zero lifted to tiny, every
    other value unchanged, as XLA rounds u + tiny), then -log(-log(u))
    with XLA's CPU log. Bitwise the reference's jitted draw
    (tests/test_torch_scenarios.py)."""
    shape = _shape(shape)
    u = bits_to_uniform(_bits(key.cpu(), _numel(shape)))
    u = torch.where(u == 0.0, _TINY_F32, u)
    return (-_log_f32(-_log_f32(u))).reshape(shape)


def categorical(key: torch.Tensor, logits: torch.Tensor, shape=None
                ) -> torch.Tensor:
    """jax.random.categorical(key, logits, axis=-1, shape=shape) -> int64:
    argmax over the last axis of gumbel(key, prefix + logits.shape) +
    logits (the first maximum on ties, as jnp.argmax). `shape` defaults to
    logits.shape[:-1]; its leading dims beyond those are the sample
    prefix. Computed on the CPU."""
    logits = logits.cpu().to(torch.float32)
    batch = tuple(logits.shape[:-1])
    shape = batch if shape is None else _shape(shape)
    prefix = shape[:len(shape) - len(batch)]
    g = gumbel(key, prefix + tuple(logits.shape))
    return torch.argmax(g + logits, dim=-1)


_EXP_P = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
          4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1)


def _exp_f32(x: torch.Tensor) -> torch.Tensor:
    """exp of f32 x as XLA's CPU backend computes it: Cephes' expf, x
    clamped to [-87.8, 88.8], n = floor(x log2(e) + 1/2) clamped to
    [-127, 127], the two-part reduction r = x - n ln 2, the degree-5
    polynomial, every multiply-add one fma, times 2^n built from its
    exponent bits (0 at n = -127)."""
    x = x.clamp(_f32(-87.8), _f32(88.8))
    n = torch.floor(_fma(x, _f32(1.44269504088896341), 0.5)).clamp(-127.0,
                                                                   127.0)
    r = _fma(n, -_f32(0.693359375), x)
    r = _fma(n, -_f32(-2.12194440e-4), r)
    z = _fma(r, _f32(_EXP_P[0]), _f32(_EXP_P[1]))
    for p in _EXP_P[2:]:
        z = _fma(z, r, _f32(p))
    z = _fma(z, r * r, r) + 1.0
    return z * ((n.to(torch.int32) + 127) << 23).view(torch.float32)


def _split_rows(keys: torch.Tensor, num: int) -> torch.Tensor:
    """split(k, num) for every key of (m, 2) -> (m, num, 2)."""
    c = torch.arange(2 * num, dtype=torch.int64)
    o0, o1 = threefry2x32(keys[:, :1], keys[:, 1:], c[None, :num],
                          c[None, num:])
    return torch.cat([o0, o1], dim=1).reshape(-1, num, 2)


def _scalar_uniform(keys: torch.Tensor) -> torch.Tensor:
    """uniform(k, ()) for every key of (m, 2) -> (m,) f32."""
    z = torch.zeros(keys.shape[0], dtype=torch.int64)
    return bits_to_uniform(threefry2x32(keys[:, 0], keys[:, 1], z, z)[0])


def _scalar_normal(keys: torch.Tensor) -> torch.Tensor:
    """normal(k, ()) for every key of (m, 2) -> (m,) f32."""
    return _normal_from_uniform(_scalar_uniform(keys))


def _loggamma_boosted(keys: torch.Tensor, alpha: torch.Tensor
                      ) -> torch.Tensor:
    """jax's _gamma_one(log_space=True) for every (key, alpha) pair at
    once: Marsaglia-Tsang on the boosted shape (alpha + 1 below 1) with
    its nested rejection loops of split / normal / uniform draws run in
    lock step (an entry whose loop has ended keeps its state, as the
    vmapped while loop selects), then the log boost log1p(-u) / alpha,
    each multiply-add fused as XLA's CPU code fuses it."""
    one, third = _f32(1.0), _f32(1.0 / 3.0)
    boost = alpha >= 1.0
    a = torch.where(boost, alpha, alpha + 1.0)
    d = a - third
    # XLA rewrites third / sqrt(d) into third * rsqrt(d); its CPU rsqrt is
    # an approximation that is the correctly rounded 1 / sqrt on most
    # inputs, which the port takes (ROADMAP Queue 3 item 20)
    c = third * (1.0 / torch.sqrt(d.to(torch.float64))).to(torch.float32)
    ks = _split_rows(keys, 2)
    key, sub = ks[:, 0], ks[:, 1]
    X = torch.zeros_like(alpha)
    V = torch.ones_like(alpha)
    U = torch.full_like(alpha, 2.0)

    def cond(X, V, U):
        return ((U >= _fma(X * X, -_f32(0.0331), one))
                & (_log_f32(U) >= _fma(d, (one - V) + _log_f32(V), X * 0.5)))

    live = cond(X, V, U)
    while bool(live.any()):
        idx = torch.nonzero(live).flatten()
        k3 = _split_rows(key[idx], 3)
        key[idx] = k3[:, 0]
        xk, ci = k3[:, 1], c[idx]
        x = torch.zeros_like(ci)
        v = torch.full_like(ci, -1.0)
        todo = v <= 0.0
        while bool(todo.any()):
            j = torch.nonzero(todo).flatten()
            ks2 = _split_rows(xk[j], 2)
            xk[j] = ks2[:, 0]
            x[j] = _scalar_normal(ks2[:, 1])
            v[j] = _fma(x[j], ci[j], one)
            todo = v <= 0.0
        X[idx] = x * x
        V[idx] = (v * v) * v
        U[idx] = _scalar_uniform(k3[:, 2])
        live = live & cond(X, V, U)
    logs = _log1p_f32(-_scalar_uniform(sub))
    lb = torch.where(boost | (logs == 0.0), 0.0, logs * (one / alpha))
    return (_log_f32(d) + _log_f32(V)) + lb


def dirichlet(key: torch.Tensor, alpha: float, shape, categories: int
              ) -> torch.Tensor:
    """jax.random.dirichlet(key, full((categories,), alpha), shape=shape)
    in f32 on the CPU: one loggamma draw per entry from split(key, count)
    (row-major), then a softmax over the last axis. The draws and the
    rejection loops are jax's; the softmax's exp and sum round within an
    ulp of XLA's (ROADMAP Queue 3 item 20 states the bound)."""
    shape = _shape(shape) + (categories,)
    n = _numel(shape)
    keys = split(key.cpu(), n)
    alphas = torch.full((n,), _f32(alpha), dtype=torch.float32)
    lg = _loggamma_boosted(keys, alphas).reshape(shape)
    e = _exp_f32(lg - lg.amax(dim=-1, keepdim=True))
    tot = e[..., 0].clone()
    for j in range(1, categories):
        tot = tot + e[..., j]
    return e / tot[..., None]
