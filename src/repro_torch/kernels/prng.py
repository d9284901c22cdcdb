"""Elementwise threefry2x32 in plain torch — jax.random.uniform, bit for bit.

The plain twin of the device function in csrc/threefry.cuh (and of the
JAX package's kernels/prng.py). torch on the CPU has no uint32 add, shift
or compare, so every uint32 value is carried in an int64 tensor holding
0 <= v < 2**32 and every add is masked back to 32 bits.

Counter layout (jax's non-partitionable threefry path): a length-n draw
evaluates threefry2x32(key, [0..n-1] zero-padded to even length, split
into half-arrays x1/x2), so position p < h := ceil(n/2) is output word 0
of the pair (p, p+h) — with the odd-n pad folding the last x2 slot to 0
— and position p >= h is output word 1 of the pair (p-h, p).
"""
from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_ONE_F32 = 0x3F800000


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k0, k1, x0, x1):
    """20-round threefry2x32 on broadcastable int64 tensors holding uint32
    values — the arithmetic of jax's threefry2x32 primitive."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x0, x1


def random_bits_at(k0, k1, pos, n: int) -> torch.Tensor:
    """Bits of jax.random.bits(key, (n,))[pos] for keys (k0, k1); `pos`
    any integer tensor broadcastable against the keys (values >= n are
    computed but meaningless — mask them downstream)."""
    p = pos.to(torch.int64)
    h = (n + 1) // 2
    first = p < h
    j = torch.where(first, p, p - h)
    x2 = torch.where(h + j < n, h + j, torch.zeros_like(j))
    o1, o2 = threefry2x32(k0, k1, j, x2)
    return torch.where(first, o1, o2)


def uniform_pairs(k0, k1, j, n: int):
    """Both uniforms of counter pairs j < ceil(n/2) from one hash each
    (csrc/threefry.cuh uniform_pair_at): (uniform at position j, uniform at
    position j + h), the second meaningless where j + h >= n."""
    j = j.to(torch.int64)
    h = (n + 1) // 2
    o1, o2 = threefry2x32(k0, k1, j,
                          torch.where(h + j < n, h + j, torch.zeros_like(j)))
    return bits_to_uniform(o1), bits_to_uniform(o2)


def bits_to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """uint32 bits -> f32 uniforms in [0, 1): jax.random.uniform's mantissa
    construction, (bits >> 9 | 0x3F800000) as float, minus 1."""
    fb = ((bits >> 9) | _ONE_F32).to(torch.int32)
    return torch.clamp_min(fb.view(torch.float32) - 1.0, 0.0)


def uniform_at(k0, k1, pos, n: int) -> torch.Tensor:
    """jax.random.uniform(key, (n,))[pos], bit for bit, elementwise."""
    return bits_to_uniform(random_bits_at(k0, k1, pos, n))


def uniform_rows(keys: torch.Tensor, d: int) -> torch.Tensor:
    """(n, 2) keys -> (n, d) f32: row i is jax.random.uniform(keys[i], (d,))."""
    pos = torch.arange(d, device=keys.device)
    return uniform_at(keys[:, :1], keys[:, 1:], pos[None, :], d)
