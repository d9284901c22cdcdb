"""Threefry2x32 keys and uniforms, frozen here so that the benchmark's
keys and its plain reference's draws do not move with the program.

A key is two uint32 words held in an int64 tensor of shape (..., 2).
`fold_in(key, data)` is threefry2x32(key, [0, data]). A unit of d
entries draws its uniforms in the non-partitionable layout: with
h = ceil(d / 2), counter pair j < h hashes (j, j + h) (the second word
0 where j + h >= d); position j takes the first output word and position
j + h the second. A word w becomes the float (w >> 9 | 0x3F800000) - 1.
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
    """20 rounds of threefry2x32 on broadcastable int64 tensors that hold
    uint32 values."""
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


def base_key(seed: int) -> torch.Tensor:
    """A run's key from its seed: the seed's high and low 32-bit words."""
    s = int(seed) & ((1 << 64) - 1)
    return torch.tensor([s >> 32, s & MASK32], dtype=torch.int64)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """threefry2x32(key, [0, data]) -> a key (..., 2)."""
    d = torch.as_tensor(data, dtype=torch.int64, device=key.device) & MASK32
    o0, o1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack([o0, o1], dim=-1)


def to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """uint32 words -> f32 uniforms in [0, 1)."""
    fb = ((bits >> 9) | _ONE_F32).to(torch.int32)
    return fb.view(torch.float32) - 1.0


def pair_uniforms(key: torch.Tensor, d: int, j0: int, j1: int, device):
    """The uniforms of counter pairs [j0, j1) of a d-entry unit keyed by
    `key` (2,): (those of positions j, those of positions j + h), f32 on
    `device`; the second is meaningless where j + h >= d."""
    k0, k1 = (torch.tensor(int(v), dtype=torch.int64, device=device)
              for v in key.tolist())
    h = (d + 1) // 2
    j = torch.arange(j0, j1, dtype=torch.int64, device=device)
    x1 = torch.where(j + h < d, j + h, torch.zeros_like(j))
    o0, o1 = threefry2x32(k0, k1, j, x1)
    return to_uniform(o0), to_uniform(o1)


def unit_uniforms(key: torch.Tensor, d: int, device) -> torch.Tensor:
    """All d uniforms of a unit (small units and tests)."""
    h = (d + 1) // 2
    a, b = pair_uniforms(key, d, 0, h, device)
    return torch.cat([a, b])[:d]
