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
"""
from __future__ import annotations

import torch

from repro_torch.kernels.prng import MASK32, bits_to_uniform, threefry2x32


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

