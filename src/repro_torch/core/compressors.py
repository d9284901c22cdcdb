"""Gradient compression operators (the paper's Q_W / Q_M instances) — the
ported subset: Identity, TernGrad and QSGD (the JAX package's
core/compressors.py:76-108, 272-354).

`sim(x2d, keys)` is the mathematical operator on a BATCH of units: row i
of the (n, d) matrix is one compression unit and keys[i] its PRNG key
((n, 2) key data, random.py). It is the reference's per-unit `sim`
vmapped over a bucket, written out as a batch dimension; the per-unit
statistics (max, l2 norm) are taken over each row. Draws are bit-exact
jax.random.uniform / bernoulli streams (kernels/prng.py).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch

from repro_torch.kernels.prng import uniform_rows

_EPS = 1e-12


@dataclasses.dataclass(frozen=True)
class Compressor:
    """Base compression operator (frozen: hashable, usable as a cache key)."""

    name: str = "identity"
    unbiased: bool = True

    def sim(self, x2d: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
        return x2d

    def payload_bits(self, d: int) -> int:
        """Wire bits for one encoded unit of dimension d."""
        return 32 * d

    def omega(self, d: int) -> Optional[float]:
        """Theoretical Ω in Assumption 5, if known in closed form."""
        return 0.0


@dataclasses.dataclass(frozen=True)
class Identity(Compressor):
    name: str = "identity"
    unbiased: bool = True


@dataclasses.dataclass(frozen=True)
class TernGrad(Compressor):
    """TernGrad (Wen et al. 2017): x -> s·sign(x)·b, b ~ Bernoulli(|x|/s),
    s = max|x| over the compression unit. Unbiased."""

    name: str = "terngrad"
    unbiased: bool = True

    def _quantize(self, x2d, keys):
        """-> (t (n, d) int8 in {-1, 0, 1}, s (n,) f32 incl. +1e-12)."""
        s = x2d.abs().amax(dim=1) + _EPS
        p = x2d.abs() / s[:, None]
        b = (uniform_rows(keys.to(x2d.device), x2d.shape[1]) < p)
        t = torch.sign(x2d).to(torch.int8) * b.to(torch.int8)
        return t, s

    def sim(self, x2d, keys):
        t, s = self._quantize(x2d.to(torch.float32), keys)
        return t.to(torch.float32) * s[:, None]

    def payload_bits(self, d: int) -> int:
        return 2 * d + 32  # 2-bit ternary + one f32 scale

    def omega(self, d: int) -> Optional[float]:
        return None


@dataclasses.dataclass(frozen=True)
class QSGD(Compressor):
    """QSGD (Alistarh et al. 2017) with s quantization levels:
    q_i = ‖x‖₂ · sign(x_i) · ξ_i(x, s) / s where ξ is stochastic rounding of
    s|x_i|/‖x‖₂. Unbiased; Ω = min(d/s², √d/s)."""

    name: str = "qsgd"
    levels: int = 16
    unbiased: bool = True

    @property
    def entry_bits(self) -> int:
        """Wire bits per quantized entry: offset-binary codes in [0, 2s]."""
        return max(2, math.ceil(math.log2(2 * self.levels + 1)))

    def _quantize(self, x2d, keys):
        """-> (q (n, d) int8 signed levels, nrm (n,) f32 incl. +1e-12)."""
        nrm = torch.linalg.vector_norm(x2d, dim=1) + _EPS
        y = x2d.abs() / nrm[:, None] * self.levels
        lo = torch.floor(y)
        u = uniform_rows(keys.to(x2d.device), x2d.shape[1])
        lev = lo + (u < (y - lo)).to(y.dtype)
        return (torch.sign(x2d) * lev).to(torch.int8), nrm

    def sim(self, x2d, keys):
        q, nrm = self._quantize(x2d.to(torch.float32), keys)
        return q.to(torch.float32) * (nrm / self.levels)[:, None]

    def payload_bits(self, d: int) -> int:
        return self.entry_bits * d + 32

    def omega(self, d: int) -> Optional[float]:
        s = self.levels
        return min(d / s**2, math.sqrt(d) / s)


_REGISTRY = {"identity": Identity, "terngrad": TernGrad, "qsgd": QSGD}

#: reference compressors whose port is still queued (ROADMAP Queue 1, item 4)
_NOT_PORTED = ("randomk", "topk", "threshold_v", "adaptive_threshold",
               "signsgd", "natural")


def make_compressor(name: str, **kwargs: Any) -> Compressor:
    """Build a compressor by name. kwargs are dataclass fields (levels=)."""
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"compressor {name!r} is not ported yet (ROADMAP.md Queue 1, "
            f"item 4: core/compressors.py); ported: {sorted(_REGISTRY)}")
    if name not in _REGISTRY:
        raise ValueError(f"unknown compressor {name!r}; have "
                         f"{sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)
