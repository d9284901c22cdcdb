"""Gradient compression operators (the paper's Q_W / Q_M instances): the
whole registry of the JAX package's core/compressors.py — Identity,
Random-k, Top-k, Threshold-v, Adaptive Threshold, TernGrad, QSGD, signSGD
and natural compression.

`sim(x2d, keys)` is the mathematical operator on a BATCH of units: row i
of the (n, d) matrix is one compression unit and keys[i] its PRNG key
((n, 2) key data, random.py). It is the reference's per-unit `sim`
vmapped over a bucket, written out as a batch dimension; the per-unit
statistics (max, l2 norm, threshold) are taken over each row. Draws are
bit-exact jax.random.uniform / bernoulli streams (kernels/prng.py).

`encode(x2d, keys)` gives the unpacked payload records of every row and
`decode(records, d)` the (n, d) units back: the reference's per-unit
encode / decode vmapped over a bucket, with its record names and dtypes
(each record gains a leading row axis). These are what the non-wire
allgather and rs_compress_ag strategies gather (core/aggregation.py):

  identity   {"dense": f32 (n, d)}
  randomk /  {"idx": int32 (n, k), "val": f32 (n, k)}
  topk / thresholds
  terngrad   {"tern": int8 (n, d), "scale": f32 (n, 1)}
  qsgd       {"lev": int8 (n, d), "norm": f32 (n, 1)}
  signsgd    {"bits": uint8 (n, ceil(d/8))}, bit i in byte i//8 at i%8
  natural    {"code": int16 (n, d)}

Selection order is part of the wire (records travel in selection order):
lax.top_k puts equal values in index order, so every top-k here is a
stable descending sort, never torch.topk.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.prng import uniform_at, uniform_rows

_EPS = 1e-12


def _k_of(ratio: float, d: int) -> int:
    """Static kept-element count for a sparsification ratio (paper's k%)."""
    return max(1, min(d, int(round(ratio * d))))


def index_bits(d: int) -> int:
    """Wire width of one sparse-record index: ceil(log2(d)) bits, min 1."""
    return max(1, (d - 1).bit_length()) if d > 1 else 1


#: elements a top-k sort takes at a time (at least one row): the sort's
#: f32 values and int64 indices of 2**27 entries take 1.5 GB, so a
#: 614,596,608-entry bucket row (a full-width LM embedding) sorts alone
#: instead of beside every other row of its bucket
SORT_ELEMS = 1 << 27
#: positions of a row QSGD quantizes at a time: its uniforms depend only on
#: the position and the row's length, and the threefry's int64
#: temporaries of a full-width LM embedding row at once take gigabytes
QSGD_SPAN = 1 << 23


def _row_chunks(x2d: torch.Tensor):
    """The rows of x2d in chunks of at most SORT_ELEMS elements (at least
    one row each)."""
    return x2d.split(max(1, SORT_ELEMS // max(1, x2d.shape[1])))


def _top_idx(v: torch.Tensor, k: int) -> torch.Tensor:
    """Per row, the indices of the k largest values, ties in index order
    (lax.top_k's order) -> (n, k) int64. A stable sort of each chunk of
    rows (_row_chunks), whose first k columns are copied out before the
    next chunk sorts."""
    return torch.cat([torch.sort(c, dim=1, descending=True,
                                 stable=True)[1][:, :k].clone()
                      for c in _row_chunks(v)])


def _keep(x2d: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """zeros with x2d's values at the (unique) per-row indices."""
    return torch.zeros_like(x2d).scatter_(1, idx, x2d.gather(1, idx))


def _records(idx: torch.Tensor, vals: torch.Tensor) -> dict:
    """The sparse operators' wire records (int32 indices, as the
    reference's encode gives them)."""
    return {"idx": idx.to(torch.int32), "val": vals}


def _scatter_records(payload: dict, d: int, dtype) -> torch.Tensor:
    """Sparse records -> (n, d) zeros with the values at their (unique)
    indices."""
    val = payload["val"].to(dtype)
    out = torch.zeros((val.shape[0], d), dtype=dtype, device=val.device)
    return out.scatter_(1, payload["idx"].to(torch.int64), val)


def pack_signs(bits: torch.Tensor) -> torch.Tensor:
    """(n, d) {0,1} ints -> (n, ceil(d/8)) uint8, bit i in byte i//8 at
    position i%8 (the reference's compressors.pack_signs per row)."""
    n, d = bits.shape
    b = F.pad(bits.to(torch.int64), (0, (-d) % 8)).reshape(n, -1, 8)
    weights = 1 << torch.arange(8, dtype=torch.int64, device=bits.device)
    return (b * weights).sum(dim=-1).to(torch.uint8)


def unpack_signs(packed: torch.Tensor, d: int) -> torch.Tensor:
    """Inverse of pack_signs -> (n, d) int32 {0, 1}."""
    sh = torch.arange(8, dtype=torch.int64, device=packed.device)
    bits = (packed.to(torch.int64)[..., None] >> sh) & 1
    return bits.reshape(packed.shape[0], -1)[:, :d].to(torch.int32)


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    """A Python scalar as an f32 tensor: the reference's weakly typed
    scalar rounds to f32 before it meets an f32 array."""
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def pow2(e: torch.Tensor) -> torch.Tensor:
    """Exact 2**e in f32 for integer e in [-126, 127], built from the
    exponent bits (torch.exp2 / pow on the card are approximations)."""
    return ((e.to(torch.int32) + 127) << 23).view(torch.float32)


@dataclasses.dataclass(frozen=True)
class Compressor:
    """Base compression operator (frozen: hashable, usable as a cache key)."""

    name: str = "identity"
    unbiased: bool = True

    def sim(self, x2d: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
        return x2d

    def encode(self, x2d: torch.Tensor, keys: torch.Tensor) -> dict:
        """(n, d) units + (n, 2) keys -> the rows' payload records."""
        return {"dense": x2d}

    def decode(self, payload: dict, d: int,
               dtype=torch.float32) -> torch.Tensor:
        """Payload records of n rows -> (n, d) decoded units."""
        return payload["dense"].to(dtype)

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
class RandomK(Compressor):
    """Random-k sparsification. `scale=False` is the paper's biased Random k
    (keep the sampled values); `scale=True` multiplies by d/k making it
    unbiased with Ω = d/k - 1. The k indices are those of the k largest of
    d uniform scores drawn from the unit key."""

    name: str = "randomk"
    ratio: float = 0.01
    scale: bool = False
    unbiased: bool = False

    def __post_init__(self):
        object.__setattr__(self, "unbiased", self.scale)

    def _indices(self, d: int, keys) -> torch.Tensor:
        return _top_idx(uniform_rows(keys, d), _k_of(self.ratio, d))

    def sim(self, x2d, keys):
        d = x2d.shape[1]
        out = _keep(x2d, self._indices(d, keys.to(x2d.device)))
        if self.scale:
            out = out * _f32(d / _k_of(self.ratio, d), out)
        return out

    def encode(self, x2d, keys):
        d = x2d.shape[1]
        idx = self._indices(d, keys.to(x2d.device))
        vals = x2d.gather(1, idx)
        if self.scale:
            vals = vals * _f32(d / _k_of(self.ratio, d), vals)
        return _records(idx, vals)

    def decode(self, payload, d, dtype=torch.float32):
        return _scatter_records(payload, d, dtype)

    def payload_bits(self, d: int) -> int:
        return _k_of(self.ratio, d) * (32 + index_bits(d))

    def omega(self, d: int) -> Optional[float]:
        k = _k_of(self.ratio, d)
        return (d / k - 1.0) if self.scale else 0.0


@dataclasses.dataclass(frozen=True)
class TopK(Compressor):
    """Top-k by magnitude (biased; Ω = 0 since ‖Q(x)‖ ≤ ‖x‖)."""

    name: str = "topk"
    ratio: float = 0.01
    unbiased: bool = False

    def _indices(self, x2d) -> torch.Tensor:
        k = _k_of(self.ratio, x2d.shape[1])
        return torch.cat([_top_idx(c.abs(), k) for c in _row_chunks(x2d)])

    def encode(self, x2d, keys):
        idx = self._indices(x2d)
        return _records(idx, x2d.gather(1, idx))

    def decode(self, payload, d, dtype=torch.float32):
        return _scatter_records(payload, d, dtype)

    def sim(self, x2d, keys):
        return _keep(x2d, self._indices(x2d))

    def payload_bits(self, d: int) -> int:
        return _k_of(self.ratio, d) * (32 + index_bits(d))

    def omega(self, d: int) -> Optional[float]:
        return 0.0


@dataclasses.dataclass(frozen=True)
class _Threshold(Compressor):
    """Keep |x_i| >= a per-unit threshold. The kept count depends on the
    data: sim is exact masking; the wire records keep the `cap_ratio`
    largest qualifying magnitudes (a capacity bound), so they are not
    sim-exact."""

    cap_ratio: float = 0.25

    def _thr(self, x2d) -> torch.Tensor:
        """(n, 1) f32 per-unit thresholds."""
        raise NotImplementedError

    def sim(self, x2d, keys):
        return torch.where(x2d.abs() >= self._thr(x2d), x2d, 0.0)

    def encode(self, x2d, keys):
        a = x2d.abs()
        mag = torch.where(a >= self._thr(x2d), a, -1.0)
        idx = _top_idx(mag, _k_of(self.cap_ratio, x2d.shape[1]))
        vals = torch.where(mag.gather(1, idx) >= 0.0, x2d.gather(1, idx), 0.0)
        return _records(idx, vals)

    def decode(self, payload, d, dtype=torch.float32):
        return _scatter_records(payload, d, dtype)

    def payload_bits(self, d: int) -> int:
        return _k_of(self.cap_ratio, d) * (32 + index_bits(d))

    def omega(self, d: int) -> Optional[float]:
        return 0.0


@dataclasses.dataclass(frozen=True)
class ThresholdV(_Threshold):
    """Keep elements with |x_i| >= v (paper's Threshold v)."""

    name: str = "threshold_v"
    v: float = 1e-3
    unbiased: bool = False

    def _thr(self, x2d):
        return _f32(self.v, x2d)


@dataclasses.dataclass(frozen=True)
class AdaptiveThreshold(_Threshold):
    """AdaComp-style adaptive threshold (Chen et al. 2018, as used in the
    paper): the threshold is `alpha` times the unit's max magnitude, so it
    adapts per compression unit (per-layer max vs global max)."""

    name: str = "adaptive_threshold"
    alpha: float = 0.01
    unbiased: bool = False

    def _thr(self, x2d):
        return _f32(self.alpha, x2d) * x2d.abs().amax(dim=1, keepdim=True)


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

    def encode(self, x2d, keys):
        t, s = self._quantize(x2d.to(torch.float32), keys)
        return {"tern": t, "scale": s[:, None]}

    def decode(self, payload, d, dtype=torch.float32):
        return (payload["tern"].to(torch.float32)
                * payload["scale"]).to(dtype)

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
        """-> (q (n, d) int8 signed levels, nrm (n,) f32 incl. +1e-12),
        QSGD_SPAN positions at a time."""
        nrm = torch.linalg.vector_norm(x2d, dim=1) + _EPS
        n, d = x2d.shape
        k = keys.to(x2d.device)
        q = torch.empty((n, d), dtype=torch.int8, device=x2d.device)
        for a in range(0, d, QSGD_SPAN):
            x = x2d[:, a:a + QSGD_SPAN]
            y = x.abs() / nrm[:, None] * self.levels
            lo = torch.floor(y)
            pos = torch.arange(a, a + x.shape[1], device=x2d.device)
            u = uniform_at(k[:, :1], k[:, 1:], pos[None, :], d)
            lev = lo + (u < (y - lo)).to(y.dtype)
            q[:, a:a + x.shape[1]] = (torch.sign(x) * lev).to(torch.int8)
        return q, nrm

    def sim(self, x2d, keys):
        q, nrm = self._quantize(x2d.to(torch.float32), keys)
        return q.to(torch.float32) * (nrm / self.levels)[:, None]

    def encode(self, x2d, keys):
        q, nrm = self._quantize(x2d.to(torch.float32), keys)
        return {"lev": q, "norm": nrm[:, None]}

    def decode(self, payload, d, dtype=torch.float32):
        return (payload["lev"].to(torch.float32)
                * (payload["norm"] / self.levels)).to(dtype)

    def payload_bits(self, d: int) -> int:
        return self.entry_bits * d + 32

    def omega(self, d: int) -> Optional[float]:
        s = self.levels
        return min(d / s**2, math.sqrt(d) / s)


@dataclasses.dataclass(frozen=True)
class SignSGD(Compressor):
    """signSGD (Bernstein et al. 2018): Q(x) = sign(x) with sign(0) = +1
    (deterministic, biased). Wire format: 1 bit per element."""

    name: str = "signsgd"
    unbiased: bool = False

    def sim(self, x2d, keys):
        return torch.where(x2d >= 0, 1.0, -1.0).to(x2d.dtype)

    def encode(self, x2d, keys):
        return {"bits": pack_signs(x2d >= 0)}

    def decode(self, payload, d, dtype=torch.float32):
        return (2.0 * unpack_signs(payload["bits"], d) - 1.0).to(dtype)

    def payload_bits(self, d: int) -> int:
        return d

    def omega(self, d: int) -> Optional[float]:
        return None


@dataclasses.dataclass(frozen=True)
class NaturalCompression(Compressor):
    """C_NAT (Horváth et al. 2019): stochastic rounding to powers of two.
    Unbiased with Ω = 1/8. Wire: sign + 8-bit exponent = 9 bits.

    Exponents and powers of two are exact: floor(log2 |x|) from frexp and
    2**e from the exponent bits. The reference takes jnp.log2 / jnp.exp2,
    which are inexact on the CPU, so its codes and values differ from
    these by a stated tolerance (ROADMAP.md Queue 3). Subnormal |x|, which
    the reference flushes to zero, is outside that contract."""

    name: str = "natural"
    unbiased: bool = True
    _BIAS: int = 127

    def _exponents(self, x2d, keys):
        """-> (e (n, d) int32 in [-126, 127], sgn (n, d) f32, zero mask)."""
        mag = x2d.abs()
        nz = mag > 0
        safe = torch.where(nz, mag, 1.0)
        e = torch.frexp(safe).exponent - 1               # floor(log2 safe)
        low = pow2(e.clamp(-126, 127))
        p_up = (safe - low) / low      # in [0, 1): prob of rounding up
        up = uniform_rows(keys.to(x2d.device), x2d.shape[1]) < p_up
        e = (e + up.to(e.dtype)).clamp(-126, 127)
        e = torch.where(nz, e, -126)
        return e.to(torch.int32), torch.sign(x2d), mag == 0

    def sim(self, x2d, keys):
        xf = x2d.to(torch.float32)
        e, sgn, zero = self._exponents(xf, keys)
        return torch.where(zero, 0.0, sgn * pow2(e))

    def encode(self, x2d, keys):
        e, sgn, zero = self._exponents(x2d.to(torch.float32), keys)
        code = sgn.to(torch.int32) * (e + self._BIAS + 1)
        return {"code": torch.where(zero, 0, code).to(torch.int16)}

    def decode(self, payload, d, dtype=torch.float32):
        code = payload["code"].to(torch.int32)
        val = torch.sign(code).to(torch.float32) * pow2(
            code.abs() - (self._BIAS + 1))
        return torch.where(code == 0, 0.0, val).to(dtype)

    def payload_bits(self, d: int) -> int:
        return 9 * d

    def omega(self, d: int) -> Optional[float]:
        return 0.125


_REGISTRY = {
    "identity": Identity,
    "randomk": RandomK,
    "topk": TopK,
    "threshold_v": ThresholdV,
    "adaptive_threshold": AdaptiveThreshold,
    "terngrad": TernGrad,
    "qsgd": QSGD,
    "signsgd": SignSGD,
    "natural": NaturalCompression,
}


def make_compressor(name: str, **kwargs: Any) -> Compressor:
    """Build a compressor by name. kwargs are dataclass fields
    (ratio=, levels=, v=, alpha=, scale=, cap_ratio=)."""
    if name not in _REGISTRY:
        raise ValueError(f"unknown compressor {name!r}; have "
                         f"{sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)


def available_compressors():
    return sorted(_REGISTRY)
