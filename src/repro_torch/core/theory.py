"""Executable versions of the paper's theory (the JAX package's
core/theory.py): Assumption 5's Ω measured by Monte Carlo, Lemma 1, and
the layer-wise noise factor Trace(A) against the entire-model bound
d · max_j (1+Ω_M^j)(1+Ω_W^j) — the paper's claim that layer-wise
compression has the tighter bound.

Keys are the port's key data (random.py) and split / fold as jax.random
does. The reference's vmap over trials is a batch of rows here: the
compressors' `sim` takes (trials, d) with one key per row. Results are
Python floats.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch import random
from repro_torch.core.compressors import Compressor


def _trials(comp: Compressor, x: torch.Tensor, keys: torch.Tensor):
    """Q(x) once per key: (trials, d)."""
    return comp.sim(x[None].expand(keys.shape[0], -1).contiguous(), keys)


def empirical_omega(comp: Compressor, x: torch.Tensor, key: torch.Tensor,
                    trials: int = 64) -> float:
    """Estimate Ω s.t. E‖Q(x)‖² = (1+Ω)‖x‖² by Monte Carlo over Q's
    randomness (Assumption 5)."""
    xf = x.reshape(-1).to(torch.float32)
    denom = float(torch.sum(xf * xf)) + 1e-30
    q = _trials(comp, xf, random.split(key, trials))
    return float(torch.mean(torch.sum(q * q, dim=1))) / denom - 1.0


def empirical_descent_alignment(comp: Compressor, g: torch.Tensor,
                                key: torch.Tensor, trials: int = 64) -> float:
    """Estimate E[Q(g)ᵀ g] (Assumption 6's left side with ∇f ≈ g)."""
    gf = g.reshape(-1).to(torch.float32)
    q = _trials(comp, gf, random.split(key, trials))
    return float(torch.mean(q @ gf))


def check_unbiasedness(comp: Compressor, x: torch.Tensor, key: torch.Tensor,
                       trials: int = 512) -> float:
    """Relative error ‖E[Q(x)] − x‖ / ‖x‖ (→ 0 for unbiased operators)."""
    xf = x.reshape(-1).to(torch.float32)
    mean = torch.mean(_trials(comp, xf, random.split(key, trials)), dim=0)
    return float(torch.linalg.vector_norm(mean - xf)
                 / (torch.linalg.vector_norm(xf) + 1e-30))


def trace_A(omegas_w: Sequence[float], omegas_m: Sequence[float],
            dims: Sequence[int]) -> float:
    """Layer-wise noise factor Trace(A) = Σ_j d_j (1+Ω_M^j)(1+Ω_W^j): the
    trace of the d×d diagonal matrix A (the paper writes it per layer
    block, Σ_j (1+Ω_M^j)(1+Ω_W^j))."""
    return float(sum(d * (1 + ow) * (1 + om)
                     for d, ow, om in zip(dims, omegas_w, omegas_m)))


def entire_model_bound(omegas_w: Sequence[float], omegas_m: Sequence[float],
                       dims: Sequence[int]) -> float:
    """Entire-model noise factor: d · max_j (1+Ω_M^j)(1+Ω_W^j)."""
    worst = max((1 + ow) * (1 + om) for ow, om in zip(omegas_w, omegas_m))
    return float(sum(dims) * worst)


def layerwise_tighter(omegas_w, omegas_m, dims) -> bool:
    """The paper's headline theoretical claim (§4, last paragraph)."""
    return trace_A(omegas_w, omegas_m, dims) <= entire_model_bound(
        omegas_w, omegas_m, dims) + 1e-9


def noise_bounds_from_plan(plan, comp_w: Optional[Compressor] = None,
                           comp_m: Optional[Compressor] = None, *,
                           measured_w: Optional[Sequence[float]] = None,
                           measured_m: Optional[Sequence[float]] = None
                           ) -> Tuple[float, float]:
    """(Trace(A), entire-model bound) over a UnitPlan's unit partition: the
    plan's accounting dims are the d_j of the paper's §4. Per-unit Ω come
    from the operators' closed forms, or from `measured_w` / `measured_m`
    (per-unit estimates in plan unit order). Raises when an operator has
    no closed-form Ω and nothing was measured, or when no worker source is
    given (a zero-noise worker bound is never what is wanted)."""
    dims = list(plan.unit_dims)

    def resolve(measured, comp, tag):
        if measured is not None:
            om = [float(o) for o in measured]
            if len(om) != len(dims):
                raise ValueError(
                    f"measured_{tag} has {len(om)} omegas, plan has "
                    f"{len(dims)} units")
            return om
        if comp is None:
            if tag == "w":
                raise ValueError(
                    "provide comp_w or measured_w (a zero-noise worker "
                    "bound is never what you want)")
            return [0.0] * len(dims)
        om = [comp.omega(d) for d in dims]
        if any(o is None for o in om):
            raise ValueError(
                "operator has no closed-form Omega; measure empirical_omega "
                "per unit instead")
        return om

    ow = resolve(measured_w, comp_w, "w")
    om = resolve(measured_m, comp_m, "m")
    return trace_A(ow, om, dims), entire_model_bound(ow, om, dims)


def lemma1_check(comp: Compressor, parts: List[torch.Tensor],
                 key: torch.Tensor, trials: int = 64
                 ) -> Tuple[float, float, float]:
    """Lemma 1 numerically, for the layer-wise operator that applies `comp`
    to each part: (E‖Q(x)‖², Σ_j (1+Ω_j)‖x_j‖², max_j (1+Ω_j) · ‖x‖²). The
    lemma asserts lhs <= mid <= rhs (the first within Monte-Carlo error)."""
    omegas = [empirical_omega(comp, p, random.fold_in(key, j), trials)
              for j, p in enumerate(parts)]
    keys = random.split(key, trials)
    acc = 0.0
    for j, p in enumerate(parts):       # independent randomness per part
        q = _trials(comp, p.reshape(-1), random.fold_in(keys, j))
        acc = acc + torch.sum(q * q, dim=1)
    lhs = float(torch.mean(acc))
    sq = [float(torch.sum(p.to(torch.float32) ** 2)) for p in parts]
    mid = float(sum((1 + o) * s for o, s in zip(omegas, sq)))
    rhs = max(1 + o for o in omegas) * float(sum(sq))
    return lhs, mid, rhs
