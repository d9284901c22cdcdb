"""The comparison that decides `correct`: what the program's first steps
produced against the plain reference's same steps from the same weights,
rows and keys.

Numbers, each a worst case:
  loss         over the checked steps, |program loss - reference loss| /
               |reference loss|
  grad_norm    over the leaves, | ||g|| - ||g_ref|| | / max(||g_ref||,
               the median leaf's ||g_ref||), g the aggregated gradient the
               first update received
  grad_diff    over the leaves, ||g - g_ref|| / the same denominator: the
               only number that sees the compressor's draws, since a
               quantization with other draws keeps its norm
  change_norm  over the leaves, | ||p_k - p_0|| - ||p_k,ref - p_0|| | /
               max(||p_k,ref - p_0||, the median leaf's), after the k
               checked steps
Leaves whose reference gradient is under NEGLIGIBLE x the median leaf's
(nought to rounding) are left out of the gradient and change numbers.
"""
from __future__ import annotations

import statistics
from typing import Dict, List

import torch

NEGLIGIBLE = 1e-3
NAMES = ("loss", "grad_norm", "grad_diff", "change_norm")


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.float()))


def numbers(losses: List[float], ref_losses: List[float],
            g: Dict[str, torch.Tensor], g_ref: Dict[str, torch.Tensor],
            change: Dict[str, float], ref_change: Dict[str, float]
            ) -> Dict[str, float]:
    """The numbers above. `g` may lie on another device than `g_ref`;
    `change` / `ref_change` are the leaves' ||p_k - p_0||."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    gr = {p: _norm(t) for p, t in g_ref.items()}
    med = statistics.median(gr.values())
    kept = [p for p in gr if gr[p] >= NEGLIGIBLE * med]
    grad_norm = grad_diff = 0.0
    for p in kept:
        den = max(gr[p], med)
        gp = g[p].to(g_ref[p].device, torch.float32)
        grad_norm = max(grad_norm, abs(_norm(gp) - gr[p]) / den)
        grad_diff = max(grad_diff, _norm(gp - g_ref[p]) / den)
    med_c = statistics.median(ref_change[p] for p in kept)
    change_norm = max(abs(change[p] - ref_change[p])
                      / max(ref_change[p], med_c, 1e-30) for p in kept)
    return {"loss": loss, "grad_norm": grad_norm, "grad_diff": grad_diff,
            "change_norm": change_norm}


def verdict(nums: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number within its limit (a number without one fails)."""
    return all(n in limits and limits[n] is not None
               and nums[n] <= limits[n] for n in nums)
