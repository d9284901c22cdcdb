"""Pluggable compression policies: telemetry window in, decision out (the
JAX package's control/policy.py).

Policies run in plain Python at re-plan boundaries (every K steps), never
inside the step. A `CompressionDecision` is a frozen, hashable value
object: the controller keys its (decision -> step) cache on it, so a
policy that oscillates between a small set of decisions never builds a
step twice.

  StaticPolicy             one fixed decision.
  VarianceBudgetPolicy     per-bucket sparsification ratio chosen to keep
                           relative compression error under a budget
                           (Tsuzuku et al.'s variance-based compression,
                           applied per size class).
  GranularitySwitchPolicy  layer-wise vs entire-model by the paper's
                           Trace(A) bound evaluated on MEASURED omegas
                           (theory.noise_bounds_from_plan) against the
                           measured entire-model counterfactual.
  BitBudgetPolicy          greedy per-bucket ratio allocation maximizing
                           captured gradient energy under a total
                           uplink-bits/step budget.
  AdaptiveKPolicy          Shi et al.'s layer-wise adaptive-k: split a
                           flat top-k element budget across buckets
                           proportionally to measured gradient energy.
  FusionPolicy             the comm schedule's fusion threshold from the
                           alpha-beta pipeline model.

Every decision is a pure function of the summary dict, so the same
summary gives the same decision in both packages.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Protocol, Sequence, Tuple, runtime_checkable

import torch

from repro_torch.control.telemetry import unit_omegas
from repro_torch.core import theory
from repro_torch.core.aggregation import CompressionConfig
from repro_torch.core.compressors import Compressor, Identity
from repro_torch.core.granularity import Granularity
from repro_torch.core.plan import UnitPlan
from repro_torch.core.schedule import build_schedule, simulate_schedule

RATIO_LADDER = (0.005, 0.01, 0.02, 0.05, 0.1, 0.2, 0.5, 1.0)

#: fusion_bytes candidates FusionPolicy picks from: per-bucket messages,
#: Horovod-ish small/medium/large fusion buffers, one fused message.
FUSION_LADDER = (0.0, 4096.0, 65536.0, float(1 << 20), math.inf)


@dataclasses.dataclass(frozen=True)
class PerDimRatio(Compressor):
    """Wrap a ratio-bearing compressor with a per-unit-dimension ratio
    table. Every bucket's rows share one dimension (the last axis of the
    (n, d) matrix the operators take), so the lookup is static per
    bucket; payload / omega accounting resolves per dim the same way
    (which is how comm_report tracks per-bucket ratios without knowing
    about decisions), and so does the sparse wire codec
    (core/wire.py SparseCodec)."""

    name: str = "per_dim_ratio"
    base: Compressor = Identity()
    table: Tuple[Tuple[int, float], ...] = ()  # (unit dim, ratio)

    def __post_init__(self):
        object.__setattr__(self, "name", f"{self.base.name}[adaptive]")
        object.__setattr__(self, "unbiased", self.base.unbiased)

    def for_dim(self, d: int) -> Compressor:
        for dim, r in self.table:
            if dim == d:
                return dataclasses.replace(self.base, ratio=r)
        return self.base

    def sim(self, x2d, keys):
        return self.for_dim(x2d.shape[-1]).sim(x2d, keys)

    def encode(self, x2d, keys):
        return self.for_dim(x2d.shape[-1]).encode(x2d, keys)

    def decode(self, payload, d, dtype=torch.float32):
        return self.for_dim(d).decode(payload, d, dtype)

    def payload_bits(self, d: int) -> int:
        return self.for_dim(d).payload_bits(d)

    def omega(self, d: int) -> Optional[float]:
        return self.for_dim(d).omega(d)


@dataclasses.dataclass(frozen=True)
class CompressionDecision:
    """A policy's output: everything needed to materialize a
    CompressionConfig (and therefore a UnitPlan and a step). Frozen +
    tuple fields => hashable, the controller's cache key. `fusion_bytes`
    (None = unscheduled; a float incl. math.inf = stream through the
    CommSchedule fused at that threshold) is an ordinary hashable field,
    so decisions carrying a schedule keep the never-rebuild guarantee:
    revisiting a (.., fusion_bytes) combination hits the step cache."""

    granularity: Granularity = Granularity("layerwise")
    qw: Compressor = Identity()
    qm: Compressor = Identity()
    strategy: str = "simulated"
    error_feedback: bool = False
    wire_dtype: str = "float32"
    ratio_overrides: Tuple[Tuple[int, float], ...] = ()  # unit dim -> ratio
    fusion_bytes: Optional[float] = None  # comm schedule fusion threshold

    def compressor_for_dim(self, d: int) -> Compressor:
        for dim, r in self.ratio_overrides:
            if dim == d and hasattr(self.qw, "ratio"):
                return dataclasses.replace(self.qw, ratio=r)
        return self.qw

    def to_config(self) -> CompressionConfig:
        qw = self.qw
        if (self.ratio_overrides and hasattr(qw, "ratio")
                and self.strategy != "shared_random"):
            # shared_random's collective requires the bare RandomK (its
            # shared-seed index trick reads qw directly); overrides are
            # ignored there — the ratio policies also decline to emit them.
            qw = PerDimRatio(base=qw, table=self.ratio_overrides)
        return CompressionConfig(
            qw=qw, qm=self.qm, granularity=self.granularity,
            strategy=self.strategy, error_feedback=self.error_feedback,
            wire_dtype=self.wire_dtype, fusion_bytes=self.fusion_bytes)

    @classmethod
    def from_config(cls, cfg: CompressionConfig) -> "CompressionDecision":
        qw, overrides = cfg.qw, ()
        if isinstance(qw, PerDimRatio):
            qw, overrides = qw.base, qw.table
        return cls(granularity=cfg.granularity, qw=qw, qm=cfg.qm,
                   strategy=cfg.strategy, error_feedback=cfg.error_feedback,
                   wire_dtype=cfg.wire_dtype, ratio_overrides=overrides,
                   fusion_bytes=cfg.fusion_bytes)

    def payload_bits(self, unit_dims: Sequence[int]) -> int:
        """Uplink payload bits/step under this decision's per-dim ratios."""
        return sum(self.compressor_for_dim(d).payload_bits(d)
                   for d in unit_dims)

    def describe(self) -> str:
        ov = (f" overrides={len(self.ratio_overrides)}"
              if self.ratio_overrides else "")
        fb = ""
        if self.fusion_bytes is not None:
            fb = (" fuse=inf" if math.isinf(self.fusion_bytes)
                  else f" fuse={int(self.fusion_bytes)}B")
        return (f"{self.granularity.kind}/{self.qw.name}"
                f"/{self.strategy}{ov}{fb}")


@runtime_checkable
class Policy(Protocol):
    """decide() runs on the host at a re-plan boundary. `summary` is the
    telemetry window summary (telemetry.summarize), `current` the active
    decision, `mplan` the measurement plan. Must be pure: same inputs,
    same decision."""

    name: str
    needs_telemetry: bool

    def decide(self, summary: Dict, current: CompressionDecision,
               mplan: Optional[UnitPlan] = None) -> CompressionDecision:
        ...


@dataclasses.dataclass(frozen=True)
class StaticPolicy:
    """One fixed decision: never deviates from the active decision."""

    name: str = "static"
    needs_telemetry: bool = False
    needs_entire_model: bool = True  # for telemetry-export-only runs

    def decide(self, summary, current, mplan=None):
        return current


def _base_ratio(decision: CompressionDecision, dim: int) -> float:
    c = decision.compressor_for_dim(dim)
    return float(getattr(c, "ratio", 1.0))


def _pick_ratio(ladder: Sequence[float], threshold: float) -> float:
    """Smallest ladder ratio >= threshold (max ladder entry if none)."""
    for r in sorted(ladder):
        if r >= threshold:
            return r
    return max(ladder)


@dataclasses.dataclass(frozen=True)
class VarianceBudgetPolicy:
    """Per-bucket ratio to keep predicted relative compression error
    within `budget` (à la Tsuzuku et al.: compress only as much as the
    gradient's noise floor allows). The error model is the monotone
    first-order one: rel_err(r) ≈ rel_err_measured · r_current / r, so a
    tighter budget always selects an equal-or-larger ratio — i.e. never
    fewer bits (property-tested)."""

    budget: float = 0.1
    ladder: Tuple[float, ...] = RATIO_LADDER
    name: str = "variance_budget"
    needs_telemetry: bool = True
    needs_entire_model: bool = False

    def decide(self, summary, current, mplan=None):
        if (not summary.get("buckets") or not hasattr(current.qw, "ratio")
                or current.strategy == "shared_random"):
            return current
        overrides = []
        for entry in summary["buckets"]:
            dim = entry["dim"]
            r_cur = _base_ratio(current, dim)
            need = entry["rel_err"] * r_cur / max(self.budget, 1e-12)
            overrides.append((dim, _pick_ratio(self.ladder, need)))
        return dataclasses.replace(current,
                                   ratio_overrides=tuple(sorted(overrides)))


@dataclasses.dataclass(frozen=True)
class GranularitySwitchPolicy:
    """The paper's framework-should-choose conclusion, executed: compare
    the layer-wise noise trace Σ_j d_j(1+Ω̂_j) (Trace(A) on measured
    per-unit omegas, via theory.noise_bounds_from_plan) against the
    measured entire-model trace d·(1+Ω̂_em), and pick the smaller.
    `margin` is switch hysteresis (relative advantage required to move
    away from the current granularity)."""

    margin: float = 0.05
    name: str = "granularity_switch"
    needs_telemetry: bool = True
    needs_entire_model: bool = True

    def decide(self, summary, current, mplan=None):
        if (mplan is None or not summary.get("buckets")
                or current.granularity.kind == "blockwise"):
            return current
        em = summary.get("entire_model")
        if not em:  # counterfactual leg not measured this window
            return current
        omegas = unit_omegas(summary, mplan, metric="rel_err")
        lw_trace, _ = theory.noise_bounds_from_plan(mplan,
                                                    measured_w=omegas)
        em_trace = em["dim"] * (1.0 + em["rel_err"])
        if current.granularity.kind == "layerwise":
            better = em_trace < lw_trace * (1.0 - self.margin)
            target = "entire_model" if better else "layerwise"
        else:
            better = lw_trace < em_trace * (1.0 - self.margin)
            target = "layerwise" if better else "entire_model"
        if target == current.granularity.kind:
            return current
        return dataclasses.replace(current, granularity=Granularity(target))


@dataclasses.dataclass(frozen=True)
class BitBudgetPolicy:
    """Maximize captured gradient energy subject to a total uplink
    bits/step budget: start every bucket at the smallest ladder ratio,
    then greedily upgrade the bucket with the best marginal
    energy-per-bit until the budget is exhausted.

    The smallest ladder ratio is the floor: when even the floor
    allocation exceeds `bits_per_step`, the floor decision is returned
    anyway (the policy compresses as hard as it can rather than stalling
    training) — size the ladder/budget so the floor fits."""

    bits_per_step: int = 1 << 22
    ladder: Tuple[float, ...] = RATIO_LADDER
    name: str = "bit_budget"
    needs_telemetry: bool = True
    needs_entire_model: bool = False

    def _bits(self, decision, dim, n, r):
        c = dataclasses.replace(decision.qw, ratio=r)
        return n * c.payload_bits(dim)

    def decide(self, summary, current, mplan=None):
        buckets = summary.get("buckets")
        if (not buckets or not hasattr(current.qw, "ratio")
                or current.strategy == "shared_random"):
            return current
        ladder = sorted(self.ladder)
        level = {e["dim"]: 0 for e in buckets}
        info = {e["dim"]: e for e in buckets}

        def energy(entry, r):
            r_cur = _base_ratio(current, entry["dim"])
            rel_err = min(1.0, entry["rel_err"] * r_cur / max(r, 1e-12))
            return (1.0 - rel_err) * entry["grad_norm_sq"]

        total = sum(self._bits(current, d, info[d]["n_units"], ladder[0])
                    for d in level)
        while True:
            best, best_gain = None, 0.0
            for d, lv in level.items():
                if lv + 1 >= len(ladder):
                    continue
                e = info[d]
                extra = (self._bits(current, d, e["n_units"], ladder[lv + 1])
                         - self._bits(current, d, e["n_units"], ladder[lv]))
                if total + extra > self.bits_per_step:
                    continue
                # extra == 0: rounding kept k identical — a free upgrade
                gain = (float("inf") if extra <= 0 else
                        (energy(e, ladder[lv + 1]) - energy(e, ladder[lv]))
                        / extra)
                if gain > best_gain:
                    best, best_gain, best_extra = d, gain, extra
            if best is None:
                break
            level[best] += 1
            total += best_extra
        overrides = tuple(sorted((d, ladder[lv]) for d, lv in level.items()))
        return dataclasses.replace(current, ratio_overrides=overrides)


@dataclasses.dataclass(frozen=True)
class AdaptiveKPolicy:
    """Shi et al.'s layer-wise adaptive-k sparsification (arXiv
    1911.08727): keep the GLOBAL element budget of a flat `avg_ratio`
    top-k (budget = avg_ratio · total elements) but split it across
    buckets proportionally to each bucket's share of the measured
    gradient energy — layers currently carrying more of the gradient
    norm get a larger per-layer k, quiet layers get squeezed. Ratios
    snap to the ladder, so the emitted decisions form a small closed
    set and revisiting one hits the controller's step cache (never
    rebuilds).

    With no measured energy (all-zero window) every bucket falls back
    to the flat `avg_ratio` — the policy degrades to uniform top-k
    rather than emitting NaN shares."""

    avg_ratio: float = 0.05
    ladder: Tuple[float, ...] = RATIO_LADDER
    name: str = "adaptive_k"
    needs_telemetry: bool = True
    needs_entire_model: bool = False

    def decide(self, summary, current, mplan=None):
        buckets = summary.get("buckets")
        if (not buckets or not hasattr(current.qw, "ratio")
                or current.strategy == "shared_random"):
            return current
        elems = {e["dim"]: e["n_units"] * e["dim"] for e in buckets}
        budget = self.avg_ratio * sum(elems.values())
        total_energy = sum(e["grad_norm_sq"] for e in buckets)
        overrides = []
        for entry in buckets:
            dim = entry["dim"]
            if total_energy <= 0.0:
                want = self.avg_ratio
            else:
                share = entry["grad_norm_sq"] / total_energy
                want = budget * share / elems[dim]
            overrides.append((dim, _pick_ratio(self.ladder, want)))
        return dataclasses.replace(current,
                                   ratio_overrides=tuple(sorted(overrides)))


@dataclasses.dataclass(frozen=True)
class FusionPolicy:
    """Pick the comm-schedule fusion threshold from telemetry: for each
    candidate `fusion_bytes` in the ladder, price the window's measured
    per-bucket payload bits through the deterministic alpha-beta pipeline
    model (core.schedule.simulate_schedule) and choose the threshold with
    the smallest modeled step-completion time. High link alpha pushes
    toward one fused message (pay latency once); alpha ~ 0 pushes toward
    per-bucket messages (start streaming the moment backward produces a
    bucket). Ties break toward the earlier ladder entry (less fusion).

    Only the fusion_bytes field of the decision ever changes, and the
    ladder is finite — so the controller's decision -> step cache sees
    a small closed set of keys and revisiting a threshold never
    rebuilds (the builds-counter test).

    Modeled on the layer-wise measurement plan; non-layerwise decisions
    pass through unchanged (entire-model / blockwise plans are a single
    wire unit — there is nothing to fuse).
    """

    alpha_us: float = 50.0
    gbps: float = 12.5            # link bandwidth, GB/s (100 Gb/s)
    compress_gbps: float = 25.0   # compression-stream throughput, GB/s
    ladder: Tuple[float, ...] = FUSION_LADDER
    name: str = "fusion"
    needs_telemetry: bool = True
    needs_entire_model: bool = False

    def decide(self, summary, current, mplan=None):
        if mplan is None or current.granularity.kind != "layerwise":
            return current
        buckets = summary.get("buckets") or []
        bucket_bits = None
        if len(buckets) == len(mplan.buckets) and all(
                "payload_bits" in e for e in buckets):
            bucket_bits = [e["payload_bits"] for e in buckets]
        else:  # no measured window: static bits from the active decision
            qw = current.to_config().qw
            bucket_bits = [b.n * qw.payload_bits(b.dim)
                           for b in mplan.buckets]
        best, best_t = None, None
        for fb in self.ladder:
            sim = simulate_schedule(
                build_schedule(mplan, fb), bucket_bits=bucket_bits,
                alpha_us=self.alpha_us, gbps=self.gbps,
                compress_gbps=self.compress_gbps)
            if best_t is None or sim["t_total_us"] < best_t:
                best, best_t = fb, sim["t_total_us"]
        if best == current.fusion_bytes:
            return current
        return dataclasses.replace(current, fusion_bytes=best)


POLICIES = ("static", "variance_budget", "granularity_switch", "bit_budget",
            "adaptive_k", "fusion")


def make_policy(name: str, **kw) -> Policy:
    """Build a policy by CLI name. kw are dataclass fields (budget=,
    bits_per_step=, margin=, ladder=, alpha_us=, avg_ratio=)."""
    table = {"static": StaticPolicy, "variance_budget": VarianceBudgetPolicy,
             "granularity_switch": GranularitySwitchPolicy,
             "bit_budget": BitBudgetPolicy, "adaptive_k": AdaptiveKPolicy,
             "fusion": FusionPolicy}
    if name not in table:
        raise ValueError(f"unknown policy {name!r}; have {sorted(table)}")
    return table[name](**kw)
