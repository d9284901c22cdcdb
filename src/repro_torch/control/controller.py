"""The adaptive compression controller: telemetry -> policy -> decision ->
plan / step cache (the JAX package's control/controller.py).

The Controller is harness-agnostic: it owns the *control plane* (what to
compress, how hard, at which granularity) and delegates the *data plane*
to a `build_step(decision) -> step_fn` factory supplied by the harness
(launch/engine.py for the data-parallel LM engine, experiment.py's
cnn_controller for the simulated-worker CNN study). Steps are cached per
decision, so a policy that revisits a decision NEVER builds it again:
the acceptance property `builds == number of distinct decisions` is
exposed as `self.builds`. Torch compiles nothing per step (there is no
jit cache to probe), so a build is the step factory's call and
`jit_recompiles` stays 0.

Lifecycle per step i:

    fn = ctrl.step_fn()              # cached step for the decision
    ... run fn, threading ctrl.telemetry if ctrl.collect ...
    ctrl.observe(new_telem, i)       # store window; re-plan every K steps

At a re-plan boundary the controller summarizes the telemetry window on
the host, asks the policy for a decision, records the window + any switch
for JSON export, and resets the window.
"""
from __future__ import annotations

import math
import warnings
from typing import Callable, Dict, List, Optional

from repro_torch.control.policy import CompressionDecision, Policy
from repro_torch.control.telemetry import (TELEMETRY_SCHEMA_VERSION,
                                           TelemetryState, init_telemetry,
                                           summarize, to_json)
from repro_torch.core.plan import UnitPlan


class Controller:
    def __init__(self, policy: Policy, build_step: Callable,
                 base: CompressionDecision, mplan: UnitPlan, *,
                 replan_every: int = 20,
                 collect_telemetry: Optional[bool] = None,
                 cache: Optional[dict] = None, cache_tag=None,
                 metrics=None):
        """`cache` may be shared between controllers (e.g. a sweep) — it
        is keyed on (decision, telemetry-enabled, cache_tag) so steps
        with different build shapes never collide; harnesses pass their
        extra build flags (e.g. the entire-model telemetry leg) as
        `cache_tag`. `metrics` (duck-typed, obs.metrics.MetricsRegistry)
        receives builds/switch/retrace counters."""
        self.policy = policy
        self.build_step = build_step
        self.mplan = mplan
        self.replan_every = max(1, int(replan_every))
        self.collect = (policy.needs_telemetry if collect_telemetry is None
                        else bool(collect_telemetry))
        self.decision = base
        self.telemetry: Optional[TelemetryState] = (
            init_telemetry(mplan) if self.collect else None)
        self._cache = {} if cache is None else cache
        self._cache_tag = cache_tag
        self.metrics = metrics
        self.builds = 0            # build_step invocations
        self.retraces_unexpected = 0   # rebuilds of previously-built keys
        self.jit_recompiles = 0    # no jit cache in torch: stays 0
        self._built_keys: set = set()
        self.switches: List[Dict] = []
        self.windows: List[Dict] = []

    # ---- data plane ------------------------------------------------------
    def step_fn(self):
        """The step for the current decision (cached)."""
        return self._bundle(self.decision)

    def _bundle(self, decision: CompressionDecision):
        key = (decision, self.collect, self._cache_tag)
        if key not in self._cache:
            if key in self._built_keys:
                # rebuild watchdog: revisiting a cached decision must be
                # a dict hit (the no-rebuild acceptance property). A
                # rebuild here means the shared cache was cleared or
                # evicted behind our back — surface it, don't hide it.
                self.retraces_unexpected += 1
                if self.metrics is not None:
                    self.metrics.inc("controller/retraces_unexpected")
                warnings.warn(
                    f"unexpected retrace: decision "
                    f"{decision.describe()!r} was built before but is "
                    f"missing from the step cache (cleared or evicted?) "
                    f"— rebuilding", RuntimeWarning, stacklevel=3)
            self._cache[key] = self.build_step(decision)
            self.builds += 1
            self._built_keys.add(key)
            if self.metrics is not None:
                self.metrics.inc("controller/builds")
        return self._cache[key]

    def check_retraces(self) -> int:
        """The watchdog's unexpected-rebuild count (cache-evicted rebuilds
        of previously built decisions): 0 on every healthy run. The
        reference also probes each cached step's jit for extra compiled
        signatures; a torch step has no jit cache, so `jit_recompiles`
        stays 0 (the reference's probe gives 0 on a function without
        `_cache_size` too) and is kept for the report's schema and the
        `controller/jit_recompiles` gauge."""
        self.jit_recompiles = 0
        if self.metrics is not None:
            self.metrics.gauge("controller/retraces_unexpected_total",
                               self.retraces_unexpected)
            self.metrics.gauge("controller/jit_recompiles",
                               self.jit_recompiles)
        return self.retraces_unexpected

    def config(self):
        return self.decision.to_config()

    def set_decision(self, decision: CompressionDecision) -> None:
        """Force a decision (sweeps / tests). Keeps the cache."""
        self.decision = decision
        if self.collect:
            self.telemetry = init_telemetry(self.mplan)

    # ---- control plane ---------------------------------------------------
    def observe(self, telemetry: Optional[TelemetryState],
                step_idx: int) -> bool:
        """Record the step's returned telemetry state; at a re-plan
        boundary summarize the window and consult the policy. Returns
        True when the decision changed."""
        if self.collect and telemetry is not None:
            self.telemetry = telemetry
        if (step_idx + 1) % self.replan_every:
            return False
        return self._replan(step_idx)

    def _replan(self, step_idx: int) -> bool:
        summary = (summarize(self.telemetry, self.mplan,
                             qw=self.config().qw)
                   if self.collect else {})
        self.windows.append({"step": step_idx,
                             "decision": self.decision.describe(),
                             "summary": summary})
        new = self.policy.decide(summary, self.decision, self.mplan)
        changed = new != self.decision
        if self.metrics is not None:
            self.metrics.inc("controller/replans")
        if changed:
            self.switches.append({"step": step_idx,
                                  "from": self.decision.describe(),
                                  "to": new.describe()})
            self.decision = new
            if self.metrics is not None:
                self.metrics.inc("controller/switches")
        if self.collect:  # fresh window per re-plan interval
            self.telemetry = init_telemetry(self.mplan)
        return changed

    # ---- export ----------------------------------------------------------
    def active_decision(self) -> Dict:
        """The current decision as a self-describing plain dict (the
        `active` block of report()/--telemetry-out: policy name,
        compressors, granularity, fusion_bytes, ratios)."""
        d = self.decision
        fb = d.fusion_bytes
        return {
            "policy": self.policy.name,
            "decision": d.describe(),
            "granularity": d.granularity.kind,
            "compressor": d.qw.name,
            "master_compressor": d.qm.name,
            "strategy": d.strategy,
            "error_feedback": d.error_feedback,
            "wire_dtype": d.wire_dtype,
            "ratio": getattr(d.qw, "ratio", None),
            "ratio_overrides": {str(dim): r
                                for dim, r in d.ratio_overrides},
            "fusion_bytes": (None if fb is None
                             else "inf" if math.isinf(fb) else fb),
        }

    def report(self) -> Dict:
        return {
            "schema_version": TELEMETRY_SCHEMA_VERSION,
            "policy": self.policy.name,
            "replan_every": self.replan_every,
            "decision": self.decision.describe(),
            "active": self.active_decision(),
            "builds": self.builds,
            "retraces_unexpected": self.check_retraces(),
            "jit_recompiles": self.jit_recompiles,
            "switches": self.switches,
            "windows": self.windows,
        }

    def export(self, path: str) -> None:
        to_json(self.report(), path)


def engine_controller(engine, policy: Policy, *, lr_schedule=None,
                      base: Optional[CompressionDecision] = None,
                      replan_every: int = 20,
                      collect_telemetry: Optional[bool] = None,
                      cache: Optional[dict] = None,
                      metrics=None, tracer=None) -> Controller:
    """Controller over launch/engine.py Engine's train step. The step
    factory threads the decision's CompressionConfig (and, when telemetry
    is on, the TelemetryState leg) through Engine.build_train_step.
    `metrics` / `tracer` (duck-typed obs registry / recorder) instrument
    the built steps and the controller's own counters."""
    from repro_torch.core.aggregation import no_compression
    if base is None:
        base = CompressionDecision.from_config(
            engine.comp if engine.comp is not None else no_compression())
    collect = (policy.needs_telemetry if collect_telemetry is None
               else bool(collect_telemetry))
    em = getattr(policy, "needs_entire_model", True)

    def build(decision: CompressionDecision):
        return engine.build_train_step(lr_schedule,
                                       comp=decision.to_config(),
                                       telemetry=collect,
                                       telemetry_entire_model=em,
                                       tracer=tracer, metrics=metrics)

    # the tag carries every build input besides the decision, so a cache
    # shared across controllers never hands back a step built for a
    # different engine / schedule / telemetry shape or tracer
    return Controller(policy, build, base, engine.measurement_plan(),
                      replan_every=replan_every, collect_telemetry=collect,
                      cache=cache, metrics=metrics,
                      cache_tag=("engine", engine, lr_schedule, em, tracer))
