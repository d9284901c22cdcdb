"""Engine-level comm scheduling (the JAX package's launch/comm_sched.py):
compile CommSchedules from an Engine's static UnitPlans and report the
alpha-beta latency picture beside the payload bits.

The engine owns the plans (built from its parameter shapes); this module
turns a fusion threshold into the schedule those plans stream through and
folds the schedule into the wire accounting (`bits.comm_report` message
counts and `simulate_schedule`'s modeled exposed comm). The times here
come from the deterministic alpha-beta MODEL, not a measurement: trust
the message and dispatch counts, read the modeled times as relative.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Union

from repro_torch.core.bits import comm_report
from repro_torch.core.plan import UnitPlan
from repro_torch.core.schedule import (CommSchedule, build_schedule,
                                       simulate_schedule)

ScheduleLike = Union[None, int, float, CommSchedule]


def resolve_schedule(plan: Optional[UnitPlan],
                     schedule: ScheduleLike) -> Optional[CommSchedule]:
    """Normalize build_train_step's `schedule=`: None passes through, a
    number is a fusion_bytes threshold compiled against `plan` (0 =
    per-bucket messages, math.inf = one fused message), and a
    CommSchedule is checked against the plan it must have been compiled
    from (a schedule of another partition would misroute buckets)."""
    if schedule is None:
        return None
    if isinstance(schedule, CommSchedule):
        return _checked(plan, schedule)
    if plan is None:                # nothing to schedule
        return None
    return build_schedule(plan, float(schedule))


def _checked(plan: Optional[UnitPlan],
             schedule: CommSchedule) -> CommSchedule:
    # structural equality, not identity: build_plan's cache can evict and
    # rebuild an equal but distinct plan in a long sweep
    if plan is not None and schedule.plan != plan:
        raise ValueError(
            "CommSchedule was compiled from a different UnitPlan than the "
            "engine's; pass fusion_bytes (a number) to compile against the "
            "engine's plan, or build via engine_schedule(engine, ...)")
    return schedule


def engine_schedule(engine, fusion_bytes: Union[int, float]
                    ) -> Optional[CommSchedule]:
    """The CommSchedule the engine's train step streams its data-parallel
    gradient leaves through, compiled from the same cached plan object
    the step executes with. None when the engine has no such leaves."""
    rest_plan, _ = engine.comm_plans()
    if rest_plan is None:
        return None
    return build_schedule(rest_plan, float(fusion_bytes))


def schedule_report(schedule: CommSchedule, cfg, n_workers: int, *,
                    alpha_us: float = 50.0, gbps: float = 12.5,
                    compress_gbps: float = 25.0,
                    backward_us: Optional[float] = None) -> Dict:
    """One JSON-ready dict joining the two views of a schedule: the
    analytic wire bits (comm_report, with the schedule's message count
    and the alpha term priced at alpha_us x gbps) and the modeled
    exposed-vs-overlapped timeline (simulate_schedule)."""
    if hasattr(cfg, "to_config"):
        cfg = cfg.to_config()
    # alpha in bit-equivalents: bits that could have crossed the link in
    # one message latency (us x GB/s x 8e3 bits/us-GBps)
    alpha_bits = int(alpha_us * gbps * 8e3)
    rep = comm_report(cfg, schedule.plan, n_workers, schedule=schedule,
                      alpha_bits_per_message=alpha_bits)
    sim = simulate_schedule(schedule, qw=cfg.qw, alpha_us=alpha_us,
                            gbps=gbps, compress_gbps=compress_gbps,
                            backward_us=backward_us)
    return {
        "summary": schedule.summary(),
        "fusion_bytes": (None if math.isinf(schedule.fusion_bytes)
                         else schedule.fusion_bytes),
        "n_messages": rep.n_messages,
        "n_dispatches": schedule.plan.num_dispatches,
        "n_units": schedule.plan.num_units,
        "uplink_bits_per_worker": rep.uplink_bits_per_worker,
        "latency_bits": rep.latency_bits(),
        "total_bits_with_latency": rep.total_bits_with_latency(),
        "model": sim,
    }
