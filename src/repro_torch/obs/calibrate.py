"""Measured-vs-modeled comm calibration (the JAX package's
obs/calibrate.py).

`core.schedule.simulate_schedule` is an alpha-beta MODEL: per message,
comm = alpha_us + bytes/(gbps*1e3), overlapped against a modeled
backward. This module sets it beside the pipeline the port executes.

`measure_schedule` runs the REAL scheduled wire pipeline (encode ->
packed uint8 buffer -> decode, the path `--wire` training steps run)
under a TraceRecorder and reports per-message measured durations.
`fit_alpha_beta` least-squares fits the model's two parameters to the
measured (bytes, duration) samples, per host. `calibrate` sweeps fusion
thresholds for one gradient tree and reports, per threshold, measured
exposed comm next to the model's prediction under BOTH the default
parameters and the fitted ones.

`measure_stream` (the streaming ring, mode ring or rs) and
`measure_collective` (the allgather wire collective) run on every rank
of a torch.distributed group, where the reference runs a shard_map over
local devices: each rank records its own timeline (pid = rank) and
returns its own report.

Where the tree lives on a CUDA device the marks are CUDA events (the
card's clock, obs.trace); on the CPU the host clock. The port encodes a
step's buckets in one grouped launch and decodes them in one, so every
message's span covers those shared intervals (obs.trace.mark_group): a
message's duration is not its own compress / decode time, and the
per-message samples of one threshold share most of their duration.

Honesty note (the reference's): `measure_schedule` is a single-process
measurement of the serialized compress / pack / decode stream — there is
no network and nothing overlaps, so measured "exposed" comm equals the
measured stream total. Reps take medians; the stable signals are the
counts and byte totals. The fitted alpha / beta describe this host's
executed stream, not a cluster interconnect.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch.distributed as dist

from repro_torch.obs.trace import TraceRecorder, validate_chrome_trace

__all__ = ["measure_schedule", "measure_stream", "measure_collective",
           "fit_alpha_beta", "calibrate", "DEFAULT_THRESHOLDS"]

#: the acceptance sweep: per-bucket, 64 KiB Horovod-style buffers, one shot
DEFAULT_THRESHOLDS: Tuple[Tuple[str, float], ...] = (
    ("per_bucket", 0.0),
    ("fused_64kib", float(1 << 16)),
    ("one_shot", math.inf),
)


def _median(vals: Sequence[float]) -> float:
    sv = sorted(vals)
    return sv[len(sv) // 2] if sv else 0.0


def _rank(group=None) -> int:
    return dist.get_rank(group) if dist.is_initialized() else 0


def _timed_reps(run, rec: TraceRecorder, reps: int, warmup: int):
    """warmup untimed calls of run(), then reps recorded ones, each
    finalized after it -> (wall totals, {stage: [us]}), the recorder
    holding only the timed reps' events."""
    for _ in range(warmup):
        run()
        rec.finalize_step()
    rec.events, rec.steps = [], []  # keep only the timed reps
    totals, stage_accum = [], {}
    for r in range(reps):
        run()
        summary = rec.finalize_step(r)
        totals.append(summary["wall_us"])
        for k, v in summary["stage_us"].items():
            stage_accum.setdefault(k, []).append(v)
    return totals, stage_accum


def _stage_medians(stage_accum: Dict[str, List[float]]) -> Dict[str, float]:
    return {k: round(_median(v), 3) for k, v in sorted(stage_accum.items())}


def measure_schedule(tree, stacked, comp, fusion_bytes: float, *,
                     granularity: str = "layerwise", reps: int = 3,
                     warmup: int = 1, seed: int = 0) -> Dict:
    """Execute the real wire schedule for (tree, comp, fusion_bytes)
    under a TraceRecorder; return measured per-message durations plus
    stage totals.

    Returns {"n_messages", "wire_bytes" (buffer bytes incl. headers),
    "total_us" (median step wall), "stage_us" {stage: median},
    "per_message": [{"message", "wire_bytes", "dur_us"}]}."""
    from repro_torch import random as R
    from repro_torch.core import build_plan, build_schedule, wire_codec
    from repro_torch.core.granularity import Granularity
    from repro_torch.core.wire import execute_schedule_wire, message_layouts

    plan = build_plan(tree, stacked, Granularity(granularity))
    sched = build_schedule(plan, float(fusion_bytes))
    codec = wire_codec(comp)
    layouts = message_layouts(sched, codec)
    rec = TraceRecorder(pid=_rank())
    key = R.key(seed)
    totals, stage_accum = _timed_reps(
        lambda: execute_schedule_wire(sched, codec, tree, key, recorder=rec),
        rec, reps, warmup)
    per_message = []
    for mi, layout in enumerate(layouts):
        ds = [float(e["dur"]) for e in rec.message_spans()
              if int(e["args"]["message"]) == mi]
        per_message.append({"message": mi,
                            "wire_bytes": int(layout.total_nbytes),
                            "dur_us": round(_median(ds), 3)})
    return {
        "n_messages": sched.num_messages,
        "wire_bytes": int(sum(l.total_nbytes for l in layouts)),
        "total_us": round(_median(totals), 3),
        "stage_us": _stage_medians(stage_accum),
        "per_message": per_message,
    }


def measure_stream(tree, stacked, comp, fusion_bytes: float, *,
                   mode: str = "ring", granularity: str = "layerwise",
                   chunk_bytes: Optional[float] = None, reps: int = 3,
                   warmup: int = 1, seed: int = 0, group=None) -> Dict:
    """Execute the STREAMING ring collective for (tree, comp,
    fusion_bytes) across the ranks of `group` (every rank calls it with
    its own tree) and report this rank's per-hop structure plus measured
    exposed comm.

    Unlike `measure_schedule` (the serialized single-process stream),
    this runs `CommSchedule.execute_streaming`: the chunked ring
    (mode='ring', the full message buffer circulates each hop) or the
    reduce-scatter shard stream (mode='rs', packed shards circulate). The
    gateable signals are the COUNTS (hop spans per step == n_messages x
    (n_workers - 1)) and BYTES per hop; `hop_us`, the measured
    exposed-comm proxy, is this rank's summed hop time. The trace is
    validated against the Chrome trace-event schema before returning.

    Returns {"mode", "n_workers", "n_messages", "n_hops",
    "n_hop_spans_measured", "wire_bytes", "hop_bytes_total", "hop_us",
    "total_us", "stage_us", "per_message": [{"message", "wire_bytes",
    "n_chunks", "hop_bytes"}]}."""
    from repro_torch import random as R
    from repro_torch.core import build_plan, build_schedule, wire_codec
    from repro_torch.core.granularity import Granularity
    from repro_torch.core.wire import (layout_chunks, message_layouts,
                                       shard_message_layouts)

    n = dist.get_world_size(group)
    plan = build_plan(tree, stacked, Granularity(granularity))
    sched = build_schedule(plan, float(fusion_bytes))
    codec = wire_codec(comp)
    layouts = (message_layouts(sched, codec) if mode == "ring"
               else shard_message_layouts(sched, codec, n))
    rec = TraceRecorder(pid=_rank(group))
    key = R.key(seed)
    totals, stage_accum = _timed_reps(
        lambda: sched.execute_streaming(
            None, tree, key, wire=codec, group=group, n_workers=n,
            mode=mode, chunk_bytes=chunk_bytes, recorder=rec),
        rec, reps, warmup)
    hop_counts = [sum(1 for e in rec.span_events(step=r)
                      if e["args"].get("stage") == "hop")
                  for r in range(reps)]
    validate_chrome_trace(rec.chrome_trace())
    per_message = [{"message": mi,
                    "wire_bytes": int(l.total_nbytes),
                    "n_chunks": len(layout_chunks(l, chunk_bytes)),
                    "hop_bytes": int((n - 1) * l.total_nbytes)}
                   for mi, l in enumerate(layouts)]
    stage_us = _stage_medians(stage_accum)
    return {
        "mode": mode,
        "n_workers": n,
        "n_messages": sched.num_messages,
        "n_hops": sched.num_messages * (n - 1),
        "n_hop_spans_measured": int(_median(hop_counts)),
        "wire_bytes": int(sum(l.total_nbytes for l in layouts)),
        "hop_bytes_total": int(sum(m["hop_bytes"] for m in per_message)),
        "hop_us": stage_us.get("hop", 0.0),
        "total_us": round(_median(totals), 3),
        "stage_us": stage_us,
        "per_message": per_message,
    }


def measure_collective(tree, stacked, comp, fusion_bytes: float, *,
                       strategy: str = "allgather",
                       granularity: str = "layerwise", reps: int = 3,
                       warmup: int = 1, seed: int = 0, group=None) -> Dict:
    """The SERIALIZED wire collective across the same ranks as
    `measure_stream`: compressed_allreduce(strategy='allgather',
    wire=True) — compress, pack, the gathers, decode — whose `total_us`
    is the serialized-stream total the ring's exposed hop time is set
    beside (same ranks, same process group). Returns {"n_workers",
    "n_messages", "wire_bytes", "total_us", "stage_us"}."""
    from repro_torch import random as R
    from repro_torch.core import build_plan, build_schedule, wire_codec
    from repro_torch.core.aggregation import (CompressionConfig,
                                              compressed_allreduce)
    from repro_torch.core.granularity import Granularity
    from repro_torch.core.wire import message_layouts

    n = dist.get_world_size(group)
    gran = Granularity(granularity)
    plan = build_plan(tree, stacked, gran)
    sched = build_schedule(plan, float(fusion_bytes))
    layouts = message_layouts(sched, wire_codec(comp))
    cfg = CompressionConfig(qw=comp, granularity=gran, strategy=strategy,
                            fusion_bytes=float(fusion_bytes))
    rec = TraceRecorder(pid=_rank(group))
    key = R.key(seed)
    totals, stage_accum = _timed_reps(
        lambda: compressed_allreduce(tree, stacked, cfg, group, key, n,
                                     plan=plan, wire=True, recorder=rec),
        rec, reps, warmup)
    return {
        "n_workers": n,
        "n_messages": sched.num_messages,
        "wire_bytes": int(sum(l.total_nbytes for l in layouts)),
        "total_us": round(_median(totals), 3),
        "stage_us": _stage_medians(stage_accum),
    }


def fit_alpha_beta(samples: Sequence[Tuple[float, float]],
                   prior_alpha_us: float = 50.0,
                   prior_gbps: float = 12.5) -> Dict:
    """Least-squares fit t_us = alpha_us + nbytes/(gbps*1e3) over
    measured (nbytes, dur_us) samples. Slope is clamped non-negative
    (a negative slope just means latency dominates at these sizes);
    alpha is clamped non-negative likewise.

    Degenerate inputs — fewer than two DISTINCT message sizes (e.g.
    fusion=inf produces exactly one message, so every sample shares one
    x) or non-finite samples — cannot identify two parameters: such
    inputs return the PRIOR (`prior_alpha_us`, `prior_gbps` — the
    model's defaults) with an explicit ``fit_degenerate: True`` flag,
    and `resid_rms_us` reports the misfit of the prior against the
    samples. Empty samples give {alpha 0, gbps None}, flagged degenerate
    likewise. (The reference's function, line for line.)"""
    n = len(samples)
    if n == 0:
        return {"alpha_us": 0.0, "gbps": None, "n_samples": 0,
                "resid_rms_us": 0.0, "fit_degenerate": True}
    xs = [float(b) for b, _ in samples]
    ys = [float(t) for _, t in samples]
    finite = all(math.isfinite(v) for v in xs + ys)
    mx = sum(xs) / n if finite else 0.0
    my = sum(ys) / n if finite else 0.0
    sxx = sum((x - mx) ** 2 for x in xs) if finite else 0.0
    degenerate = (not finite or len(set(xs)) < 2 or sxx <= 0.0)
    if degenerate:
        slope = 1.0 / (prior_gbps * 1e3)
        alpha = float(prior_alpha_us)
        gbps = float(prior_gbps)
    else:
        sxy = sum((x - mx) * (y - my) for x, y in zip(xs, ys))
        slope = max(sxy / sxx, 0.0)   # us per byte
        alpha = max(0.0, my - slope * mx)
        gbps = (1.0 / (slope * 1e3)) if slope > 1e-12 else None
        if not all(math.isfinite(v) for v in
                   (slope, alpha) + (() if gbps is None else (gbps,))):
            degenerate, slope, alpha, gbps = (
                True, 1.0 / (prior_gbps * 1e3), float(prior_alpha_us),
                float(prior_gbps))
    resid = [y - (alpha + slope * x) for x, y in zip(xs, ys)
             if math.isfinite(x) and math.isfinite(y)]
    rms = (math.sqrt(sum(r * r for r in resid) / len(resid))
           if resid else 0.0)
    return {"alpha_us": round(alpha, 3),
            "gbps": round(gbps, 3) if gbps is not None else None,
            "us_per_byte": round(slope, 6),
            "n_samples": n,
            "resid_rms_us": round(rms, 3),
            "fit_degenerate": degenerate}


def _predict_us(n_messages: int, nbytes: int, alpha_us: float,
                gbps: Optional[float], us_per_byte: float = 0.0) -> float:
    """The model's comm time. A fitted gbps that rounds to 0.0 (a slope
    steeper than 2 us a byte) predicts with the fit's us_per_byte, where
    the reference divides by zero (ROADMAP Queue 3 item 19)."""
    if gbps is None:
        beta = 0.0
    elif gbps == 0.0:
        beta = us_per_byte
    else:
        beta = 1.0 / (gbps * 1e3)
    return n_messages * alpha_us + nbytes * beta


def calibrate(name: str, tree, stacked, comp, *,
              thresholds: Sequence[Tuple[str, float]] = DEFAULT_THRESHOLDS,
              granularity: str = "layerwise", reps: int = 3,
              alpha_us: float = 50.0, gbps: float = 12.5,
              compress_gbps: float = 25.0) -> Dict:
    """Measured-vs-modeled calibration report for one gradient tree.

    Per fusion threshold: the measured wire-schedule stream next to the
    alpha-beta model's comm prediction under the DEFAULT parameters and
    under parameters FITTED to this host's measurements (error ratio =
    measured / predicted). The host key is this process's rank (0
    outside a process group)."""
    from repro_torch.core import build_plan, build_schedule, simulate_schedule
    from repro_torch.core.granularity import Granularity

    plan = build_plan(tree, stacked, Granularity(granularity))
    per_threshold: Dict[str, Dict] = {}
    samples: List[Tuple[float, float]] = []
    for label, fb in thresholds:
        meas = measure_schedule(tree, stacked, comp, fb,
                                granularity=granularity, reps=reps)
        sched = build_schedule(plan, float(fb))
        sim = simulate_schedule(sched, qw=comp, alpha_us=alpha_us,
                                gbps=gbps, compress_gbps=compress_gbps)
        samples.extend((m["wire_bytes"], m["dur_us"])
                       for m in meas["per_message"])
        per_threshold[label] = {
            "fusion_bytes": None if math.isinf(fb) else fb,
            "n_messages": meas["n_messages"],
            "wire_bytes_measured": meas["wire_bytes"],
            "wire_bits_model": sim["wire_bits_total"],
            "exposed_comm_us_measured": meas["total_us"],
            "exposed_comm_us_model": sim["exposed_comm_us"],
            "comm_us_total_model": sim["comm_us_total"],
            "stage_us_measured": meas["stage_us"],
            "per_message_measured": meas["per_message"],
        }

    fit = fit_alpha_beta(samples, prior_alpha_us=alpha_us, prior_gbps=gbps)
    host = str(_rank())
    for label, _ in thresholds:
        t = per_threshold[label]
        pred_default = _predict_us(t["n_messages"], t["wire_bytes_measured"],
                                   alpha_us, gbps)
        pred_fitted = _predict_us(t["n_messages"], t["wire_bytes_measured"],
                                  fit["alpha_us"], fit["gbps"],
                                  fit.get("us_per_byte", 0.0))
        meas_us = t["exposed_comm_us_measured"]
        t["model_error_ratio_default"] = round(
            meas_us / max(pred_default, 1e-9), 3)
        t["model_error_ratio_fitted"] = round(
            meas_us / max(pred_fitted, 1e-9), 3)
    return {
        "config": name,
        "codec": comp.name,
        "granularity": granularity,
        "model_defaults": {"alpha_us": alpha_us, "gbps": gbps,
                           "compress_gbps": compress_gbps},
        "fit_by_host": {host: fit},
        "thresholds": per_threshold,
    }
