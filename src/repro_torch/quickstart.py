"""Quickstart: the paper in one script, on the port (the JAX package's
examples/quickstart.py).

Trains a small causal LM with bidirectional compressed gradient
aggregation (Algorithm 1) over 4 simulated workers, comparing LAYER-WISE
vs ENTIRE-MODEL Top-k compression — the paper's central experiment —
then shows what the wire sees (the modeled comm schedule), what it
carries (packed bits, accounted against measured) and what one executed
wire step did (the trace recorder).

Run:  PYTHONPATH=src python -m repro_torch.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse
import sys

from repro_torch import random as R
from repro_torch import resolve_device
from repro_torch.core import (CompressionConfig, Granularity, build_plan,
                              build_schedule, make_compressor,
                              simulate_schedule, wire_codec)
from repro_torch.experiment import train_lm
from repro_torch.models import DistConfig, Model, ModelConfig

CFG = ModelConfig(name="quickstart-lm", arch_type="dense", n_layers=2,
                  d_model=64, vocab=128, n_heads=4, n_kv_heads=2,
                  d_head=16, d_ff=128, dtype="float32")
WORKERS, STEPS, LR = 4, 40, 0.3


def train(granularity: str, device="cuda", steps: int = STEPS):
    """(first loss, last loss) of the quickstart LM trained with top-k(10%)
    at `granularity` over WORKERS simulated workers (experiment.train_lm:
    the reference's params, batches, keys and step)."""
    comp = CompressionConfig(
        qw=make_compressor("topk", ratio=0.1),       # worker-side Q_W
        qm=make_compressor("identity"),              # master-side Q_M
        granularity=Granularity(granularity))
    first, last, _, _ = train_lm(CFG, comp, steps=steps, workers=WORKERS,
                                 lr=LR, batch=8, seq=32, seed=0,
                                 device=device)
    return first, last


def _layerwise_plan():
    model = Model(CFG, DistConfig())
    return build_plan(model.param_shapes(), model.stacked(),
                      Granularity("layerwise"))


def show_schedule():
    """The practical-timing side of the paper's gap: what the wire sees.
    Layer-wise compression without scheduling pays per-unit message
    latency; a CommSchedule streams backward-ordered fused messages —
    same numerics, a different latency picture (modeled; trust the
    counts, not microseconds)."""
    plan = _layerwise_plan()
    qw = make_compressor("topk", ratio=0.1)
    for label, fb in (("per-bucket", 0.0), ("fused 64KiB", 65536.0)):
        sched = build_schedule(plan, fb)
        sim = simulate_schedule(sched, qw=qw)
        print(f"  {label:12s}: {sched.num_messages:2d} messages, modeled "
              f"exposed comm {sim['exposed_comm_us']:7.1f}us "
              f"(overlap {sim['overlap_frac']:.0%})")


def show_wire():
    """The other half of the gap: are the accounted bits ACHIEVABLE?
    Every compressor has a WireCodec whose bit-packed payload round-trips
    bit-exactly to the simulated operator, so the measured number below
    is real bytes, not an estimate."""
    plan = _layerwise_plan()
    qw = make_compressor("topk", ratio=0.1)
    codec = wire_codec(qw)
    acct = sum(qw.payload_bits(d) for d in plan.unit_dims)
    meas = sum(codec.wire_bits(d) for d in plan.unit_dims)
    print(f"  topk 10% layer-wise: accounted {acct} bits/step, measured "
          f"{meas} bits of packed payload (word padding {meas - acct})")


def show_trace(device="cuda"):
    """One traced step of the real wire pipeline: the schedule above is a
    MODEL; the TraceRecorder stamps what execution actually did — one span
    per wire message plus compress / pack / decode stage spans (CUDA
    events on the card), Chrome trace-event exportable
    (TraceRecorder.export -> Perfetto)."""
    from repro_torch.core.wire import execute_schedule_wire
    from repro_torch.obs import TraceRecorder, format_step_summary
    dev = resolve_device(device)
    model = Model(CFG, DistConfig())
    params = model.init(R.key(0), device=dev)
    plan = build_plan(params, model.stacked(), Granularity("layerwise"))
    sched = build_schedule(plan, 65536.0)
    codec = wire_codec(make_compressor("qsgd", levels=16))
    rec = TraceRecorder()
    execute_schedule_wire(sched, codec, params, R.key(3), recorder=rec)
    print("  " + format_step_summary(rec.finalize_step(0)))
    print(f"  ({sched.num_messages} wire messages -> "
          f"{len(rec.message_spans(0))} message spans; "
          f"rec.export('trace.json') opens in Perfetto)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--steps", type=int, default=STEPS)
    args = ap.parse_args(argv)
    for gran in ("layerwise", "entire_model"):
        first, last = train(gran, args.device, args.steps)
        print(f"{gran:13s}: loss {first:.3f} -> {last:.3f}")
    print("Both converge; python -m repro_torch.figures runs the full "
          "paper-style accuracy comparison across six compressors.")
    print("Comm schedule (what the wire sees for the layer-wise run):")
    show_schedule()
    print("Wire formats (what the wire actually carries):")
    show_wire()
    print("Trace (what one executed wire step actually did):")
    show_trace(args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
