"""Mini reproduction of the paper's empirical study (Table view) on the
port (the JAX package's examples/granularity_study.py): layer-wise vs
entire-model accuracy for several compressors on the CPU-scale DAWNBench
stand-ins, driven through the adaptive-control subsystem: ONE Controller
per model sweeps every (compressor, granularity) as a
CompressionDecision, reusing cached UnitPlans and built steps across the
whole sweep (the baseline step is built once, not once per row).
`--adaptive` appends rows where the framework itself picks the
configuration (the paper's closing recommendation).

Run:  python -m repro_torch.granularity_study [--steps 60] [--device cpu]
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.control import (CompressionDecision, StaticPolicy,
                                 make_policy)
from repro_torch.core import Granularity, make_compressor
from repro_torch.experiment import (cnn_controller, dense_decision,
                                    train_cnn_with_controller)

RUNS = [
    ("topk", {"ratio": 0.01}),
    ("randomk", {"ratio": 0.01}),
    ("terngrad", {}),
    ("qsgd", {"levels": 4}),
    ("adaptive_threshold", {"alpha": 0.05}),
    ("threshold_v", {"v": 1e-3}),
]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--model", default="resnet9",
                    choices=["resnet9", "alexnet", "mlp"])
    ap.add_argument("--adaptive", action="store_true",
                    help="also run the adaptive policies (the framework "
                         "picks granularity/ratio from telemetry)")
    ap.add_argument("--replan-every", type=int, default=15)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cache: dict = {}  # shared decision -> step cache for the sweep
    ctrl = cnn_controller(args.model, StaticPolicy(), cache=cache)

    def run(decision):
        ctrl.set_decision(decision)
        acc, _ = train_cnn_with_controller(args.model, ctrl,
                                           steps=args.steps,
                                           device=args.device)
        return acc

    print(f"model={args.model} steps={args.steps}")
    print(f"{'compressor':22s} {'layer-wise':>10s} {'entire':>10s} "
          f"{'baseline':>10s}  verdict")
    baseline = run(dense_decision())
    for name, kw in RUNS:
        acc = {}
        for gran in ("layerwise", "entire_model"):
            acc[gran] = run(CompressionDecision(
                qw=make_compressor(name, **kw),
                granularity=Granularity(gran)))
        verdict = ("layer-wise better"
                   if acc["layerwise"] > acc["entire_model"] + 0.02 else
                   "entire-model better"
                   if acc["entire_model"] > acc["layerwise"] + 0.02
                   else "comparable")
        print(f"{name:22s} {acc['layerwise']:10.3f} "
              f"{acc['entire_model']:10.3f} {baseline:10.3f}  {verdict}",
              flush=True)
    print(f"[cache] {len(cache)} built steps for "
          f"{1 + 2 * len(RUNS)} sweep rows ({ctrl.builds} builds)")

    if not args.adaptive:
        return 0
    print("\nadaptive policies (framework picks the configuration):")
    base = CompressionDecision(qw=make_compressor("topk", ratio=0.01),
                               granularity=Granularity("layerwise"))
    for pname, kw in [("granularity_switch", {}),
                      ("variance_budget", {"budget": 0.3})]:
        actrl = cnn_controller(args.model, make_policy(pname, **kw),
                               base=base, replan_every=args.replan_every,
                               cache=cache)
        acc, _ = train_cnn_with_controller(args.model, actrl,
                                           steps=args.steps,
                                           device=args.device)
        print(f"{pname:22s} {acc:10.3f}  final={actrl.decision.describe()} "
              f"switches={len(actrl.switches)} builds={actrl.builds}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
