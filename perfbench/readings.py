#!/usr/bin/env python3
"""The readings that a cell's limits are set from, at the cell's own
size on the card, one JSON line a seed and mode:

  sound       the program's checked steps against the reference (the
              lower readings)
  control     the reference with every matrix product in float8 e4m3
              (per-tensor scaled) against the float32 one
  half_batch  the program with half of the workers' gradients left out
              and the mean taken over the rest

    python3 perfbench/readings.py --workload <cell> \
        --modes sound,control,half_batch --seeds 11,12,13,14 \
        --other-seeds 11,12,13

A seed's modes share one run of the float32 reference. The benchmark's
own runs never run this. A step that returns its state unchanged reads 1
on change_norm by the measure alone and needs no run.
"""
import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE.parent / "src"))


def half_batch(program):
    """Patch the program's worker gradients to keep the first half of the
    workers only (restored by the returned function)."""
    exp = program.experiment
    orig = exp.lm_worker_grads

    def first_half(model, params, batch, key, workers):
        g, losses = orig(model, params, batch, key, workers)
        h = workers // 2

        def cut(t):
            return {k: cut(v) for k, v in t.items()} if isinstance(
                t, dict) else t[:h]
        return cut(g), losses[:h]
    exp.lm_worker_grads = first_half

    def restore():
        exp.lm_worker_grads = orig
    return restore


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--modes", default="sound",
                    help="comma-separated, of sound, control, half_batch")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--other-seeds", default="",
                    help="the seeds that control and half_batch read "
                    "(default: all of --seeds)")
    args = ap.parse_args(argv)
    import torch
    from pbench import cells, harness
    from pbench.ref_common import fp8_matmul
    if not torch.cuda.is_available():
        print("readings.py: no CUDA device", file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    harness.full_precision()
    cell = cells.load(args.workload)
    modes = args.modes.split(",")
    seeds = [int(s) for s in args.seeds.split(",")]
    other = ({int(s) for s in args.other_seeds.split(",")}
             if args.other_seeds else set(seeds))
    for seed in seeds:
        t0 = time.monotonic()
        got = {}
        for mode in ("sound", "half_batch"):
            if mode in modes and (mode == "sound" or seed in other):
                r = harness.Run(cell, seed, dev)
                restore = (half_batch(r.program) if mode == "half_batch"
                           else (lambda: None))
                try:
                    got[mode] = r.checked()
                finally:
                    restore()
                r.close()
        if "control" in modes and seed in other:
            got["control"] = harness.reference(cell, seed, dev, mm=fp8_matmul)
        ref = harness.reference(cell, seed, dev)
        for mode, out in got.items():
            print(json.dumps({"workload": args.workload, "mode": mode,
                              "seed": seed,
                              "numbers": harness.compare(cell, out, ref),
                              "seconds": time.monotonic() - t0}), flush=True)
        del ref, got
        harness._free()
    return 0


if __name__ == "__main__":
    sys.exit(main())
