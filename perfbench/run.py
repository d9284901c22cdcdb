#!/usr/bin/env python3
"""Runs one cell of the benchmark once, on the CUDA card it finds:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints the result as one JSON line, the last of standard output: the
cell's end-to-end metrics (--trace 0) or its per-layer metrics (--trace
1), whether the checked steps agree with the plain reference, and the
device. The numbers compared, each beside its limit, are the last lines
of standard error. Exits non-zero, with no result, when there is no card
or fewer than the cell needs, or when the JAX package or JAX was loaded.
"""
import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# module top-level names that must never load in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _caches() -> None:
    """Every build and kernel cache at a fixed place in the checkout."""
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules(modules=None) -> list:
    """The FORBIDDEN top-level names among the loaded modules, compared
    whole (so repro_torch is not repro)."""
    modules = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in list(modules)} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches()
    sys.path.insert(0, str(HERE))
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from pbench import cells, harness
    bench = cells.benchmark()
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}
    if args.workload not in chips:
        print(f"run.py: no cell {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("run.py: no CUDA device", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < chips[args.workload]:
        print(f"run.py: {args.workload} needs {chips[args.workload]} "
              f"devices, found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    cell = cells.load(args.workload)
    out = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                      T_START, bench)
    found = forbidden_modules()
    if found:
        print(f"run.py: loaded {found}, which the benchmark never may",
              file=sys.stderr)
        return 4
    line = out["line"]
    w = out["window"]
    print(f"run.py: {args.workload} seed {args.seed}: set-up "
          f"{w['setup_s']:.3f} s, {w['steps']} steps in "
          f"{w['window_s']:.3f} s, reference {w['reference_s']:.3f} s, "
          f"correct {out['correct']}", file=sys.stderr)
    ms = w["step_ms"]
    print(f"run.py: step ms: first {[round(v, 1) for v in ms[:8]]}, mean "
          f"{sum(ms) / len(ms):.2f}, last {[round(v, 1) for v in ms[-4:]]}",
          file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
