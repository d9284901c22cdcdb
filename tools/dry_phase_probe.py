"""chip_smoke.py phase 16 alone on the card, with phase 13 around 16(c)
and (d), and phase 13 once before 16(b)'s workers start, to show what
they cost its host timings.

1. Build the kernels; phase 13 (`tp_phase`: one spawn of 4 gloo ranks
   sharing cuda:0, with 16(c) and (d)) alone.
2. Start 16(b)'s worker processes (the production-mesh dry-run rows, each
   with --device cuda and --device cpu, at idle priority), then phase 13
   again beside them, as chip_smoke.py runs it: 16(c) runs 13(b)'s
   full-width runs on (pod 2, data 1, model 2), 16(d) llama3 smoke on
   (pod 2, data 2, model 1) against (data 4, model 1).
3. `dry_phase`: 16(a) (the dry run of phi4-mini full width on (1, 1), then
   the real step on the card under the same counter) and 16(b)'s rows.

The record goes to chiprun_out/probe16.json. Run from the repository
root: `python3 tools/dry_phase_probe.py`.
"""
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
import torch  # noqa: E402

import chip_smoke as C  # noqa: E402
from repro_torch.kernels import build  # noqa: E402


def main() -> int:
    t0 = time.perf_counter()
    print(f"card: {C.smi_line()}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"build: {build.build_all():.2f} s", flush=True)
    dev = torch.device("cuda", 0)
    t1 = time.perf_counter()
    alone, _, _ = C.tp_phase(dev)
    t2 = time.perf_counter()
    pool, futures = C.dry_rows_start()
    try:
        tp, launches, _ = C.tp_phase(dev)
        t3 = time.perf_counter()
        dry = C.dry_phase(dev, pool, futures)
    finally:
        pool.shutdown(wait=False, cancel_futures=True)
    t4 = time.perf_counter()
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "probe16.json").write_text(json.dumps({
        "dry": dry, "tp_launches": launches, "tp_alone": alone, "tp": tp,
        "seconds": {"phase13_alone": t2 - t1, "phase13": t3 - t2,
                    "phase16": t4 - t3, "total": t4 - t0}},
        indent=1, default=str))
    print(f"phase 13 (with 16(c), (d)) alone {t2 - t1:.1f} s, beside "
          f"16(b)'s workers {t3 - t2:.1f} s; phase 16 {t4 - t3:.1f} s, "
          f"total {t4 - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
