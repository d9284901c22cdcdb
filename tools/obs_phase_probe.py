"""chip_smoke.py phase 14 alone on the card: build the kernels, run 14(c)
(measure_stream / measure_collective) in a spawn of 4 gloo ranks sharing
cuda:0, then `obs_phase` ((a) the traced phi4-mini Engine, (b) calibrate,
(d) both CLIs); its record goes to chiprun_out/probe14.json.

Run from the repository root: `python3 tools/obs_phase_probe.py`.
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
from repro_torch.launch.mesh import run_ranks  # noqa: E402

if __name__ == "__main__":
    t0 = time.perf_counter()
    print(C.smi_line(), flush=True)
    print(f"build {build.build_all():.1f} s", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t1 = time.perf_counter()
    streams = run_ranks(C.obs_stream_ranks, C.RANKS, backend="gloo",
                        device="cuda", timeout=C.RANK_TIMEOUT)
    print(f"14(c) spawn {time.perf_counter() - t1:.1f} s", flush=True)
    rec, launches = C.obs_phase(torch.device("cuda", 0), streams)
    print("launches", {k: v for k, v in launches.items() if v}, flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "probe14.json").write_text(json.dumps(rec, indent=1,
                                                 default=str))
    print(f"total {time.perf_counter() - t0:.1f} s", flush=True)
