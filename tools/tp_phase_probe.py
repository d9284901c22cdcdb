"""chip_smoke.py phase 13 alone on the card: build the kernels, then
`tp_phase` (tensor, sequence and FSDP parallelism on 4 gloo ranks sharing
cuda:0); its record goes to chiprun_out/probe13.json.

Run from the repository root: `python3 tools/tp_phase_probe.py`.
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

if __name__ == "__main__":
    t0 = time.perf_counter()
    print(C.smi_line(), flush=True)
    print(f"build {build.build_all():.1f} s", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rec, launches, errs = C.tp_phase(torch.device("cuda", 0))
    print("launches", {k: v for k, v in launches.items() if v}, flush=True)
    print("errs", errs, flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "probe13.json").write_text(json.dumps(rec, indent=1,
                                                 default=str))
    print(f"total {time.perf_counter() - t0:.1f} s", flush=True)
