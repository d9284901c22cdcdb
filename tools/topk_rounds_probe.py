"""Timing probe behind the design of the top-k kernel
(src/repro_torch/kernels/csrc/topk_mask.cu): each of its alternatives,
built from tools/topk_rounds_probe.cu, timed in turns with the shipped
kernel (`topk_mask_flat`) and, with --parent, the kernel of another
checkout of the port (its csrc/topk_mask.cu `topk_mask` entry point, the
(rows, 512) f32 interface before topk_mask_flat).

The alternatives: whole-row counts at every step (`list` 0) or the
shipped scheme's [lo, hi) list (`list` 1); L = 1, 2 or 3
bisection steps counted a pass (`L`); 2, 4 or 8 rows a block (`R`).
Inputs: Gaussian rows (chip_smoke.compress_inputs) at 237 (resnet9's flat
gradient) to 8,192 rows, and 2,048 sparse rows (chip_smoke.
topk_sparse_inputs: the shipped kernel's whole-row case), k = 5. Every
instance is first held bitwise against ref.topk_mask_ref on the special
rows at chip_smoke.TOPK_EDGE_KS and on every timed input. Times: chip_smoke
device_ms (CUDA-graph replay of 20 calls, median of 7), two repeats in
turns, the second in reverse order.

Run from the repository root on a machine with a card:
`python3 tools/topk_rounds_probe.py [--parent DIR] [--out PATH]`
(PATH defaults to chiprun_out/topk_rounds_probe.json). Exits 1 on a
mismatch, 2 without a card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

ROWS = (237, 528, 1056, 2048, 4096, 8192)
SPARSE_ROWS = 2048
K = 5
CHOICES = [(lst, L, R) for lst in (0, 1) for L in (1, 2, 3)
           for R in (2, 4, 8)]


def choice_name(lst, L, R) -> str:
    return f"{'list' if lst else 'whole'}_L{L}_R{R}"


def nvcc_build(src: Path, out: Path):
    """src compiled as the port's kernels are (build.NVCC_FLAGS) -> (the
    loaded library, nvcc's output)."""
    from repro_torch.kernels import build
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(out),
                           str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc {src} failed:\n{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(str(out)), proc.stdout + proc.stderr


def ptxas_summary(log: str) -> dict:
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
    spills = [(int(a), int(b)) for a, b in re.findall(
        r"(\d+) bytes spill stores, (\d+) bytes spill loads", log)]
    return {"functions": len(regs), "max_registers": max(regs, default=0),
            "spilled": sum(a + b for a, b in spills)}


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="another checkout of the port to time beside")
    ap.add_argument("--out", type=Path,
                    default=ROOT / "chiprun_out" / "topk_rounds_probe.json")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("topk_rounds_probe: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as C
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import topk_mask as Km
    from repro_torch.kernels.qsgd import _launch_args
    dev = torch.device("cuda", 0)
    card = C.smi_line()
    work = ROOT / "build" / "topk_rounds_probe"
    lib, log = nvcc_build(ROOT / "tools" / "topk_rounds_probe.cu",
                          work / "probe.so")
    lib.topk_probe.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    ptxas = {"probe": ptxas_summary(log)}
    parent = None
    if args.parent is not None:
        parent, plog = nvcc_build(
            args.parent / "src/repro_torch/kernels/csrc/topk_mask.cu",
            work / "parent.so")
        parent.topk_mask.argtypes = [ctypes.c_void_p] * 2 + [
            ctypes.c_int] * 3 + [ctypes.c_void_p]
        ptxas["parent"] = ptxas_summary(plog)

    def probe(x, k, lst, L, R):
        out = torch.empty_like(x)
        build.check(lib.topk_probe(x.data_ptr(), out.data_ptr(),
                                   x.shape[0], k, lst, L, R,
                                   *_launch_args(x.device)), "topk_probe")
        return out

    def parent_kernel(x, k):
        out = torch.empty_like(x)
        build.check(parent.topk_mask(x.data_ptr(), out.data_ptr(),
                                     x.shape[0], k, *_launch_args(x.device)),
                    "parent topk_mask")
        return out

    inputs = [(f"gauss_{r}", C.compress_inputs((r, 512), 1300 + i, dev))
              for i, r in enumerate(ROWS)]
    inputs.append((f"sparse_{SPARSE_ROWS}", C.topk_sparse_inputs(
        SPARSE_ROWS, 1310, dev).reshape(SPARSE_ROWS, 512)))
    cases = [(x, K) for _, x in inputs]
    cases += [(C.topk_special_rows(dev), k) for k in C.TOPK_EDGE_KS]
    fails = []
    for x, k in cases:
        want = ref.topk_mask_ref(x, k)
        for c in CHOICES:
            if not C.bitwise_equal(probe(x, k, *c), want):
                fails.append(f"{choice_name(*c)} {tuple(x.shape)} k {k}")
        if parent is not None and not C.bitwise_equal(parent_kernel(x, k),
                                                      want):
            fails.append(f"parent {tuple(x.shape)} k {k}")
    print(card, torch.__version__, torch.version.cuda, flush=True)
    print(f"ptxas {ptxas}; checks: {len(cases)} inputs x "
          f"{len(CHOICES) + 1 + (parent is not None)} kernels, "
          f"{len(fails)} mismatches {fails[:8]}", flush=True)
    if fails:
        return 1
    rows = []
    for name, x in inputs:
        flat = x.reshape(-1)
        timed = {"kernel": lambda: Km.topk_mask_flat(flat, K)}
        if parent is not None:
            timed["parent"] = lambda: parent_kernel(x, K)
        for c in CHOICES:
            timed[choice_name(*c)] = lambda c=c: probe(x, K, *c)
        ms = {n: [] for n in timed}
        for rep in range(2):
            for n in (list(timed) if rep == 0 else list(timed)[::-1]):
                ms[n].append(C.device_ms(timed[n]))
        best = min(min(v) for n, v in ms.items() if n != "parent")
        rows.append({"input": name, "rows": x.shape[0], "k": K, "ms": ms,
                     "best_ms": best})
        print(name, " ".join(f"{n}={v[0]:.6f}/{v[1]:.6f}"
                             for n, v in ms.items()), f"best={best:.6f}",
              flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"card": card, "ptxas": ptxas,
                                    "rows": rows}, indent=1))
    print(json.dumps({"ok": True, "card": card, "out": str(args.out)}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
