"""The dry run's full grid, `python -m repro_torch.launch.dryrun --arch all
--shape all --mesh both`, a row a process, as many processes at a time as
the host has cores: a dry run is host work on meta tensors, so the grid's
wall time is the host cores' to split.

Each (arch, shape, mesh) row runs `python -m repro_torch.launch.dryrun
--arch A --shape S --mesh single|multi` with the defaults (top-k(1%)
layerwise; `--device cuda`, the visible card's name and memory), its
output under chiprun_out/grid/<arch>__<shape>__<mesh>/. Prints each row's
[ok] / [skip] / [FAIL] line, the `N ok / M failed` summary over the grid
and its wall seconds, and writes chiprun_out/grid/summary.json (every row)
and grid.json (the wall seconds, the card from nvidia-smi, the failures).

Run from the repository root: `python3 tools/dryrun_grid.py`.
"""
import json
import os
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
OUT = ROOT / "chiprun_out" / "grid"
JOBS = os.cpu_count() or 8


def smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def _weight(arch, shape, mesh) -> float:
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    kind = {"train_4k": 2.0 * max(1, cfg.train_microbatch),
            "prefill_32k": 1.0}.get(shape, 0.01)
    return cfg.n_layers * kind * (1.0 if mesh == "single" else 0.9)


def run_row(job):
    arch, shape, mesh = job
    out = OUT / f"{arch}__{shape}__{mesh}"
    shutil.rmtree(out, ignore_errors=True)     # summary.json is appended to
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    p = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--mesh", mesh, "--out", str(out)],
        capture_output=True, text=True, env=env, cwd=str(ROOT))
    secs = time.perf_counter() - t0
    (out.parent / f"{out.name}.log").write_text(p.stdout + p.stderr)
    rows = (json.loads((out / "summary.json").read_text())
            if (out / "summary.json").exists() else [])
    lines = [ln for ln in p.stdout.splitlines()
             if ln.startswith(("[ok]", "[skip]", "[FAIL]"))]
    return job, p.returncode, rows, lines, secs


def main() -> int:
    from repro_torch.configs.registry import ARCH_NAMES
    from repro_torch.models.config import INPUT_SHAPES
    OUT.mkdir(parents=True, exist_ok=True)
    card = smi()
    print(f"card: {card}", flush=True)
    jobs = [(a, s, m) for a in ARCH_NAMES for s in INPUT_SHAPES
            for m in ("single", "multi")]
    # the longest rows first: layers x microbatches a train step, layers a
    # prefill, decode rows last
    jobs.sort(key=lambda j: -_weight(*j))
    t0 = time.perf_counter()
    results = []
    with ThreadPoolExecutor(JOBS) as pool:
        for job, rc, rows, lines, secs in pool.map(run_row, jobs):
            for ln in lines:
                print(f"{ln} ({secs:.0f} s of process)", flush=True)
            results.append({"job": job, "rc": rc, "rows": rows,
                            "seconds": secs})
    wall = time.perf_counter() - t0
    rows = [r for res in results for r in res["rows"]]
    failed = [res["job"] for res in results if res["rc"] != 0]
    (OUT / "summary.json").write_text(json.dumps(rows, indent=1))
    (OUT / "grid.json").write_text(json.dumps({
        "card": card, "wall_seconds": wall, "jobs": JOBS,
        "failed": failed, "process_seconds": {
            "__".join(r["job"]): r["seconds"] for r in results}}, indent=1))
    print(f"\n{len(rows)} ok / {len(failed)} failed; wall {wall:.1f} s with "
          f"{JOBS} processes", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
