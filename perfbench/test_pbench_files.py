"""The benchmark's files: every cell, configuration, traffic mix and
metric that BENCHMARK.json names is found by name, the frozen counts
against hand-worked cases, the result line's keys, and the imports that
the benchmark may never make. CPU only."""
import ast
import importlib.util
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(ROOT / "src"))

from pbench import cells, harness, keys, peaks  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
# the plain reference and its draws: nothing of the program
REFERENCE = ("keys.py", "ref_common.py", "ref_dense.py", "ref_mamba2.py",
             "ref_step.py")


def _bench():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def _imports(path: Path):
    """Top-level module names a file imports (pbench's own resolved)."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.add(node.module.split(".")[0])
    return out


def test_every_cell_is_found_by_name():
    b = _bench()
    configs = {c["name"]: c for c in b["configs"]}
    for w in b["workloads"]:
        cell = cells.load(w["name"])
        wfile = json.loads((HERE / "workloads" / f"{w['name']}.json")
                           .read_text())
        assert (wfile["config"], wfile["traffic"]) == (w["config"],
                                                       w["traffic"])
        c = configs[w["config"]]
        assert ROOT / c["file"] == HERE / "configs" / f"{c['name']}.json"
        assert cell.config["reduced"] == c["reduced"]
        assert cell.config["name"] == c["name"]
        assert set(cell.limits) == {"loss", "grad_norm", "grad_diff",
                                    "change_norm"}
        assert all(isinstance(v, float) and v > 0
                   for v in cell.limits.values())
        assert cell.traffic["checked_steps"] >= 1
        assert w["chips"] == 1
    for m in b["end_to_end"] + b["per_layer"]:
        assert callable(cells.reader(m["name"]))


def test_metrics_of_filters_by_cell():
    b = _bench()
    e2e = {m["name"] for m in cells.metrics_of("phi4mini-topk1-layerwise",
                                               "end_to_end", b)}
    assert e2e == {"tokens_per_s", "peak_mem_gib", "setup_s"}
    per = {m["name"] for m in cells.metrics_of("phi4mini-topk1-layerwise",
                                               "per_layer", b)}
    assert "roofline.fields_pack" in per and \
        "roofline.qsgd_pack" not in per and "idle_share" in per
    for w in b["workloads"]:
        assert "setup_s" in {m["name"] for m in cells.metrics_of(
            w["name"], "end_to_end", b)}


def test_run_seconds_fits_the_check():
    b = _bench()
    s = b["run_seconds"]
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_flops_hand_arithmetic():
    c = cells.config("phi4-mini-3.8b-2l")
    d, ff, V, S = 3072, 8192, 200064, 4096
    layer = d * 3072 + 2 * d * 1024 + 3072 * d + 3 * d * ff
    attn = 2 * 2 * 2 * 3072 * (S + 1) / 2
    want = 6 * (2 * layer + d * V) + 3 * attn
    assert cells.family("dense").flops_per_token(c, S) == pytest.approx(
        want, rel=1e-12)
    assert want == pytest.approx(5.05e9, rel=5e-3)
    m = cells.config("mamba2-1.3b")
    d, L, di, N, nh, P, Q = 2048, 48, 4096, 128, 64, 64, 64
    mm = L * (d * (2 * di + 2 * N + nh) + di * d) + d * 50280
    ssd = L * ((Q + 1) * N + nh * (Q + 1) * P + nh * 4 * N * P)
    assert cells.family("mamba2").flops_per_token(m, 2048) == \
        pytest.approx(6 * mm + 3 * ssd, rel=1e-12)


def test_parameter_counts():
    for name, want in (("phi4-mini-3.8b-2l", 815_938_560),
                       ("mamba2-1.3b", 1_343_581_184)):
        c = cells.config(name)
        lv = cells.family(c["family"]).leaves(c)
        assert sum(math.prod(l.shape) for l in lv.values()) == want


def test_kernel_counts_hand_worked():
    # QSGD(16): 6-bit codes, d = 10 in bf16: 20 B read, 2 words + norm
    nb, iops, fops = peaks.kernel_work("qsgd_pack", [10], 1, 2, levels=16)
    assert (nb, iops, fops) == (20 + 8 + 4, 3 * 10 + 5 * 79, 7 * 10)
    nb, iops, fops = peaks.kernel_work("qsgd_unpack", [10], 2, 2, levels=16)
    assert (nb, iops, fops) == (2 * 32, 2 * 40, 2 * 20)
    # top-k(1%) of d = 1000: k = 10 indices of 10 bits, 4 words
    nb, iops, fops = peaks.kernel_work("fields_pack", [1000], 1, 2,
                                       ratio=0.01)
    assert (nb, iops, fops) == (40 + 16, 30, 0)
    assert peaks.qsgd_width(16) == 6 and peaks.qsgd_width(1) == 2
    assert peaks.index_width(1000) == 10 and peaks.index_width(1024) == 10
    t, bound = peaks.least_seconds("qsgd_pack", [1 << 20], 4, 2, levels=16)
    assert bound == "operations"
    t, bound = peaks.least_seconds("qsgd_unpack", [1 << 20], 4, 2,
                                   levels=16)
    assert bound == "bytes"
    assert t == pytest.approx(4 * (2 * (1 << 20) + 4 * 196608 + 4)
                              / peaks.HBM_BYTES_PER_S)


def test_frozen_draws_equal_the_programs():
    from repro_torch.kernels.prng import uniform_rows
    from repro_torch.random import fold_in
    k = keys.base_key(2**31 + 12345)
    assert torch.equal(keys.fold_in(k, 7), fold_in(k, 7))
    for d in (1, 2, 7, 1000):
        u = keys.unit_uniforms(keys.fold_in(k, d), d, "cpu")
        assert torch.equal(u, uniform_rows(keys.fold_in(k, d)[None], d)[0])


def test_end_to_end_readers():
    cell = cells.load("phi4mini-qsgd16-layerwise")
    win = {"steps": 10, "window_s": 2.0, "step_ms": [200.0] * 10}
    ctx = harness.Context(cell, win, 12.5, 3 * 2**30)
    assert cells.reader("tokens_per_s")(ctx) == 10 * 4 * 4096 / 2.0
    assert cells.reader("peak_mem_gib")(ctx) == 3.0
    assert cells.reader("setup_s")(ctx) == 12.5
    assert cells.reader("mfu")(ctx) == pytest.approx(
        100 * harness.flops_per_step(cell) / 0.2 / peaks.BF16_FLOPS_PER_S)


def test_idle_share_against_the_window_steps():
    cell = cells.load("phi4mini-qsgd16-layerwise")
    win = {"steps": 5, "window_s": 1.0, "step_ms": [190.0, 200.0, 200.0,
                                                   210.0, 400.0]}
    trace = {"busy_s": 0.45, "steps": 3, "window_s": 9.0}
    ctx = harness.Context(cell, win, 1.0, 1, trace=trace)
    # 150 ms busy a step against the median step of 200 ms
    assert cells.reader("idle_share")(ctx) == pytest.approx(25.0)


def test_line_keys_and_checks_last():
    line = harness.make_line(
        True, 10, 0, {"setup_s": {"value": 1.0, "unit": "s"}},
        {"platform": "gpu", "kind": "k", "count": 1,
         "memory_peak_bytes": 1}, {"loss": 1e-5}, {"loss": 1e-4},
        {"busy_s": 0.5, "window_s": 1.0, "device_ops": [["a", 0.1]],
         "idle_gaps": [["b", 0.2]]})
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "breakdown", "checks"]
    assert line["device"]["busy_s"] == 0.5
    assert line["checks"]["loss"] == {"value": 1e-5, "limit": 1e-4}
    json.dumps(line)


def test_no_forbidden_imports():
    files = sorted(HERE.rglob("*.py"))
    assert files
    for f in files:
        assert not _imports(f) & FORBIDDEN, f
    for name in REFERENCE:
        assert _imports(HERE / "pbench" / name) <= {
            "__future__", "math", "typing", "torch", "pbench"}, name


def test_forbidden_modules_compared_whole():
    spec = importlib.util.spec_from_file_location("pbench_run_py",
                                                  HERE / "run.py")
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    assert run.forbidden_modules({"repro_torch": 1, "repro_torch.x": 1,
                                  "torch": 1}) == []
    assert run.forbidden_modules({"repro.core": 1, "jaxlib": 1}) == [
        "jaxlib", "repro"]


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, str(HERE / "run.py"), "--workload",
         "phi4mini-qsgd16-layerwise", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=120,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout == ""
