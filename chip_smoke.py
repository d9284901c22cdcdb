#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (sm_90a).

Drives the port's main path — the paper's Algorithm 1 on resnet9
(repro_torch.experiment.train_cnn, 4 simulated workers, real wire
payloads of QSGD, TernGrad, signSGD, natural compression, top-k and
random-k) — and holds every hand-written kernel against its plain
PyTorch version on the card. Phases, each failing the run at its first
error:

  1. the card's name and power limit (nvidia-smi); TF32 off
  2. build the CUDA kernels from src/repro_torch/kernels/csrc (nvcc)
  3. each kernel vs its plain version, bitwise, at every resnet9 bucket
     shape stacked over 4 workers, the entire-model shape (4, 121002) and
     a stress shape (4, 1048579): QSGD widths 2/4/6/8, TernGrad, sign,
     and fields at widths 1/4/9/13/16/17/24/31 (k = d) plus each shape's
     top-k index leg (k = 1% of d, ceil(log2 d) bits)
  4. the main path: train_cnn on resnet9 with QSGD(16) layerwise and
     entire_model, TernGrad, signSGD, natural, top-k(1%) and random-k(1%)
     layerwise, top-k entire_model, and adaptive threshold layerwise (the
     sim path: no launches); launch counters reset before and read after
     each run and held to exact per-step counts; the wire buffers of one
     step built with the kernels equal those built with the plain
     versions (QSGD / TernGrad on the card's own statistics; signSGD,
     natural and top-k against the whole path run on the CPU); one
     error-feedback aggregation each for QSGD and top-k through the
     kernels equals the sim path
  5. timings of each kernel and its plain version at the main-path shapes
     and the stress shape, beside the byte and operation bounds: device
     time from CUDA-event timed replays of a CUDA graph of 20 calls
     (`ms`, `plain_ms`), and the per-call time of the same calls issued
     back to back from Python (`call_ms`, host enqueue included)
  6. torch.profiler over five main-path steps each of QSGD(16) and
     top-k(1%) layerwise: wall and device-busy time per step, the
     device's idle share and the top device ops

Run from the repository root: `python3 chip_smoke.py` (no arguments, one
card). Details go to chiprun_out/chip_smoke.json. The last line is
{"ok": true, "device": {...}}; the line before it the kernel table.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

STEPS = 20
WORKERS = 4
STRESS = (4, 1048579)
QSGD_WIDTHS = ((2, 1), (4, 4), (6, 16), (8, 64))
MAIN_LEVELS, MAIN_WIDTH = 16, 6
FIELD_WIDTHS = (1, 4, 9, 13, 16, 17, 24, 31)
NATURAL_WIDTH = 9
SPARSE_RATIO = 0.01

# H100 SXM peaks (NVIDIA data sheet / Hopper whitepaper, at 700 W)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# 132 SMs x 64 INT32 lanes x 1.98 GHz boost (derived from the whitepaper)
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# integer ops of one threefry2x32 hash: 20 rounds of add/rotate/xor plus
# 5 key injections of 3 adds and the 2 initial adds and the parity xor
THREEFRY_INT_OPS = 20 * 3 + 5 * 3 + 2 + 2
# (int32, fp32) operations per element beyond the hash. Pack: QSGD
# abs/div/mul/floor/sub/compare/add, TernGrad abs/div/compare, sign one
# compare (fp); code select + shift/or into a word (int; the sign word is
# one ballot). Unpack: word index, shift(s), or, mask (int), and for QSGD /
# TernGrad the int->float convert and multiply (fp); sign: shift, mask,
# select.
ELEMENT_OPS = {"qsgd_pack": (3, 7), "terngrad_pack": (3, 3),
               "sign_pack": (1, 1), "fields_pack": (3, 0),
               "qsgd_unpack": (4, 2), "terngrad_unpack": (4, 2),
               "sign_unpack": (3, 0), "fields_unpack": (4, 0)}
HASHING = ("qsgd_pack", "terngrad_pack")


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def max_abs_err(a, b) -> float:
    """Largest |a - b| (words compared as integers, floats as values)."""
    import torch
    return float((a.to(torch.float64) - b.to(torch.float64)).abs().max())


def bitwise_equal(a, b) -> bool:
    import torch
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return bool(torch.equal(a, b))


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


# ---- inputs -----------------------------------------------------------------

def bucket_shapes():
    """resnet9 layerwise bucket shapes stacked over the workers, and the
    entire-model shape: what the main path hands the kernels."""
    from repro_torch.configs.resnet9_cifar import RESNET9
    from repro_torch.core.granularity import Granularity, stacked_mask
    from repro_torch.core.plan import build_plan
    from repro_torch.models.cnn import init_cnn
    from repro_torch.random import key
    p = init_cnn(RESNET9, key(0), device="cpu")
    plan = build_plan(p, stacked_mask(p), Granularity("layerwise"))
    check(plan.num_units == 14 and plan.num_dispatches == 11,
          f"resnet9 plan {plan.summary()}")
    return [(WORKERS * b.n, b.dim) for b in plan.buckets], (WORKERS,
                                                            plan.total)


def make_inputs(shape, seed, dev):
    """Seeded (n, d) f32 units (every 7th entry 0, for sign(0) codes) and
    the two int32 key-word columns, on the card."""
    import torch
    from repro_torch.kernels.ref import words_to_i32
    g = torch.Generator().manual_seed(seed)
    n, d = shape
    x = torch.randn((n, d), generator=g)
    x[:, ::7] = 0.0
    x = x.to(dev)
    keys = torch.randint(0, 2**32, (n, 2), generator=g, dtype=torch.int64)
    kw = words_to_i32(keys).to(dev)
    return x, kw[:, 0].contiguous(), kw[:, 1].contiguous()


def make_fields(shape, bound, seed, dev):
    """Seeded (n, k) int32 fields in [0, bound), on the card."""
    import torch
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, bound, shape, generator=g,
                         dtype=torch.int64).to(torch.int32).to(dev)


def make_words(n, wpu, seed, dev):
    """Seeded (n, wpu) int32 words with every bit pattern possible."""
    import torch
    g = torch.Generator().manual_seed(seed)
    return torch.randint(-2**31, 2**31, (n, wpu), generator=g,
                         dtype=torch.int64).to(torch.int32).to(dev)


def index_leg(d: int):
    """(k, width) of a top-k / random-k index leg at SPARSE_RATIO."""
    from repro_torch.core.compressors import _k_of, index_bits
    return _k_of(SPARSE_RATIO, d), index_bits(d)


# ---- phase 3: kernels vs plain versions ------------------------------------

def check_kernels(shapes, dev):
    """Every kernel vs its plain version, bitwise -> max |err| per kernel."""
    import torch
    from repro_torch.kernels import pack as P
    from repro_torch.kernels import qsgd as Q
    from repro_torch.kernels import sign as S
    from repro_torch.kernels import terngrad as T
    from repro_torch.kernels.ref import words_per_unit
    err = {k: 0.0 for k in SOURCES}

    def same(name, got, want, what):
        err[name] = max(err[name], max_abs_err(got, want))
        check(bitwise_equal(got, want), f"{name} {what}")

    for si, shape in enumerate(shapes):
        x, k0, k1 = make_inputs(shape, 100 + si, dev)
        d = shape[1]
        nrm = torch.linalg.vector_norm(x, dim=1) + 1e-12
        for width, levels in QSGD_WIDTHS:
            w = Q.qsgd_pack(x, k0, k1, nrm, levels, width)
            same("qsgd_pack", w,
                 Q.qsgd_pack_plain(x, k0, k1, nrm, levels, width),
                 f"{shape} w{width}")
            fac = nrm / levels
            same("qsgd_unpack", Q.qsgd_unpack(w, fac, d, levels, width),
                 Q.qsgd_unpack_plain(w, fac, d, levels, width),
                 f"{shape} w{width}")
        sc = x.abs().amax(dim=1) + 1e-12
        w = T.terngrad_pack(x, k0, k1, sc)
        same("terngrad_pack", w, T.terngrad_pack_plain(x, k0, k1, sc),
             str(shape))
        same("terngrad_unpack", T.terngrad_unpack(w, sc, d),
             T.terngrad_unpack_plain(w, sc, d), str(shape))
        n = shape[0]
        xs = x.clone()
        xs[:, 3::11] = -0.0
        xs[0, min(5, d - 1)] = float("nan")
        w = S.sign_pack(xs)
        same("sign_pack", w, S.sign_pack_plain(xs), str(shape))
        check(bitwise_equal(S.sign_unpack(w, d),
                            torch.where(xs >= 0, 1.0, -1.0)),
              f"sign round trip {shape}")
        w = make_words(n, words_per_unit(d, 1), 200 + si, dev)
        same("sign_unpack", S.sign_unpack(w, d), S.sign_unpack_plain(w, d),
             str(shape))
        k_idx, w_idx = index_leg(d)
        legs = ([(width, d, 2**width) for width in FIELD_WIDTHS]
                + [(w_idx, k_idx, d)])           # index leg: indices < d
        for li, (width, k, bound) in enumerate(legs):
            f = make_fields((n, k), bound, 300 + 16 * si + li, dev)
            w = P.fields_pack(f, width)
            same("fields_pack", w, P.fields_pack_plain(f, width),
                 f"{(n, k)} w{width}")
            check(bitwise_equal(P.fields_unpack(w, k, width), f),
                  f"fields round trip {(n, k)} w{width}")
            w = make_words(n, words_per_unit(k, width), 400 + li, dev)
            same("fields_unpack", P.fields_unpack(w, k, width),
                 P.fields_unpack_plain(w, k, width), f"{(n, k)} w{width}")
    torch.cuda.synchronize()
    return err


# ---- phase 4: the main path -------------------------------------------------

def main_path_runs(dev):
    """train_cnn runs, each held to exact launch counts: per step, one pack
    and one unpack launch of the codec's kernel family per bucket (11
    layerwise, 1 entire-model), none of any other kernel, and none at all
    for adaptive threshold (its records are not sim-exact, so train_step
    takes the sim path, as the reference's train_cnn always does)."""
    from repro_torch import kernels
    from repro_torch.core.aggregation import CompressionConfig
    from repro_torch.core.compressors import (QSGD, AdaptiveThreshold,
                                              NaturalCompression, RandomK,
                                              SignSGD, TernGrad, TopK)
    from repro_torch.core.granularity import Granularity
    from repro_torch.experiment import train_cnn
    import torch
    topk = TopK(ratio=SPARSE_RATIO)
    runs = [("qsgd16_layerwise", QSGD(levels=MAIN_LEVELS), "layerwise",
             "qsgd", 11),
            ("qsgd16_entire_model", QSGD(levels=MAIN_LEVELS), "entire_model",
             "qsgd", 1),
            ("terngrad_layerwise", TernGrad(), "layerwise", "terngrad", 11),
            ("signsgd_layerwise", SignSGD(), "layerwise", "sign", 11),
            ("natural_layerwise", NaturalCompression(), "layerwise",
             "fields", 11),
            ("topk1_layerwise", topk, "layerwise", "fields", 11),
            ("randomk1_layerwise", RandomK(ratio=SPARSE_RATIO), "layerwise",
             "fields", 11),
            ("topk1_entire_model", topk, "entire_model", "fields", 1),
            ("adaptive_threshold_layerwise", AdaptiveThreshold(),
             "layerwise", None, 0)]
    out = []
    for name, comp, gran, fam, per_step in runs:
        cfg = CompressionConfig(qw=comp, granularity=Granularity(gran))
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        acc, loss = train_cnn("resnet9", cfg, steps=STEPS, device=dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = kernels.launch_counts()
        want = {k: (per_step * STEPS if k.split("_")[0] == fam else 0)
                for k in counts}
        check(counts == want, f"{name}: launches {counts} != {want}")
        check(math.isfinite(loss) and math.isfinite(acc),
              f"{name}: test loss {loss} / accuracy {acc}")
        print(f"main path {name}: {STEPS} steps in {secs:.3f} s, test "
              f"loss {loss:.6f}, test accuracy {acc:.4f}, launches {counts}",
              flush=True)
        out.append({"run": name, "steps": STEPS, "seconds": secs,
                    "test_loss": loss, "test_accuracy": acc,
                    "launches": counts})
    return out


def check_step_buffers(dev):
    """One resnet9 step's real wire buffers, built through the kernels,
    against buffers assembled from the plain versions on the same worker
    gradients, norms and keys; then one EF aggregation through the kernels
    against the sim path."""
    import torch
    from repro_torch import random as R
    from repro_torch.configs.resnet9_cifar import RESNET9
    from repro_torch.convert import tree_map
    from repro_torch.core import wire
    from repro_torch.core.aggregation import (CompressionConfig,
                                              aggregate_simulated_workers)
    from repro_torch.core.compressors import (QSGD, NaturalCompression,
                                              SignSGD, TernGrad, TopK)
    from repro_torch.core.granularity import Granularity, stacked_mask
    from repro_torch.core.plan import build_plan
    from repro_torch.core.schedule import build_schedule
    from repro_torch.data.synthetic import classification_batch
    from repro_torch.experiment import worker_grads
    from repro_torch.kernels import qsgd as Q
    from repro_torch.kernels import terngrad as T
    from repro_torch.kernels.ref import words_to_i32
    from repro_torch.models.cnn import init_cnn
    key = R.key(0)
    params = init_cnn(RESNET9, key, device=dev)
    batch = classification_batch(R.fold_in(key, 0), 64, device=dev)
    wg, _ = worker_grads(RESNET9, params, batch, WORKERS)
    wkeys = R.fold_in(key[None], torch.arange(WORKERS))
    n_msgs = 0
    for comp, gran in ((QSGD(levels=MAIN_LEVELS), "layerwise"),
                       (QSGD(levels=MAIN_LEVELS), "entire_model"),
                       (TernGrad(), "layerwise")):
        codec = wire.wire_codec(comp)
        plan = build_plan(params, stacked_mask(params), Granularity(gran))
        sched = build_schedule(plan, 0.0)
        _, bufs = wire.execute_schedule_wire(sched, codec, wg, wkeys)
        leaves, _ = plan._inputs(wg, wkeys)
        flat = plan._flat(leaves) if plan.needs_flat else None
        keys = plan._keys(wkeys, dev)
        for msg, layout, buf in zip(sched.messages,
                                    wire.message_layouts(sched, codec), bufs):
            rows = []
            for bi in msg.bucket_ids:
                b = plan.buckets[bi]
                x = plan._gather_runs(leaves, flat, b).contiguous()
                kw = words_to_i32(plan._bucket_keys(keys, b))
                k0, k1 = kw[:, 0].contiguous(), kw[:, 1].contiguous()
                if isinstance(comp, QSGD):
                    stat = torch.linalg.vector_norm(x, dim=1) + 1e-12
                    words = Q.qsgd_pack_plain(x, k0, k1, stat, comp.levels,
                                              comp.entry_bits)
                else:
                    stat = x.abs().amax(dim=1) + 1e-12
                    words = T.terngrad_pack_plain(x, k0, k1, stat)
                rows.append(torch.cat([stat[:, None].view(torch.uint8),
                                       words.view(torch.uint8)], dim=1)
                            .reshape(WORKERS, -1))
            want = wire._message_buffer(layout, rows)
            check(bitwise_equal(buf, want),
                  f"{comp.name} {gran}: message buffer != plain build")
            n_msgs += 1
    # no statistic enters these codecs, so the whole path run on the CPU
    # (plain versions) must give the card's bytes
    wg_cpu = tree_map(lambda g: g.cpu(), wg)
    for comp, gran in ((SignSGD(), "layerwise"),
                       (NaturalCompression(), "layerwise"),
                       (TopK(ratio=SPARSE_RATIO), "layerwise"),
                       (TopK(ratio=SPARSE_RATIO), "entire_model")):
        codec = wire.wire_codec(comp)
        plan = build_plan(params, stacked_mask(params), Granularity(gran))
        sched = build_schedule(plan, 0.0)
        _, bufs = wire.execute_schedule_wire(sched, codec, wg, wkeys)
        _, cpu_bufs = wire.execute_schedule_wire(sched, codec, wg_cpu, wkeys)
        for buf, want in zip(bufs, cpu_bufs):
            check(bitwise_equal(buf.cpu(), want),
                  f"{comp.name} {gran}: message buffer != CPU build")
            n_msgs += 1
    m0 = tree_map(lambda g: 0.01 * g, wg)
    sm = stacked_mask(params)
    for comp in (QSGD(levels=MAIN_LEVELS), TopK(ratio=SPARSE_RATIO)):
        cfg = CompressionConfig(qw=comp, granularity=Granularity("layerwise"),
                                error_feedback=True)
        a, am = aggregate_simulated_workers(wg, sm, cfg, key, ef_state=m0,
                                            wire=True)
        b, bm = aggregate_simulated_workers(wg, sm, cfg, key, ef_state=m0,
                                            wire=False)
        for k in a:
            check(bitwise_equal(a[k], b[k]) and bitwise_equal(am[k], bm[k]),
                  f"{comp.name} EF aggregation wire != sim at {k}")
    torch.cuda.synchronize()
    return n_msgs


# ---- phase 5: timing ---------------------------------------------------------

def _median_event_ms(run, count, repeats):
    import torch
    vals = []
    for _ in range(repeats):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        run()
        b.record()
        b.synchronize()
        vals.append(a.elapsed_time(b) / count)
    vals.sort()
    return vals[len(vals) // 2]


def call_ms(fn, reps=20, repeats=7) -> float:
    """Per call, in ms: median over `repeats` of the CUDA-event time of
    `reps` back-to-back calls issued from Python (what the main path pays:
    includes the host enqueue when a launch is shorter than it)."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(reps):
            fn()
    return _median_event_ms(run, reps, repeats)


def device_ms(fn, reps=20, repeats=7) -> float:
    """Per call, in ms: the same calls captured into one CUDA graph and
    replayed, so the time is the device's alone (no host gaps)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return _median_event_ms(graph.replay, reps, repeats)


def bounds(kernel: str, n: int, d: int, width: int):
    """(bytes moved, int ops, fp ops, byte-bound ms, op-bound ms) of one
    launch over n units of d elements (fields: d fields per unit): each
    input read once and each output written once over the HBM rate; the
    integer and fp32 operations over their peak rates."""
    from repro_torch.kernels import ops
    fam, kind = kernel.split("_")
    moved = ops.pack_bytes_moved if kind == "pack" else ops.unpack_bytes_moved
    mv = moved(n, d, width, fam)
    per_int, per_fp = ELEMENT_OPS[kernel]
    int_ops = n * d * per_int
    if kernel in HASHING:
        int_ops += n * -(-d // 2) * THREEFRY_INT_OPS
    fp_ops = n * d * per_fp
    nbytes = mv["read"] + mv["write"]
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (int_ops / INT32_OPS_PER_S + fp_ops / FP32_OPS_PER_S) * 1e3
    return nbytes, int_ops, fp_ops, t_bytes, t_ops


def time_kernels(layer_shapes, em_shape, dev):
    """Rows of device / call / plain times beside the bounds, per kernel,
    shape group and leg: the fields kernels are timed on natural's 9-bit
    code leg (k = d) and on the top-k index leg (k = 1% of d)."""
    import torch
    from repro_torch.kernels import pack as P
    from repro_torch.kernels import qsgd as Q
    from repro_torch.kernels import sign as S
    from repro_torch.kernels import terngrad as T
    rows = []
    groups = {"layerwise_step": layer_shapes, "entire_model_step": [em_shape],
              "stress": [STRESS]}
    for group, shapes in groups.items():
        for si, shape in enumerate(shapes):
            n, d = shape
            x, k0, k1 = make_inputs(shape, 500 + si, dev)
            nrm = torch.linalg.vector_norm(x, dim=1) + 1e-12
            fac = nrm / MAIN_LEVELS
            sc = x.abs().amax(dim=1) + 1e-12
            wq = Q.qsgd_pack(x, k0, k1, nrm, MAIN_LEVELS, MAIN_WIDTH)
            wt = T.terngrad_pack(x, k0, k1, sc)
            ws = S.sign_pack(x)
            k_idx, w_idx = index_leg(d)
            fn = make_fields((n, d), 2**NATURAL_WIDTH, 600 + si, dev)
            fi = make_fields((n, k_idx), d, 700 + si, dev)
            wn = P.fields_pack(fn, NATURAL_WIDTH)
            wi = P.fields_pack(fi, w_idx)
            cases = [
                ("qsgd_pack", "", d, MAIN_WIDTH,
                 lambda: Q.qsgd_pack(x, k0, k1, nrm, MAIN_LEVELS, MAIN_WIDTH),
                 lambda: Q.qsgd_pack_plain(x, k0, k1, nrm, MAIN_LEVELS,
                                           MAIN_WIDTH)),
                ("qsgd_unpack", "", d, MAIN_WIDTH,
                 lambda: Q.qsgd_unpack(wq, fac, d, MAIN_LEVELS, MAIN_WIDTH),
                 lambda: Q.qsgd_unpack_plain(wq, fac, d, MAIN_LEVELS,
                                             MAIN_WIDTH)),
                ("terngrad_pack", "", d, 2,
                 lambda: T.terngrad_pack(x, k0, k1, sc),
                 lambda: T.terngrad_pack_plain(x, k0, k1, sc)),
                ("terngrad_unpack", "", d, 2,
                 lambda: T.terngrad_unpack(wt, sc, d),
                 lambda: T.terngrad_unpack_plain(wt, sc, d)),
                ("sign_pack", "", d, 1, lambda: S.sign_pack(x),
                 lambda: S.sign_pack_plain(x)),
                ("sign_unpack", "", d, 1, lambda: S.sign_unpack(ws, d),
                 lambda: S.sign_unpack_plain(ws, d)),
                ("fields_pack", "natural", d, NATURAL_WIDTH,
                 lambda: P.fields_pack(fn, NATURAL_WIDTH),
                 lambda: P.fields_pack_plain(fn, NATURAL_WIDTH)),
                ("fields_unpack", "natural", d, NATURAL_WIDTH,
                 lambda: P.fields_unpack(wn, d, NATURAL_WIDTH),
                 lambda: P.fields_unpack_plain(wn, d, NATURAL_WIDTH)),
                ("fields_pack", "index", k_idx, w_idx,
                 lambda: P.fields_pack(fi, w_idx),
                 lambda: P.fields_pack_plain(fi, w_idx)),
                ("fields_unpack", "index", k_idx, w_idx,
                 lambda: P.fields_unpack(wi, k_idx, w_idx),
                 lambda: P.fields_unpack_plain(wi, k_idx, w_idx)),
            ]
            for name, leg, k, width, kern, plain in cases:
                nbytes, iops, fops, t_b, t_o = bounds(name, n, k, width)
                rows.append({
                    "group": group, "kernel": name, "leg": leg,
                    "shape": [n, k], "width": width, "ms": device_ms(kern),
                    "call_ms": call_ms(kern),
                    "plain_ms": device_ms(plain, reps=3, repeats=3),
                    "bytes": nbytes, "int_ops": iops, "fp_ops": fops,
                    "bytes_ms": t_b, "ops_ms": t_o, "bound_ms": max(t_b, t_o),
                    "bound_by": "bytes" if t_b >= t_o else "operations"})
    return rows


def profile_steps(dev, qw, steps=5):
    """torch.profiler over `steps` layerwise train steps with worker
    compressor `qw` on resnet9 (after 2 warm-up steps): wall time, device
    busy time (sum of the device events, one stream), idle share and the
    top device ops."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import random as R
    from repro_torch.configs.resnet9_cifar import RESNET9
    from repro_torch.convert import tree_map
    from repro_torch.core.aggregation import CompressionConfig
    from repro_torch.data.synthetic import classification_batch
    from repro_torch.experiment import train_step
    from repro_torch.models.cnn import init_cnn
    key = R.key(1)
    params = init_cnn(RESNET9, key, device=dev)
    vel = tree_map(torch.zeros_like, params)
    comp = CompressionConfig(qw=qw)
    batches = [classification_batch(R.fold_in(key, i), 64, device=dev)
               for i in range(steps + 2)]
    lr = torch.tensor(0.01, device=dev)

    def step(i):
        nonlocal params, vel
        params, vel, _ = train_step(RESNET9, comp, params, vel, batches[i],
                                    R.fold_in(key, 10_000 + i), lr)
    for i in range(2):
        step(i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(2, steps + 2):
            step(i)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3)
    busy_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"compressor": qw.name, "steps": steps,
            "wall_ms_per_step": wall_ms / steps,
            "device_busy_ms_per_step": busy_ms / steps,
            "idle_share": (1.0 - busy_ms / wall_ms) if busy_ms else None,
            "device_events": sum(1 for e in prof.events()
                                 if e.device_type == DeviceType.CUDA),
            "top_device_ms_per_step": [(n[:80], t / steps) for n, t in top]}


SOURCES = {
    "qsgd_pack": ("src/repro_torch/kernels/csrc/qsgd.cu",
                  "src/repro/kernels/qsgd.py:122"),
    "qsgd_unpack": ("src/repro_torch/kernels/csrc/qsgd.cu",
                    "src/repro/kernels/qsgd.py:151"),
    "terngrad_pack": ("src/repro_torch/kernels/csrc/terngrad.cu",
                      "src/repro/kernels/terngrad.py:92"),
    "terngrad_unpack": ("src/repro_torch/kernels/csrc/terngrad.cu",
                        "src/repro/kernels/terngrad.py:118"),
    "sign_pack": ("src/repro_torch/kernels/csrc/sign.cu",
                  "src/repro/kernels/sign.py:49"),
    "sign_unpack": ("src/repro_torch/kernels/csrc/sign.cu",
                    "src/repro/kernels/sign.py:67"),
    "fields_pack": ("src/repro_torch/kernels/csrc/pack.cu",
                    "src/repro/kernels/pack.py:94"),
    "fields_unpack": ("src/repro_torch/kernels/csrc/pack.cu",
                      "src/repro/kernels/pack.py:111"),
}


def kernel_line(timings, runs, errs):
    """The per-kernel summary: device ms / plain_ms / bound_ms summed over
    one layerwise main-path step (the 11 resnet9 buckets x 4 workers; the
    fields kernels on natural compression's 9-bit code leg); launches
    summed over the main-path runs."""
    out = []
    for name, (src, replaces) in SOURCES.items():
        step = [r for r in timings
                if r["kernel"] == name and r["group"] == "layerwise_step"
                and r["leg"] in ("", "natural")]
        tot = {k: sum(r[k] for r in step)
               for k in ("ms", "plain_ms", "bound_ms", "bytes_ms", "ops_ms")}
        out.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": sum(r["launches"][name] for r in runs),
            "max_abs_err": errs[name], "ms": tot["ms"],
            "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
            "bound_by": ("bytes" if tot["bytes_ms"] >= tot["ops_ms"]
                         else "operations"),
            "library_ms": None})
    return {"kernels": out}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this script needs the "
              "card", file=sys.stderr)
        return 2
    try:
        from repro_torch.kernels import build
    except ImportError as e:
        print(f"chip_smoke: the port's package is missing ({e}); run from "
              f"the repository root", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    card = smi_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    secs = build.build_all()
    print(f"build: {secs:.2f} s into {build.build_dir()}", flush=True)
    for src, log in build.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {src}: {line.strip()}", flush=True)

    layer_shapes, em_shape = bucket_shapes()
    shapes = layer_shapes + [em_shape, STRESS]
    errs = check_kernels(shapes, dev)
    print(f"kernels vs plain: bitwise equal over {len(shapes)} shapes "
          f"(QSGD widths {[w for w, _ in QSGD_WIDTHS]}, TernGrad, sign, "
          f"fields widths {list(FIELD_WIDTHS)} and the top-k index legs); "
          f"max abs err {errs}", flush=True)

    runs = main_path_runs(dev)
    n_msgs = check_step_buffers(dev)
    print(f"one-step wire buffers: {n_msgs} messages equal the plain build; "
          f"EF aggregation (QSGD, top-k) through the kernels equals the sim "
          f"path", flush=True)

    timings = time_kernels(layer_shapes, em_shape, dev)
    for r in timings:
        print(f"  {r['group']:17s} {r['kernel']:15s} {r['leg']:7s} "
              f"{str(r['shape']):15s} w{r['width']:<2d} "
              f"ms={r['ms']:.5f} call_ms={r['call_ms']:.5f} "
              f"plain_ms={r['plain_ms']:.5f} "
              f"bound_ms={r['bound_ms']:.6f} ({r['bound_by']}; bytes "
              f"{r['bytes_ms']:.6f}, ops {r['ops_ms']:.6f}) "
              f"bytes={r['bytes']}", flush=True)
    summary = kernel_line(timings, runs, errs)
    from repro_torch.core.compressors import QSGD, TopK
    profiles = [profile_steps(dev, qw) for qw in (
        QSGD(levels=MAIN_LEVELS), TopK(ratio=SPARSE_RATIO))]
    for prof in profiles:
        print(f"profile ({prof['compressor']} layerwise, {prof['steps']} "
              f"steps): wall {prof['wall_ms_per_step']:.3f} ms/step, device "
              f"busy {prof['device_busy_ms_per_step']:.3f} ms/step, idle "
              f"share {prof['idle_share']}, {prof['device_events']} device "
              f"events", flush=True)
        for name, t in prof["top_device_ms_per_step"]:
            print(f"  device {t:.4f} ms/step  {name}", flush=True)
    total = time.perf_counter() - t_start
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps({
        "card": card, "torch": torch.__version__, "seconds": total,
        "build_seconds": secs, "main_path": runs, "timings": timings,
        "profiles": profiles, "summary": summary}, indent=1))
    print(f"total {total:.1f} s", flush=True)
    print(f"{card}")
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
