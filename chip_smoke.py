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
     bits, and fields at widths 1/4/9/13/16/17/24/31 (k = d) plus each
     shape's top-k index leg (k = 1% of d, ceil(log2 d) bits); the
     majority vote of n in {1, 2, 3, 4, 5, 8} workers over each shape's
     signSGD words
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
  7. the multi-rank path: 4 rank processes on the one card joined over
     gloo (launch/mesh.py), each holding its own worker's resnet9
     gradients. (a) compressed_allreduce under simulated and allgather,
     wire on and off, QSGD(16) / TernGrad / signSGD / natural / top-k(1%),
     layerwise and entire-model, error feedback for QSGD and top-k, equals
     the single-process Algorithm 1 in its key scheme bit for bit on every
     rank (and aggregate_simulated_workers for the key-free signSGD and
     top-k), its collectives moving comm_report's bytes under wire=True,
     with integrity words verifying and leaving payloads unchanged; (b)
     the signSGD majority vote on each bucket's gathered payloads, fused
     (majority kernel) = non-fused (bits_unpack, count, bits_pack) =
     plain; (c) one step's buffers of the per-unit codecs
     (fused=False) = the fused buffers; (d) train_cnn_ranks, 20 resnet9
     steps (batch 64, 16 a rank) for allgather-wire QSGD(16) and signSGD
     and simulated-wire QSGD(16): seconds, test loss, collective bytes a
     step against comm_report, exact launch counts, equal parameters on
     every rank at the end

Run from the repository root: `python3 chip_smoke.py` (no arguments, one
card). `python3 chip_smoke.py --nccl` on a machine with 4 cards runs the
build and phase 7 only, one rank per card over NCCL. Details go to
chiprun_out/chip_smoke.json. The last line is {"ok": true, "device":
{...}}; the line before it the kernel table, whose launches are the
main-path runs of phase 4 plus the multi-rank phase 7 summed over its
ranks.
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
               "sign_unpack": (3, 0), "fields_unpack": (4, 0),
               "bits_pack": (2, 0), "bits_unpack": (3, 0)}
HASHING = ("qsgd_pack", "terngrad_pack")
# majority: per word column, a ripple-carry add of each worker's word over
# 8 planes (xor + and each) and the 8-step borrow chain (not + or/and)
MAJORITY_PLANES = 8
VOTERS = (1, 2, 3, 4, 5, 8)
RANKS = 4
RANK_TIMEOUT = 600.0


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
        b = (xs >= 0).to(torch.int32)
        w = P.bits_pack(b)
        same("bits_pack", w, P.bits_pack_plain(b), str(shape))
        check(bitwise_equal(P.bits_unpack(w, d), b),
              f"bits round trip {shape}")
        w = make_words(n, words_per_unit(d, 1), 250 + si, dev)
        same("bits_unpack", P.bits_unpack(w, d), P.bits_unpack_plain(w, d),
             str(shape))
        W = (n // WORKERS) * words_per_unit(d, 1)     # one worker's words
        for nv in VOTERS:
            w = make_words(nv, W, 270 + 8 * si + nv, dev)
            w[:, -1] = 0                              # padding column
            same("majority", S.majority(w), S.majority_plain(w),
                 f"{nv} x {W}")
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
    launch over n units of d elements (fields: d fields per unit; majority:
    n workers of d words): each input read once and each output written
    once over the HBM rate; the integer and fp32 operations over their
    peak rates."""
    from repro_torch.kernels import ops
    if kernel == "majority":
        mv = ops.majority_bytes_moved(n, d)
        int_ops = d * (2 * MAJORITY_PLANES * (n + 1) + 1)
        fp_ops = 0
    else:
        fam, kind = kernel.split("_")
        moved = (ops.pack_bytes_moved if kind == "pack"
                 else ops.unpack_bytes_moved)
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
    code leg (k = d) and on the top-k index leg (k = 1% of d); the bit
    kernels on the signSGD words of the allgather receive leg, the majority
    vote on the 4 workers' sign words of each bucket."""
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
            bi = (x >= 0).to(torch.int32)
            wm = ws.reshape(WORKERS, -1)            # each worker's words
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
                ("bits_pack", "", d, 1, lambda: P.bits_pack(bi),
                 lambda: P.bits_pack_plain(bi)),
                ("bits_unpack", "", d, 1, lambda: P.bits_unpack(ws, d),
                 lambda: P.bits_unpack_plain(ws, d)),
                ("majority", "", wm.shape[1], 1, lambda: S.majority(wm),
                 lambda: S.majority_plain(wm)),
            ]
            for name, leg, k, width, kern, plain in cases:
                rn = WORKERS if name == "majority" else n
                nbytes, iops, fops, t_b, t_o = bounds(name, rn, k, width)
                rows.append({
                    "group": group, "kernel": name, "leg": leg,
                    "shape": [rn, k], "width": width, "ms": device_ms(kern),
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

# ---- phase 7: the multi-rank path (runs inside each rank process) ----------

def _flat(tree):
    import torch
    from repro_torch.convert import tree_leaves
    return torch.cat([leaf.reshape(-1) for leaf in tree_leaves(tree)])


def _equal_on_all_ranks(t) -> bool:
    from repro_torch.core.collectives import all_gather
    g = all_gather(t)
    return all(bitwise_equal(g[i], g[0]) for i in range(1, g.shape[0]))


def _oracle(cfg, wg, m, key, rank, n):
    """Algorithm 1 in compressed_allreduce's key scheme on one process:
    per rank r, Q_W on its units keyed by fold_in(unit key, r) (with error
    feedback when m is given), then the rank-order mean -> (mean tree,
    this rank's new EF tree or None)."""
    import torch
    from repro_torch import random as R
    from repro_torch.convert import tree_map
    from repro_torch.core.aggregation import worker_mean
    from repro_torch.core.granularity import stacked_mask
    from repro_torch.core.plan import build_plan
    g0 = tree_map(lambda t: t[0], wg)
    plan = build_plan(g0, stacked_mask(g0), cfg.granularity)
    ys, mine = [], None
    for r in range(n):
        gr = tree_map(lambda t: t[r], wg)
        if m is None:
            ys.append(plan.execute(
                lambda x, k: cfg.qw.sim(x, R.fold_in(k, r)), gr, key))
            continue

        def fn(x, mm, k):
            e = x + mm
            q = cfg.qw.sim(e, R.fold_in(k, r))
            return q, e - q
        y, mn = plan.execute_with_state(fn, gr, tree_map(lambda t: t[r], m),
                                        key)
        ys.append(y)
        mine = mn if r == rank else mine
    mean = tree_map(lambda *ls: worker_mean(torch.stack(ls)), *ys)
    return mean, mine


def _fixed_gradients(rank, n, dev):
    """Every rank builds the same n workers' resnet9 gradients (cuDNN set
    deterministic for this, so every rank's bytes are the same)."""
    import torch
    from repro_torch import random as R
    from repro_torch.configs.resnet9_cifar import RESNET9
    from repro_torch.data.synthetic import classification_batch
    from repro_torch.experiment import worker_grads
    from repro_torch.models.cnn import init_cnn
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        key = R.key(0)
        params = init_cnn(RESNET9, key, device=dev)
        batch = classification_batch(R.fold_in(key, 0), 64, device=dev)
        wg, _ = worker_grads(RESNET9, params, batch, n)
    finally:
        torch.backends.cudnn.deterministic = False
    check(_equal_on_all_ranks(_flat(wg)), "ranks built different gradients")
    return params, wg


def _comps():
    from repro_torch.core.compressors import (QSGD, NaturalCompression,
                                              SignSGD, TernGrad, TopK)
    return (QSGD(levels=MAIN_LEVELS), TernGrad(), SignSGD(),
            NaturalCompression(), TopK(ratio=SPARSE_RATIO))


def gate_fixed_gradients(rank, n, dev, params, wg):
    """(a): compressed_allreduce on this rank's row equals the single-process
    Algorithm 1 (and aggregate_simulated_workers for the key-free signSGD
    and top-k) bit for bit, the same on every rank, and with wire=True its
    collectives move comm_report's bytes; integrity words verify and leave
    payloads and outputs unchanged. -> configurations run."""
    import dataclasses
    import torch
    from repro_torch import random as R
    from repro_torch.convert import tree_map
    from repro_torch.core import collectives, wire
    from repro_torch.core.bits import comm_report
    from repro_torch.core.aggregation import (CompressionConfig,
                                              aggregate_simulated_workers,
                                              compressed_allreduce)
    from repro_torch.core.compressors import SignSGD, TopK
    from repro_torch.core.granularity import Granularity, stacked_mask
    from repro_torch.core.plan import build_plan
    from repro_torch.core.schedule import build_schedule
    key = R.key(7)
    sm = stacked_mask(params)
    g = tree_map(lambda t: t[rank], wg)
    m_all = tree_map(lambda t: 0.01 * t.flip(0), wg)
    runs = [(c, gran, False) for c in _comps()
            for gran in ("layerwise", "entire_model")]
    runs += [(c, "layerwise", True) for c in _comps()
             if c.name in ("qsgd", "topk")]
    done, outs = 0, {}
    for comp, gran, ef in runs:
        base = CompressionConfig(qw=comp, granularity=Granularity(gran),
                                 error_feedback=ef)
        m = m_all if ef else None
        want, want_m = _oracle(base, wg, m, key, rank, n)
        if isinstance(comp, (SignSGD, TopK)):
            sim, sim_m = aggregate_simulated_workers(wg, sm, base, key,
                                                     ef_state=m)
            check(bitwise_equal(_flat(sim), _flat(want)),
                  f"{comp.name} {gran}: simulated workers != oracle")
        for strategy in ("simulated", "allgather"):
            for wire_on in (False, True):
                cfg = dataclasses.replace(base, strategy=strategy)
                collectives.reset_counts()
                out, m_new = compressed_allreduce(
                    g, sm, cfg, None, key, n,
                    ef_state=tree_map(lambda t: t[rank], m) if ef else None,
                    wire=wire_on)
                moved = collectives.counts()
                what = f"{comp.name} {gran} {strategy} wire={wire_on} ef={ef}"
                if wire_on:
                    rep = comm_report(cfg, build_plan(g, sm, cfg.granularity),
                                      n, measured=True)
                    down = (rep.downlink_bits_per_worker
                            if strategy == "allgather"
                            else (n - 1) * rep.uplink_bits_per_worker)
                    check(8 * moved["sent_bytes"] == rep.uplink_bits_per_worker
                          and 8 * moved["recv_bytes"] == down,
                          f"{what}: collectives moved {moved}, comm_report "
                          f"{rep}")
                check(bitwise_equal(_flat(out), _flat(want)),
                      f"{what}: != single-process Algorithm 1")
                check(_equal_on_all_ranks(_flat(out)),
                      f"{what}: ranks disagree")
                if ef:
                    check(bitwise_equal(_flat(m_new), _flat(want_m)),
                          f"{what}: EF residual != single-process")
                outs[(comp.name, gran, strategy, wire_on, ef)] = out
                done += 1
    for comp in _comps():
        cfg = CompressionConfig(qw=comp, strategy="allgather",
                                integrity=True)
        out, _ = compressed_allreduce(g, sm, cfg, None, key, n, wire=True)
        check(bitwise_equal(_flat(out), _flat(outs[(
            comp.name, "layerwise", "allgather", True, False)])),
            f"{comp.name}: integrity changed the aggregate")
        plan = build_plan(g, sm, Granularity("layerwise"))
        sched = build_schedule(plan, 0.0)
        wk = lambda k: R.fold_in(k, rank)
        codecs = [wire.wire_codec(comp, integrity=i) for i in (True, False)]
        (_, bufs), (_, plain) = (wire.execute_schedule_wire(
            sched, c, g, key, wire_key=wk) for c in codecs)
        for lay, buf, pb in zip(wire.message_layouts(sched, codecs[0]), bufs,
                                plain):
            check(bool(wire.verify_message(buf, lay)),
                  f"{comp.name}: a clean buffer fails verify_message")
            check(bitwise_equal(buf[lay.header_nbytes:],
                                pb[lay.header_nbytes - 4:]),
                  f"{comp.name}: integrity changed the payload bytes")
        done += 1
    torch.cuda.synchronize()
    return done


def gate_majority(rank, n, dev, params, wg):
    """(b): on each bucket's gathered signSGD payloads (layerwise and
    entire-model), the fused vote (majority kernel) equals the non-fused
    one (bits_unpack, count, bits_pack) and the plain version. -> votes."""
    import torch
    from repro_torch import random as R
    from repro_torch.convert import tree_map
    from repro_torch.core.collectives import all_gather
    from repro_torch.core.compressors import SignSGD
    from repro_torch.core.granularity import Granularity, stacked_mask
    from repro_torch.core.plan import build_plan
    from repro_torch.core.wire import SignSGDCodec
    from repro_torch.kernels.sign import majority_plain
    g = tree_map(lambda t: t[rank], wg)
    fused = SignSGDCodec(comp=SignSGD())
    unfused = SignSGDCodec(comp=SignSGD(), fused=False)
    votes = 0
    for gran in ("layerwise", "entire_model"):
        plan = build_plan(g, stacked_mask(params), Granularity(gran))
        leaves, _ = plan._inputs(g, R.key(0))
        flat = plan._flat(leaves) if plan.needs_flat else None
        for b in plan.buckets:
            pay = fused.encode_batch(plan._gather_runs(leaves, flat, b), None)
            gathered = all_gather(pay)                  # (n, units, nbytes)
            v = fused.majority_vote(gathered, b.dim)
            check(bitwise_equal(v, unfused.majority_vote(gathered, b.dim)),
                  f"{gran} {b.n}x{b.dim}: fused vote != non-fused vote")
            words = gathered.reshape(n, -1).view(torch.int32)
            check(bitwise_equal(v.reshape(-1).view(torch.int32),
                                majority_plain(words)),
                  f"{gran} {b.n}x{b.dim}: vote != plain version")
            votes += 1
    torch.cuda.synchronize()
    return votes


def gate_unit_codecs(rank, n, dev, params, wg):
    """(c): one step's message buffers through the per-unit codecs
    (fused=False) equal the fused buffers byte for byte. -> messages."""
    import torch
    from repro_torch import random as R
    from repro_torch.convert import tree_map
    from repro_torch.core import wire
    from repro_torch.core.granularity import Granularity, stacked_mask
    from repro_torch.core.plan import build_plan
    from repro_torch.core.schedule import build_schedule
    g = tree_map(lambda t: t[rank], wg)
    wk = lambda k: R.fold_in(k, rank)
    msgs = 0
    for comp in _comps():
        for gran in ("layerwise", "entire_model"):
            plan = build_plan(g, stacked_mask(params), Granularity(gran))
            sched = build_schedule(plan, 0.0)
            (_, a), (_, b) = (wire.execute_schedule_wire(
                sched, wire.wire_codec(comp, fused=f), g, R.key(9),
                wire_key=wk) for f in (True, False))
            for x, y in zip(a, b):
                check(bitwise_equal(x, y),
                      f"{comp.name} {gran}: fused=False buffer != fused")
                msgs += 1
    torch.cuda.synchronize()
    return msgs


def train_ranks(rank, n, dev):
    """(d): train_cnn_ranks, STEPS resnet9 steps per run, batch 64 over the
    ranks; exact launch counts, collective bytes a step against
    comm_report, equal parameters on every rank. -> per-run records."""
    import torch
    from repro_torch import kernels
    from repro_torch.core import collectives
    from repro_torch.core.aggregation import CompressionConfig
    from repro_torch.core.bits import comm_report
    from repro_torch.core.compressors import QSGD, SignSGD
    from repro_torch.core.granularity import Granularity, stacked_mask
    from repro_torch.core.plan import build_plan
    from repro_torch.experiment import train_cnn_ranks
    runs = [("allgather_qsgd16_layerwise", QSGD(levels=MAIN_LEVELS),
             "allgather", {"qsgd_pack": 11, "fields_unpack": 11}),
            ("allgather_signsgd_layerwise", SignSGD(), "allgather",
             {"sign_pack": 11, "bits_unpack": 11}),
            ("simulated_qsgd16_layerwise", QSGD(levels=MAIN_LEVELS),
             "simulated", {"qsgd_pack": 11, "qsgd_unpack": 11})]
    out = []
    for name, comp, strategy, per_step in runs:
        cfg = CompressionConfig(qw=comp, strategy=strategy,
                                granularity=Granularity("layerwise"))
        kernels.reset_launch_counts()
        collectives.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        acc, loss, params = train_cnn_ranks("resnet9", cfg, steps=STEPS,
                                            batch=64, device=dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = kernels.launch_counts()
        coll = collectives.counts()
        want = {k: per_step.get(k, 0) * STEPS for k in counts}
        check(counts == want, f"{name}: launches {counts} != {want}")
        plan = build_plan(params, stacked_mask(params),
                          Granularity("layerwise"))
        rep = comm_report(cfg, plan, n, measured=True)
        sent, recv = coll["sent_bytes"] / STEPS, coll["recv_bytes"] / STEPS
        check(8 * sent == rep.uplink_bits_per_worker,
              f"{name}: {sent} B sent a step, comm_report "
              f"{rep.uplink_bits_per_worker / 8}")
        down = (rep.downlink_bits_per_worker if strategy == "allgather"
                else (n - 1) * rep.uplink_bits_per_worker)
        check(8 * recv == down, f"{name}: {recv} B received a step, want "
              f"{down / 8}")
        check(coll["calls"] == 11 * STEPS, f"{name}: {coll['calls']} calls")
        check(math.isfinite(loss) and math.isfinite(acc),
              f"{name}: test loss {loss}")
        check(_equal_on_all_ranks(_flat(params)),
              f"{name}: parameters differ across ranks")
        out.append({"run": name, "steps": STEPS, "seconds": secs,
                    "test_loss": loss, "test_accuracy": acc,
                    "launches": counts, "sent_bytes_per_step": sent,
                    "recv_bytes_per_step": recv,
                    "comm_report_up_bytes": rep.uplink_bits_per_worker / 8,
                    "comm_report_down_bytes":
                        rep.downlink_bits_per_worker / 8,
                    "collective_ms_per_step": coll["seconds"] / STEPS * 1e3})
    return out


def gather_timing(rank, n, dev, nbytes_list):
    """Host ms of one all_gather per size (median of 20 after 3 warm-ups),
    of a uint8 tensor on the card (the port's transport) and, under gloo
    and for comparison only, of the same bytes in pinned host memory."""
    import torch
    import torch.distributed as dist
    from repro_torch.core.collectives import all_gather
    out = {}
    wheres = (("card", "pinned_host") if dist.get_backend() == "gloo"
              else ("card",))
    for where in wheres:
        for nb in nbytes_list:
            t = torch.zeros(nb, dtype=torch.uint8, device=dev)
            if where == "pinned_host":
                t = t.cpu().pin_memory()
            vals = []
            for i in range(23):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                all_gather(t)
                torch.cuda.synchronize()
                if i >= 3:
                    vals.append((time.perf_counter() - t0) * 1e3)
            vals.sort()
            out[f"{where}/{nb}"] = vals[len(vals) // 2]
    return out


def rank_phase(rank, n, dev):
    """Phase 7 on one rank: each gate driven with the launch counters set
    to 0 just before it and read just after."""
    import torch
    from repro_torch import kernels
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    params, wg = _fixed_gradients(rank, n, dev)
    res = {}
    for name, gate in (("fixed_gradients", gate_fixed_gradients),
                       ("majority", gate_majority),
                       ("unit_codecs", gate_unit_codecs)):
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        count = gate(rank, n, dev, params, wg)
        res[name] = {"count": count, "seconds": time.perf_counter() - t0,
                     "launches": kernels.launch_counts()}
    res["train"] = train_ranks(rank, n, dev)
    res["gather_ms"] = gather_timing(rank, n, dev,
                                     (4_096, 60_512, 484_008, 4_194_304))
    return res


def multi_rank_path(backend: str = "gloo"):
    """Phase 7: RANKS rank processes, on the one card over gloo or one card
    each over NCCL."""
    from repro_torch.launch.mesh import run_ranks
    t0 = time.perf_counter()
    res = run_ranks(rank_phase, RANKS, backend=backend, device="cuda",
                    timeout=RANK_TIMEOUT)
    secs = time.perf_counter() - t0
    r0 = res[0]
    where = ("on cuda:0 over gloo (CUDA tensors straight into gloo, no "
             "staging copy in the port)" if backend == "gloo"
             else "one card each over nccl")
    print(f"multi-rank: {RANKS} ranks {where}, {secs:.1f} s", flush=True)
    print(f"  (a) {r0['fixed_gradients']['count']} compressed_allreduce "
          f"configurations bitwise equal to the single-process Algorithm 1 "
          f"on every rank, integrity words verified", flush=True)
    print(f"  (b) {r0['majority']['count']} bucket votes: fused == non-fused "
          f"== plain", flush=True)
    print(f"  (c) {r0['unit_codecs']['count']} messages: fused=False buffers "
          f"== fused", flush=True)
    for run in r0["train"]:
        print(f"  (d) {run['run']}: {run['steps']} steps in "
              f"{run['seconds']:.3f} s (rank 0), test loss "
              f"{run['test_loss']:.6f}, sent {run['sent_bytes_per_step']:.0f}"
              f" B / received {run['recv_bytes_per_step']:.0f} B a step "
              f"(comm_report up {run['comm_report_up_bytes']:.0f} B, down "
              f"{run['comm_report_down_bytes']:.0f} B), collectives "
              f"{run['collective_ms_per_step']:.3f} ms a step, launches "
              f"{ {k: v for k, v in run['launches'].items() if v} }",
              flush=True)
    print(f"  {backend} all_gather, host ms by where and bytes per rank: "
          f"{r0['gather_ms']}", flush=True)
    launches = {}
    for r in res:
        for phase in ("fixed_gradients", "majority", "unit_codecs"):
            for k, v in r[phase]["launches"].items():
                launches[k] = launches.get(k, 0) + v
        for run in r["train"]:
            for k, v in run["launches"].items():
                launches[k] = launches.get(k, 0) + v
    return res, launches, secs



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
    "bits_pack": ("src/repro_torch/kernels/csrc/bits.cu",
                  "src/repro/kernels/pack.py:47"),
    "bits_unpack": ("src/repro_torch/kernels/csrc/bits.cu",
                    "src/repro/kernels/pack.py:61"),
    "majority": ("src/repro_torch/kernels/csrc/sign.cu",
                 "src/repro/kernels/sign.py:83"),
}


def kernel_line(timings, launches, errs):
    """The per-kernel summary: device ms / plain_ms / bound_ms summed over
    one layerwise main-path step (the 11 resnet9 buckets x 4 workers; the
    fields kernels on natural compression's 9-bit code leg); `launches`
    the main-path launches of each kernel, every one above 0."""
    out = []
    for name, (src, replaces) in SOURCES.items():
        check(launches[name] > 0, f"{name}: no launch on the main path")
        step = [r for r in timings
                if r["kernel"] == name and r["group"] == "layerwise_step"
                and r["leg"] in ("", "natural")]
        tot = {k: sum(r[k] for r in step)
               for k in ("ms", "plain_ms", "bound_ms", "bytes_ms", "ops_ms")}
        out.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": errs[name], "ms": tot["ms"],
            "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
            "bound_by": ("bytes" if tot["bytes_ms"] >= tot["ops_ms"]
                         else "operations"),
            "library_ms": None})
    return {"kernels": out}


def nccl_only(card: str) -> int:
    """`--nccl`: phase 7 with one rank per card over NCCL."""
    import torch
    check(torch.cuda.device_count() >= RANKS,
          f"--nccl needs {RANKS} cards, torch sees "
          f"{torch.cuda.device_count()}")
    multi, launches, secs = multi_rank_path("nccl")
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke_nccl.json").write_text(json.dumps({
        "card": card, "torch": torch.__version__, "multi_rank": multi,
        "multi_rank_seconds": secs, "launches": launches}, indent=1))
    print(f"{card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def main(argv) -> int:
    nccl = argv == ["--nccl"]
    if argv and not nccl:
        print(f"chip_smoke: unknown arguments {argv}; takes none, or --nccl",
              file=sys.stderr)
        return 2
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
    if nccl:
        return nccl_only(card)

    layer_shapes, em_shape = bucket_shapes()
    shapes = layer_shapes + [em_shape, STRESS]
    errs = check_kernels(shapes, dev)
    print(f"kernels vs plain: bitwise equal over {len(shapes)} shapes "
          f"(QSGD widths {[w for w, _ in QSGD_WIDTHS]}, TernGrad, sign, "
          f"bits, fields widths {list(FIELD_WIDTHS)} and the top-k index "
          f"legs; majority of {list(VOTERS)} workers); max abs err {errs}",
          flush=True)

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
    multi, multi_launches, multi_secs = multi_rank_path()
    launches = {k: sum(r["launches"][k] for r in runs)
                + multi_launches.get(k, 0) for k in SOURCES}
    summary = kernel_line(timings, launches, errs)
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
        "profiles": profiles, "multi_rank": multi,
        "ptxas": {src: [ln.strip() for ln in log.splitlines()
                        if "registers" in ln or "spill" in ln]
                  for src, log in build.BUILD_LOG.items()},
        "multi_rank_seconds": multi_secs, "summary": summary}, indent=1))
    print(f"total {total:.1f} s", flush=True)
    print(f"{card}")
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
