"""chip_smoke.py phase 15 alone on the card, then what the sparse decode's
spare column costs on the clean path, then the two fault campaigns.

1. Build the kernels; run 15(c) (`faults_ranks` on resnet9's fixed
   gradients) in a spawn of 4 gloo ranks sharing cuda:0, then
   `resil_phase` ((a) the faulted phi4-mini full-width aggregate, (b)
   resnet9 through train_resilient, (d) a campaign cell a scenario).
2. SparseCodec.decode_buckets as the port runs it (an index past the unit
   lands in a spare column cut off after the scatter) against the same
   decode without the spare column (zeros of the unit's width, the
   scatter's result returned whole), on the same top-k payloads: bitwise
   equal, each timed with CUDA events (median of REPS calls, the two
   forms alternated over ROUNDS rounds) at resnet9's layerwise and
   entire-model buckets (4 workers, ratio SPARSE_RATIO) and at one
   phi4-mini MLP matrix (2 layers, 2 workers); then train_cnn's top-k
   layerwise run (STEPS steps) under each form, in the order spare,
   plain, plain, spare.
3. `python -m repro_torch.faults` and `python -m repro_torch.scenarios`
   (the reference's sizes), each in its own process, wall time taken
   here; their reports and logs go to chiprun_out/.

The record goes to chiprun_out/probe15.json. Run from the repository
root: `python3 tools/resil_phase_probe.py`.
"""
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
import torch  # noqa: E402

import chip_smoke as C  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.launch.mesh import run_ranks  # noqa: E402

REPS, ROUNDS = 50, 3
#: phi4-mini's MLP down matrix (d_model 3072 x intermediate 8192)
PHI4_MLP = 3072 * 8192


def rank_fn(rank, n, dev):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _, wg = C._fixed_gradients(rank, n, dev)
    t0 = time.perf_counter()
    r = C.faults_ranks(rank, n, dev, wg)
    r["seconds"] = time.perf_counter() - t0
    return r


def decode_without_spare(codec, payloads_list, dims):
    """SparseCodec.decode_buckets with zeros of the unit's own width: the
    same unpack launch and scatter, no spare column, no clamp, the
    scatter's (contiguous) result returned whole."""
    from repro_torch.core.wire import (_u8_rows_to, _u8_rows_to_vals,
                                       index_bits, ops)
    idxs = ops.fields_unpack_units_buckets(
        [_u8_rows_to(p[:, codec._vb(d):], torch.int32)
         for p, d in zip(payloads_list, dims)],
        [codec._k(d) for d in dims], [index_bits(d) for d in dims])
    out = []
    for p, d, idx in zip(payloads_list, dims, idxs):
        val = _u8_rows_to_vals(p[:, :codec._vb(d)], codec._k(d),
                               codec.wire_dtype)
        z = torch.zeros((p.shape[0], d), dtype=torch.float32,
                        device=p.device)
        out.append(z.scatter_(1, idx.to(torch.int64), val))
    return out


def _payloads(codec, rows_dims, dev, seed):
    """Top-k payloads of random normal rows, one (rows, d) bucket each."""
    g = torch.Generator(device=dev).manual_seed(seed)
    es = [torch.randn((r, d), generator=g, device=dev) for r, d in rows_dims]
    keys = [torch.zeros((r, 2), dtype=torch.uint32, device=dev)
            for r, _ in rows_dims]
    return codec.encode_buckets(es, keys), [d for _, d in rows_dims]


def _median_ms(fn):
    times = []
    for _ in range(REPS):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def spare_column_cost(dev):
    from repro_torch.configs.resnet9_cifar import RESNET9
    from repro_torch.core import Granularity, build_plan, stacked_mask
    from repro_torch.core.compressors import TopK
    from repro_torch.core.wire import SparseCodec, wire_codec
    from repro_torch.experiment import train_cnn
    from repro_torch.core.aggregation import CompressionConfig
    from repro_torch import random as R
    from repro_torch.models.cnn import init_cnn
    codec = wire_codec(TopK(ratio=C.SPARSE_RATIO))
    params = init_cnn(RESNET9, R.key(0), device=dev)
    shapes = {}
    for gran in ("layerwise", "entire_model"):
        plan = build_plan(params, stacked_mask(params), Granularity(gran))
        shapes[f"resnet9_{gran}"] = [(4 * b.n, b.dim) for b in plan.buckets]
    shapes["phi4_mlp"] = [(2 * 2, PHI4_MLP)]
    rec = {"decode": {}, "train_cnn": []}
    for name, rows_dims in shapes.items():
        pays, dims = _payloads(codec, rows_dims, dev, 15)
        a = codec.decode_buckets(pays, dims)
        b = decode_without_spare(codec, pays, dims)
        C.check(all(torch.equal(x, y) for x, y in zip(a, b)),
                f"spare column changed the decode of {name}")
        spare, plain = [], []
        for _ in range(ROUNDS):
            spare.append(_median_ms(lambda: codec.decode_buckets(pays,
                                                                  dims)))
            plain.append(_median_ms(lambda: decode_without_spare(
                codec, pays, dims)))
        rec["decode"][name] = {"buckets": len(dims), "rows_dims": rows_dims,
                               "spare_ms": spare, "plain_ms": plain}
        print(f"decode {name}: spare {spare} ms, without {plain} ms",
              flush=True)
        del pays, a, b
    cfg = CompressionConfig(qw=TopK(ratio=C.SPARSE_RATIO),
                            granularity=Granularity("layerwise"))
    ported = SparseCodec.decode_buckets
    try:
        for form in ("spare", "plain", "plain", "spare"):
            SparseCodec.decode_buckets = (ported if form == "spare"
                                          else decode_without_spare)
            t0 = time.perf_counter()
            acc, loss = train_cnn("resnet9", cfg, steps=C.STEPS, device=dev)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            rec["train_cnn"].append({"form": form, "seconds": secs,
                                     "test_loss": loss})
            print(f"train_cnn topk1_layerwise {form}: {C.STEPS} steps in "
                  f"{secs:.3f} s, test loss {loss:.6f}", flush=True)
    finally:
        SparseCodec.decode_buckets = ported
    return rec


def campaign(module, out):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    with open(out / f"{module}.log", "w") as log:
        rc = subprocess.run([sys.executable, "-m", f"repro_torch.{module}",
                             "--out", str(out / f"{module}.json")],
                            cwd=str(ROOT), env=env, stdout=log,
                            stderr=subprocess.STDOUT).returncode
    secs = time.perf_counter() - t0
    print(f"python -m repro_torch.{module}: exit {rc}, {secs:.1f} s",
          flush=True)
    return {"rc": rc, "seconds": secs}


if __name__ == "__main__":
    t0 = time.perf_counter()
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    print(C.smi_line(), flush=True)
    print(f"build {build.build_all():.1f} s", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t1 = time.perf_counter()
    ranks = run_ranks(rank_fn, C.RANKS, backend="gloo", device="cuda",
                      timeout=C.RANK_TIMEOUT)
    spawn = time.perf_counter() - t1
    print(f"15(c) spawn {spawn:.1f} s, rank 0 {ranks[0]['seconds']:.1f} s",
          flush=True)
    t1 = time.perf_counter()
    resil, launches = C.resil_phase(dev, ranks)
    print(f"15 (a), (b), (d) {time.perf_counter() - t1:.1f} s, launches",
          {k: v for k, v in launches.items() if v}, flush=True)
    rec = {"smi": C.smi_line(), "spawn_s": spawn, "resil": resil,
           "launches": launches, "spare": spare_column_cost(dev)}
    (out / "probe15.json").write_text(json.dumps(rec, indent=1,
                                                 default=str))
    rec["faults"] = campaign("faults", out)
    rec["scenarios"] = campaign("scenarios", out)
    (out / "probe15.json").write_text(json.dumps(rec, indent=1,
                                                 default=str))
    print(f"total {time.perf_counter() - t0:.1f} s", flush=True)
    sys.exit(max(rec["faults"]["rc"], rec["scenarios"]["rc"]) != 0)
