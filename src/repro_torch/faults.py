"""The resilience-plane campaign on the port (the JAX package's
benchmarks/faults.py: the same four legs and asserted gates).

  1. DETECTION MATRIX (serialized wire path): for six codecs x both
     granularities, every clean fused message verifies against its
     Fletcher-32 header word and every injected single-bit flip fails
     verification, measured on sampled (byte, bit) flips of the packed
     buffers and end to end through a prob=1 FaultInjector on the
     simulated-worker aggregate (detected == messages).
  2. DETECTION MATRIX (streaming ring): the same cells through real
     ring hops on RING_RANKS gloo ranks (launch/mesh.py run_ranks; on the
     card they share it): prob=1 per-hop bit flips are all detected and
     resend recovers the clean aggregate bitwise; prob=1 duplicated
     (stale) hops deliver VALID bytes and none is flagged.
  3. RECOVERY VS CLEAN: the campaign's CNN cell (resnet9, top-k 0.25
     with EF, both granularities) trained through train_resilient under
     heavy receive corruption WITH resend lands bitwise on the clean
     cell's loss trajectory, so the layer-wise vs entire-model verdict is
     the clean cell's.
  4. RESUME: train N == train k + kill + resume + train N-k, leaf for
     leaf.

A failing gate raises. The report goes to chiprun_out/faults.json
unless --out says otherwise; it never rewrites the repository's
BENCH_faults.json.

Run:  python -m repro_torch.faults [--device cpu] [--steps N] [--out PATH]
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
import zlib
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.convert import tree_leaves, tree_map
from repro_torch.core import (CompressionConfig, Granularity,
                              aggregate_simulated_workers, build_plan,
                              build_schedule, compressed_allreduce,
                              make_compressor, stacked_mask)
from repro_torch.core.wire import (execute_schedule_wire, message_layouts,
                                   verify_message, wire_codec)
from repro_torch.random import fold_in
from repro_torch.random import key as make_key
from repro_torch.random import normal
from repro_torch.resil import FaultInjector, RecoveryConfig, train_resilient
from repro_torch.scenarios import _CnnRunner, cell_key
from repro_torch.sim import CorruptionSpec, Scenario

STEPS = 8
FLIPS_PER_MESSAGE = 16
RATIO = 0.25
LR = 0.02
TIE_MARGIN = 0.02
RING_RANKS = 4
OUT = Path(__file__).resolve().parents[2] / "chiprun_out" / "faults.json"

SIX = [
    ("topk", {"ratio": 0.25}),
    ("randomk", {"ratio": 0.3, "scale": True}),
    ("qsgd", {"levels": 16}),
    ("terngrad", {}),
    ("signsgd", {}),
    ("natural", {}),
]
GRANS = ("layerwise", "entire_model")


def _tree(key=None, device="cpu"):
    """The reference's 5-leaf test tree, its normal draws jax's."""
    key = make_key(0) if key is None else key
    ks = [fold_in(key, i) for i in range(5)]
    t = {"blocks": {"w": normal(ks[0], (3, 16, 8)),
                    "b": normal(ks[1], (3, 8))},
         "embed": normal(ks[2], (20, 4)),
         "head": normal(ks[3], (4, 2)),
         "scalar_gain": normal(ks[4], ())}
    return tree_map(lambda x: x.to(device), t)


def _worker_grads(n=4, device="cpu"):
    trees = [_tree(fold_in(make_key(0), 100 + i), device) for i in range(n)]
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def _bitwise_equal(a, b) -> bool:
    return all(torch.equal(x.cpu(), y.cpu())
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


# ---- leg 1: serialized detection matrix ---------------------------------------

def _serialized_cell(name: str, kw: Dict, gran: str, dev) -> Dict:
    t = _tree(device=dev)
    sm = stacked_mask(t)
    key = cell_key(f"faults|{name}|{gran}").to(dev)
    comp = make_compressor(name, **kw)
    plan = build_plan(t, sm, Granularity(gran))
    sched = build_schedule(plan, 0.0)
    codec = wire_codec(comp, integrity=True)
    lays = message_layouts(sched, codec)
    plain = message_layouts(sched, wire_codec(comp))
    _, bufs = execute_schedule_wire(sched, codec, t, key)

    bytes_total = sum(lay.total_nbytes for lay in lays)
    overhead = bytes_total - sum(lay.total_nbytes for lay in plain)
    assert overhead == 4 * len(lays)    # one uint32 word per message

    rng = np.random.default_rng(zlib.crc32(f"{name}|{gran}".encode()))
    clean_fail = flips = undetected = 0
    for buf, lay in zip(bufs, lays):
        if not bool(verify_message(buf, lay)):
            clean_fail += 1
        span = buf.numel() - lay.checksum_span_start
        cands = []
        for _ in range(FLIPS_PER_MESSAGE):
            pos = lay.checksum_span_start + int(rng.integers(span))
            bit = int(rng.integers(8))
            c = buf.clone()
            c[pos] ^= 1 << bit
            cands.append(c)
        flips += len(cands)
        undetected += int(verify_message(torch.stack(cands), lay).sum())

    # end to end: prob=1 single-bit flips through the aggregate path
    cfg = CompressionConfig(qw=comp, granularity=Granularity(gran),
                            integrity=True)
    inj = FaultInjector(CorruptionSpec(prob=1.0, seed=3), resend=False)
    _, _, info = aggregate_simulated_workers(_worker_grads(device=dev), sm,
                                             cfg, key, wire=True, faults=inj)
    return {
        "n_messages": len(lays),
        "wire_bytes": int(bytes_total),
        "integrity_overhead_bytes": int(overhead),
        "integrity_overhead_frac": round(overhead / bytes_total, 6),
        "clean_messages_failed": clean_fail,
        "false_positive_rate": clean_fail / len(lays),
        "bit_flips_injected": flips,
        "bit_flips_undetected": undetected,
        "detection_rate": (flips - undetected) / flips,
        "e2e_messages": int(info["messages"]),
        "e2e_detected": int(info["corrupt_detected"]),
    }


# ---- leg 2: streaming-ring detection matrix (gloo ranks) ----------------------

def _ring_rank(rank, n, dev):
    """Every ring cell on this rank: the clean ring, prob=1 per-hop bit
    flips with resend, prob=1 duplicated hops -> {cell: record}."""
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    t = _tree(device=dev)
    sm = stacked_mask(t)
    g = tree_map(lambda x: x * (1.0 + rank), t)
    res = {}
    for name, kw in SIX:
        for gran in GRANS:
            key = cell_key(f"ring|{name}|{gran}").to(dev)
            cfg = CompressionConfig(qw=make_compressor(name, **kw),
                                    granularity=Granularity(gran),
                                    strategy="ring", integrity=True)

            def run(spec):
                inj = None if spec is None else FaultInjector(spec,
                                                              resend=True)
                out, _ = compressed_allreduce(g, sm, cfg, None, key, n,
                                              wire=True, faults=inj)
                flags = (inj.take_flags() if inj is not None
                         else torch.zeros((0,), dtype=torch.bool))
                return out, int((~flags).sum()), flags.numel()
            clean, _, _ = run(None)
            flip, flip_det, flip_msgs = run(CorruptionSpec(prob=1.0, seed=5))
            dup, dup_det, dup_msgs = run(
                CorruptionSpec(prob=1.0, mode="dup_hop", seed=7))
            res[f"{name}/{gran}"] = {
                "hops": flip_msgs, "flip_det": flip_det,
                "resend_clean": _bitwise_equal(flip, clean),
                "dup_hops": dup_msgs, "dup_det": dup_det,
                "dup_differs": not _bitwise_equal(dup, clean)}
    return res


def _ring_leg(dev) -> Dict:
    from repro_torch.launch.mesh import run_ranks
    ranks = run_ranks(_ring_rank, RING_RANKS, backend="gloo",
                      device=dev.type, timeout=900)
    n = RING_RANKS
    out = {}
    for cell, r0 in ranks[0].items():
        flip_det = sum(r[cell]["flip_det"] for r in ranks)
        dup_det = sum(r[cell]["dup_det"] for r in ranks)
        out[cell] = {
            "n_workers": n,
            "hops_verified_per_worker": r0["hops"],
            "bit_flip_hops": n * r0["hops"],
            "bit_flip_detected": flip_det,
            "detection_rate": flip_det / (n * r0["hops"]),
            "resend_recovers_clean_bitwise": all(r[cell]["resend_clean"]
                                                 for r in ranks),
            "valid_stale_hops": n * r0["dup_hops"],
            "valid_stale_flagged": dup_det,
            "false_positive_rate": dup_det / (n * r0["dup_hops"]),
            "stale_hop_passes_checksum": dup_det == 0,
            "stale_hop_changes_aggregate": any(r[cell]["dup_differs"]
                                               for r in ranks),
        }
    return out


# ---- legs 3 + 4: recovery vs clean, and the resume gate ----------------------

def _cnn_comp(gran: str) -> CompressionConfig:
    return CompressionConfig(qw=make_compressor("topk", ratio=RATIO),
                             granularity=Granularity(gran),
                             error_feedback=True, integrity=True)


def _final(losses) -> float:
    tail = losses[-3:] if len(losses) >= 3 else losses
    return sum(tail) / len(tail)


def _verdict(lw_final: float, em_final: float) -> str:
    if lw_final < em_final * (1.0 - TIE_MARGIN):
        return "layerwise"
    if em_final < lw_final * (1.0 - TIE_MARGIN):
        return "entire_model"
    return "tie"


def _recovery_leg(steps: int, dev) -> Dict:
    runner = _CnnRunner(dev)
    clean_scen = Scenario(name="clean", n_workers=4)
    bad_scen = Scenario(name="corrupt", n_workers=4,
                        corruption=CorruptionSpec(prob=0.5, n_bits=2,
                                                  seed=21))
    cells, raw = {}, {}
    for label, scen, rec in (
            ("clean", clean_scen, RecoveryConfig(resend=False)),
            ("faulted_resend", bad_scen, RecoveryConfig(resend=True))):
        entry = {}
        for gran in GRANS:
            res = train_resilient(runner, scen, _cnn_comp(gran), steps=steps,
                                  lr=LR, seed=17, recovery=rec)
            raw[(label, gran)] = (res["losses"], res["params"])
            entry[gran] = {
                "final_loss": round(_final(res["losses"]), 6),
                "loss_curve": [round(v, 4) for v in res["losses"]],
                "corrupt_detected":
                    res["counters"]["resil/corrupt_detected"],
                "resends": res["counters"]["resil/resends"],
            }
            print(f"recovery {label:16s} {gran:13s} "
                  f"final={entry[gran]['final_loss']:.4f} "
                  f"detected={entry[gran]['corrupt_detected']}", flush=True)
        entry["verdict"] = _verdict(entry["layerwise"]["final_loss"],
                                    entry["entire_model"]["final_loss"])
        cells[label] = entry
    cells["verdict_recovered"] = (cells["faulted_resend"]["verdict"]
                                  == cells["clean"]["verdict"])
    cells["losses_bitwise_equal"] = all(
        raw[("faulted_resend", g)][0] == raw[("clean", g)][0]
        for g in GRANS)
    cells["params_bitwise_equal"] = all(
        _bitwise_equal(raw[("faulted_resend", g)][1], raw[("clean", g)][1])
        for g in GRANS)
    return cells


class _MlpRunner:
    """Tiny linear-softmax runner for the resume gate (the campaign
    protocol at its smallest useful scale)."""
    categories = 4
    global_batch = 8

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)

    def init(self, key):
        return {"w": (0.1 * normal(key, (16, 4))).to(self.device),
                "b": torch.zeros((4,), device=self.device)}

    def loss(self, params, batch, key):
        x = batch["images"].reshape(batch["images"].shape[0], -1)
        logits = x @ params["w"] + params["b"]
        picked = logits.gather(1, batch["labels"][:, None])[:, 0]
        return (torch.logsumexp(logits, dim=-1) - picked).mean()

    def worker_batch(self, key, props, per):
        from repro_torch.data import noniid_classification_batch
        return noniid_classification_batch(key, props, per, classes=4, hw=4,
                                           channels=1, device=self.device)


def _resume_leg(steps: int, dev) -> Dict:
    runner = _MlpRunner(dev)
    scen = Scenario(name="corrupt", n_workers=4,
                    corruption=CorruptionSpec(prob=0.5, seed=5))
    comp = _cnn_comp("layerwise")
    n, k = max(4, steps), max(2, steps // 2)
    full = train_resilient(runner, scen, comp, steps=n, seed=1)
    with tempfile.TemporaryDirectory() as d:
        train_resilient(runner, scen, comp, steps=k, seed=1, ckpt_dir=d,
                        ckpt_every=k)
        resumed = train_resilient(runner, scen, comp, steps=n, seed=1,
                                  ckpt_dir=d, ckpt_every=k, resume=True)
    return {
        "steps": n,
        "kill_at": k,
        "params_bitwise": _bitwise_equal(resumed["params"], full["params"]),
        "ef_bitwise": _bitwise_equal(resumed["ef"], full["ef"]),
        "losses_replayed": resumed["losses"] == full["losses"][k:],
        "counters_match": resumed["counters"] == full["counters"],
    }


# ---- the campaign --------------------------------------------------------------

def faults(out_path=None, *, steps: int = STEPS, device="cuda") -> Dict:
    """Run the four legs, assert the gates, write the report (the
    reference's keys, plus each leg's wall seconds) -> the report."""
    dev = resolve_device(device)
    report = {"steps": steps, "flips_per_message": FLIPS_PER_MESSAGE,
              "tie_margin": TIE_MARGIN,
              "integrity_overhead_bytes_per_message": 4,
              "detection": {"serialized": {}, "ring": {}},
              "device": str(dev), "seconds": {}}
    t0 = time.perf_counter()
    for name, kw in SIX:
        for gran in GRANS:
            cell = _serialized_cell(name, kw, gran, dev)
            report["detection"]["serialized"][f"{name}/{gran}"] = cell
            print(f"serialized {name:9s} {gran:13s} "
                  f"msgs={cell['n_messages']:2d} "
                  f"fp={cell['false_positive_rate']:.0%} "
                  f"det={cell['detection_rate']:.0%} "
                  f"e2e={cell['e2e_detected']}/{cell['e2e_messages']} "
                  f"+{cell['integrity_overhead_bytes']}B", flush=True)
    report["seconds"]["serialized"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    report["detection"]["ring"] = _ring_leg(dev)
    for cell_name, cell in report["detection"]["ring"].items():
        print(f"ring       {cell_name:23s} hops={cell['bit_flip_hops']:3d} "
              f"det={cell['detection_rate']:.0%} "
              f"fp={cell['false_positive_rate']:.0%} "
              f"resend_clean={cell['resend_recovers_clean_bitwise']}",
              flush=True)
    report["seconds"]["ring"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    report["recovery"] = _recovery_leg(steps, dev)
    report["seconds"]["recovery"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    report["resume"] = _resume_leg(steps, dev)
    report["seconds"]["resume"] = time.perf_counter() - t0

    ser = report["detection"]["serialized"].values()
    ring = report["detection"]["ring"].values()
    gates = {
        "zero_false_positives": (
            all(c["false_positive_rate"] == 0.0 for c in ser)
            and all(c["false_positive_rate"] == 0.0 for c in ring)),
        "all_flips_detected": (
            all(c["detection_rate"] == 1.0
                and c["e2e_detected"] == c["e2e_messages"] for c in ser)
            and all(c["detection_rate"] == 1.0 for c in ring)),
        "ring_resend_recovers": all(
            c["resend_recovers_clean_bitwise"] for c in ring),
        "recovery_matches_clean": (
            report["recovery"]["verdict_recovered"]
            and report["recovery"]["losses_bitwise_equal"]),
        "resume_bitwise": (report["resume"]["params_bitwise"]
                           and report["resume"]["ef_bitwise"]
                           and report["resume"]["losses_replayed"]),
    }
    report["gates"] = gates
    path = Path(out_path) if out_path else OUT
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(report, indent=2, sort_keys=True))
    print(f"wrote {path}", flush=True)
    for g, ok in gates.items():
        print(f"gate {g}: {'PASS' if ok else 'FAIL'}", flush=True)
        assert ok, f"resilience gate failed: {g}"
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--out", default=None,
                    help=f"report path (default {OUT})")
    args = ap.parse_args(argv)
    faults(args.out, steps=args.steps, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
