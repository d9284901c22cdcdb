"""compressed_allreduce's streaming strategies across real ranks: `ring`
(every rank's packed message buffers moved hop by hop, each arriving chunk
decoded the hop it arrives) and `rs_stream` (a dense reduce-scatter, each
rank encoding only its own shard, the packed shards on the ring), on n = 2
and 4 spawned CPU processes joined in one gloo group (launch/mesh.py), all
cases of an n in one group.

Held:

  (i)  every rank returns the same bytes; `ring` equals the port's own
       allgather wire path on the same inputs bitwise, outputs and error
       feedback (EF) residuals over 5 steps; the ring moves exactly
       sum over messages of (n - 1) x its chunks hops, and
       (n - 1) x sum of the messages' bytes each way; rs_stream's
       reduce-scatter moves its slices only.
  (ii) the reference's compressed_allreduce(strategy="ring" / "rs_stream",
       wire=True, stream_chunk_bytes=None / 64.0) under jax.shard_map on n
       virtual CPU devices, one subprocess a world size, started beside
       the ranks: bitwise, the 5 EF steps included, and rs_stream at d =
       10 on 4 ranks (shards 3, 3, 3, 1). The reference traces and
       compiles each case for about 3 s (an EF case of 5 steps about 14
       s), so it runs ref_cases(n): every case on 2 ranks and, on 4, each
       compressor under both strategies with the four (fusion, chunk)
       layouts spread over them, the EF cases and the d = 10 shards; (i)
       ties every other case to the allgather wire path, which
       test_torch_allreduce.py holds against the reference.
  (iii) the depth-2 pipeline: message m + 1's encode is issued before
       message m's decodes and hops.

Inputs: QSGD gets norm-exact units (test_torch_allreduce.py), whose sums
of squares are exact in any order, and so are the rank-order shard sums
of rs_stream; natural gets magnitudes in [2^-3, 2^3), where the
reference's CPU log2 / exp2 are exact. Under EF the QSGD encode input
e = x + m is the norm-exact one: each step's gradient is x = e - m
(exact in f32 on both sides).

This module imports no jax at module level: the spawned ranks import it.
"""
import dataclasses
import functools
import math
import os
import pathlib
import subprocess
import sys
import zlib
from typing import Optional, Tuple

import numpy as np
import pytest
import torch

from test_torch_allreduce import _bitwise, _norm_exact

ROOT = pathlib.Path(__file__).resolve().parents[1]
N_RANKS = (2, 4)
KEY_SEED = 11
EF_STEPS = 5
RANK_TIMEOUT = 240.0
REF_TIMEOUT = 600.0
TREES = {"mixed": [(("blocks", "w"), (3, 33)), (("embed",), (5, 13)),
                   (("gain",), ())],
         "d10": [(("w",), (10,))]}
COMP_KW = {"qsgd": (("levels", 16),)}


@dataclasses.dataclass(frozen=True)
class Case:
    comp: str
    strategy: str                  # ring | rs_stream
    fusion: float = 0.0
    chunk: Optional[float] = None
    steps: int = 1                 # > 1: error feedback over the steps
    tree: str = "mixed"
    gran: str = "layerwise"

    @property
    def ef(self) -> bool:
        return self.steps > 1

    @property
    def name(self) -> str:
        return (f"{self.comp}-{self.strategy}-f{self.fusion}-c{self.chunk}"
                f"-{self.gran}-{self.tree}"
                f"{f'-ef{self.steps}' if self.ef else ''}")


@functools.lru_cache(maxsize=None)
def ref_cases(n: int) -> Tuple[Case, ...]:
    """The cases also run by the reference (see the module docstring)."""
    if n == 2:
        return cases(n)
    layouts = [(0.0, 64.0), (math.inf, None), (math.inf, None), (0.0, 64.0),
               (0.0, None), (math.inf, 64.0), (math.inf, 64.0), (0.0, None),
               (0.0, 64.0), (math.inf, None)]
    single = [Case(comp, strategy, *layouts.pop(0))
              for comp in ("qsgd", "terngrad", "signsgd", "natural", "topk")
              for strategy in ("ring", "rs_stream")]
    return tuple(single + [c for c in cases(n) if c.ef or c.tree == "d10"
                           and c.comp != "terngrad"])


@functools.lru_cache(maxsize=None)
def cases(n: int) -> Tuple[Case, ...]:
    if n == 2:
        return (Case("qsgd", "ring", 0.0, 64.0),
                Case("topk", "rs_stream", math.inf),
                Case("signsgd", "ring", math.inf, 64.0),
                Case("terngrad", "rs_stream", 0.0, 64.0, gran="entire_model"),
                Case("qsgd", "ring", 0.0, None, steps=EF_STEPS))
    out = [Case(comp, strategy, fusion, chunk)
           for comp in ("qsgd", "terngrad", "signsgd", "natural", "topk")
           for strategy in ("ring", "rs_stream")
           for fusion in (0.0, math.inf)
           for chunk in (None, 64.0)]
    out += [Case("qsgd", "ring", 0.0, 64.0, steps=EF_STEPS),
            Case("topk", "ring", math.inf, None, steps=EF_STEPS),
            Case("topk", "rs_stream", 0.0, 64.0, steps=EF_STEPS),
            Case("qsgd", "ring", math.inf, 64.0, gran="entire_model"),
            Case("qsgd", "rs_stream", 0.0, None, tree="d10"),
            Case("terngrad", "rs_stream", 0.0, 0.0, tree="d10"),
            Case("topk", "rs_stream", 0.0, None, tree="d10")]
    return tuple(out)


# ---- inputs (numpy, shared by the ranks and the reference) ------------------

def _total(tree: str) -> int:
    return sum(math.prod(s) for _, s in TREES[tree])


def _units(case: Case):
    """(offset, dim) of each exec unit in the sorted-leaf flat vector."""
    total = _total(case.tree)
    if case.gran == "entire_model" or case.tree == "d10":
        return [(0, total)]
    return [(0, 33), (33, 33), (66, 33), (99, 65), (164, 1)]


def inputs(case: Case, n: int):
    """(n, steps, total) gradients (for QSGD under EF: the norm-exact encode
    inputs e) and (n, total) initial EF state (zeros without EF)."""
    rng = np.random.default_rng(zlib.crc32(f"{case.name}/{n}".encode()))
    shape = (n, case.steps, _total(case.tree))
    if case.comp == "qsgd":
        x = np.zeros(shape, np.float32)
        for r in range(n):
            for t in range(case.steps):
                for off, d in _units(case):
                    x[r, t, off:off + d] = _norm_exact(rng, d)
        m = (rng.integers(-8, 9, shape[::2]) / 64.0).astype(np.float32)
    elif case.comp == "natural":
        x = (rng.choice(np.float32([-1, 1]), shape)
             * 2.0 ** rng.uniform(-3, 3, shape)).astype(np.float32)
        x[..., ::9] = 0.0
        m = np.zeros(shape[::2], np.float32)
    else:
        x = rng.standard_normal(shape).astype(np.float32)
        m = (0.1 * rng.standard_normal(shape[::2])).astype(np.float32)
    return x, (m if case.ef else np.zeros_like(m))


def unflatten(flat, tree: str):
    """(..., total) -> nested dict of (..., *shape) arrays / tensors."""
    lead = flat.shape[:-1]
    out, off = {}, 0
    for path, shape in TREES[tree]:
        size = math.prod(shape)
        leaf = flat[..., off:off + size].reshape(lead + shape)
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
        off += size
    return out


def flatten(tree_, tree: str):
    """Nested dict of (*shape) leaves -> (total,) numpy, sorted leaves."""
    leaves = []
    for path, shape in TREES[tree]:
        leaf = tree_
        for k in path:
            leaf = leaf[k]
        leaves.append(np.asarray(leaf).reshape(-1))
    return np.concatenate(leaves)


def _tt(flat, tree):
    return unflatten(torch.from_numpy(np.ascontiguousarray(flat)), tree)


def port_config(case: Case, strategy: Optional[str] = None):
    from repro_torch.core import CompressionConfig, Granularity, \
        make_compressor
    return CompressionConfig(
        qw=make_compressor(case.comp, **dict(COMP_KW.get(case.comp, ()))),
        granularity=Granularity(case.gran),
        strategy=strategy or case.strategy, error_feedback=case.ef,
        fusion_bytes=case.fusion)


# ---- the ranks -------------------------------------------------------------

def _run(case: Case, strategy: str, rank: int, n: int):
    """Every step of `case` under `strategy` on this rank -> ((steps, total)
    outputs, final EF (total,), per-step collective counts)."""
    from repro_torch import random as R
    from repro_torch.core import (collectives, compressed_allreduce,
                                  stacked_mask)
    x, m0 = inputs(case, n)
    m = torch.from_numpy(m0[rank])
    sm = stacked_mask(_tt(x[rank, 0], case.tree))
    outs, per_step = [], []
    for t in range(case.steps):
        key = R.fold_in(R.key(KEY_SEED), t) if case.ef else R.key(KEY_SEED)
        xt = torch.from_numpy(x[rank, t])
        if case.ef and case.comp == "qsgd":
            xt = xt - m                        # e = x + m is norm-exact
        collectives.reset_counts()
        agg, ef = compressed_allreduce(
            unflatten(xt, case.tree), sm, port_config(case, strategy), None,
            key, n, ef_state=unflatten(m, case.tree) if case.ef else None,
            wire=True, stream_chunk_bytes=case.chunk)
        per_step.append({c: collectives.counts(c)
                         for c in collectives.COLLECTIVES})
        outs.append(flatten(agg, case.tree))
        if case.ef:
            m = torch.from_numpy(flatten(ef, case.tree))
    return np.stack(outs), m.numpy(), per_step


def _pipeline_events(rank: int, n: int):
    """The executor's encode / decode / hop calls on one 3-message ring
    step with 64-byte chunks, in issue order."""
    from repro_torch.core import wire
    case = Case("qsgd", "ring", 0.0, 64.0)
    log = []
    cls = wire.QSGDCodec
    saved = (cls.encode_buckets, cls.decode_accumulate_buckets,
             wire.collectives.ring_shift)

    def enc(self, es, keys):
        log.append(("encode", len(es)))
        return saved[0](self, es, keys)

    def dec(self, pays, accs, slot, dims):
        log.append(("decode", len(pays)))
        return saved[1](self, pays, accs, slot, dims)

    def hop(t, group=None):
        log.append(("hop", t.numel()))
        return saved[2](t, group)
    cls.encode_buckets, cls.decode_accumulate_buckets = enc, dec
    wire.collectives.ring_shift = hop
    try:
        _run(case, "ring", rank, n)
    finally:
        (cls.encode_buckets, cls.decode_accumulate_buckets,
         wire.collectives.ring_shift) = saved
    return log


def _traced(rank: int, n: int):
    """One QSGD ring and one rs_stream step (per-bucket messages, 64-byte
    chunks) with a TraceRecorder: its message and hop span counts, the
    hop spans' args, and whether the output equals the untraced step's."""
    from repro_torch import random as R
    from repro_torch.core import compressed_allreduce, stacked_mask
    from repro_torch.obs import TraceRecorder
    out = {}
    for strategy in ("ring", "rs_stream"):
        case = Case("qsgd", strategy, 0.0, 64.0)
        x, _ = inputs(case, n)
        t = unflatten(torch.from_numpy(x[rank, 0]), case.tree)
        sm = stacked_mask(t)
        cfg = port_config(case, strategy)
        kw = dict(wire=True, stream_chunk_bytes=case.chunk)
        bare, _ = compressed_allreduce(t, sm, cfg, None, R.key(KEY_SEED), n,
                                       **kw)
        rec = TraceRecorder(pid=rank)
        got, _ = compressed_allreduce(t, sm, cfg, None, R.key(KEY_SEED), n,
                                      recorder=rec, **kw)
        s = rec.finalize_step(0)
        out[strategy] = {
            "message_spans": s["n_message_spans"],
            "hops": [e["args"] for e in rec.span_events(step=0)
                     if e["args"]["stage"] == "hop"],
            "same": np.array_equal(flatten(got, case.tree),
                                   flatten(bare, case.tree))}
    return out


def rank_main(rank, n, dev):
    torch.set_num_threads(1)
    out = {}
    for case in cases(n):
        out[case.name] = _run(case, case.strategy, rank, n)
        if case.strategy == "ring":
            out[case.name + "/allgather"] = _run(case, "allgather", rank, n)
    out["pipeline"] = _pipeline_events(rank, n)
    out["traced"] = _traced(rank, n)
    return out


@functools.lru_cache(maxsize=None)
def rank_results(n: int):
    from repro_torch.launch.mesh import run_ranks
    return run_ranks(rank_main, n, backend="gloo", device="cpu",
                     timeout=RANK_TIMEOUT)


def _layouts(case: Case, n: int):
    """The port's message layouts of `case` (shard layouts under rs)."""
    from repro_torch.core import build_plan, build_schedule, stacked_mask, \
        wire_codec
    from repro_torch.core.wire import message_layouts, shard_message_layouts
    cfg = port_config(case)
    g = _tt(np.zeros(_total(case.tree), np.float32), case.tree)
    sched = build_schedule(build_plan(g, stacked_mask(g), cfg.granularity),
                           case.fusion)
    codec = wire_codec(cfg.qw)
    if case.strategy == "ring":
        return sched, message_layouts(sched, codec)
    return sched, shard_message_layouts(sched, codec, n)


@pytest.mark.timeout(300)
@pytest.mark.parametrize("n", N_RANKS)
def test_stream_across_ranks(n):
    from repro_torch.core.wire import _shard_dim, layout_chunks
    results = rank_results(n)
    for case in cases(n):
        outs = [r[case.name] for r in results]
        for r in range(1, n):
            _bitwise(outs[r][0], outs[0][0], (case.name, "rank", r))
        assert np.isfinite(outs[0][0]).all(), case.name
        if case.strategy == "ring":
            for r in range(n):
                ag = results[r][case.name + "/allgather"]
                _bitwise(outs[r][0], ag[0], (case.name, "== allgather", r))
                if case.ef:
                    _bitwise(outs[r][1], ag[1], (case.name, "EF", r))
        sched, layouts = _layouts(case, n)
        hops = sum((n - 1) * len(layout_chunks(lay, case.chunk))
                   for lay in layouts)
        ring_bytes = (n - 1) * sum(lay.total_nbytes for lay in layouts)
        for r in range(n):
            for counts in outs[r][2]:
                rs = counts["ring_shift"]
                assert (rs["calls"], rs["sent_bytes"], rs["recv_bytes"]) \
                    == (hops, ring_bytes, ring_bytes), (case.name, rs)
                assert counts["all_gather"]["calls"] == 0, case.name
                red = counts["reduce_scatter"]
                if case.strategy == "ring":
                    assert red["calls"] == 0, case.name
                    continue
                # one reduce-scatter a bucket: n - 1 slices of
                # (units, ceil(d / n)) f32 each way
                plan = sched.plan
                want = sum((n - 1) * 4 * b.n * _shard_dim(b.dim, n)
                           for b in plan.buckets)
                assert (red["calls"], red["sent_bytes"], red["recv_bytes"]) \
                    == (len(plan.buckets), want, want), (case.name, red)


def test_pipeline_issues_the_next_encode_before_the_hops():
    """On 2 ranks, a 3-message ring step with 64-byte chunks issues
    encode(0), then per message m: encode(m + 1) (while there is one),
    the own decode of m, and for each hop every chunk's shift and its
    decode."""
    from repro_torch.core.wire import layout_chunks
    n = 2
    case = Case("qsgd", "ring", 0.0, 64.0)
    _, layouts = _layouts(case, n)
    assert len(layouts) == 3
    want = [("encode", len(layouts[0].bucket_ids))]
    for m, lay in enumerate(layouts):
        if m + 1 < len(layouts):
            want.append(("encode", len(layouts[m + 1].bucket_ids)))
        want.append(("decode", len(lay.bucket_ids)))
        for _ in range(n - 1):
            for run, start, stop in layout_chunks(lay, case.chunk):
                want += [("hop", stop - start), ("decode", len(run))]
    for r in rank_results(n):
        assert r["pipeline"] == want


def test_chunk_runs():
    """The hop-granularity grouping (the reference's own cases): greedy
    fusion of consecutive regions under the chunk budget, regions never
    split."""
    from repro_torch.kernels.ops import chunk_runs
    assert chunk_runs([10, 20, 30], None) == ((0, 1, 2),)
    assert chunk_runs([10, 20, 30], math.inf) == ((0, 1, 2),)
    assert chunk_runs([10, 20, 30], 0) == ((0,), (1,), (2,))
    assert chunk_runs([10, 20, 30], 30.0) == ((0, 1), (2,))
    assert chunk_runs([100, 20, 30], 30.0) == ((0,), (1, 2))
    assert chunk_runs([], 64.0) == ()
    with pytest.raises(ValueError):
        chunk_runs([10], -1.0)


def test_stream_errors_before_any_collective():
    """The reference's ValueErrors: a streaming strategy without wire=True,
    an unknown executor mode; the fault hook a later slice ports. The
    recorder hook is ported: it reaches the group check, and on 2 ranks
    (test_stream_across_ranks's spawn) a traced ring / rs_stream step
    gives the reference's structure — a message span a message, n_messages
    x (n - 1) hop spans with their message's attribution — and the
    untraced step's output."""
    from repro_torch import random as R
    from repro_torch.core import (build_plan, build_schedule,
                                  compressed_allreduce, stacked_mask,
                                  wire_codec)
    from repro_torch.core.wire import execute_schedule_stream
    case = Case("qsgd", "ring")
    g = _tt(np.zeros(165, np.float32), "mixed")
    for strategy in ("ring", "rs_stream"):
        with pytest.raises(ValueError, match="pass wire=True"):
            compressed_allreduce(g, stacked_mask(g),
                                 port_config(case, strategy), None,
                                 R.key(0), 2)
    cfg = port_config(case)
    sched = build_schedule(build_plan(g, stacked_mask(g), cfg.granularity),
                           0.0)
    codec = wire_codec(cfg.qw)
    with pytest.raises(ValueError, match="mode must be"):
        execute_schedule_stream(sched, codec, None, g, None, R.key(0),
                                n_workers=2, mode="tree")
    for kw, queue in (({"faults": object()}, r"item 7 \("),):
        with pytest.raises(NotImplementedError, match=f"Queue 1, {queue}"):
            execute_schedule_stream(sched, codec, None, g, None, R.key(0),
                                    n_workers=2, **kw)
    from repro_torch.obs import TraceRecorder
    with pytest.raises(ValueError, match="Default process group"):
        execute_schedule_stream(sched, codec, None, g, None, R.key(0),
                                n_workers=2, recorder=TraceRecorder())
    n = 2
    for strategy in ("ring", "rs_stream"):
        sched, _ = _layouts(Case("qsgd", strategy, 0.0, 64.0), n)
        for r in rank_results(n):
            tr = r["traced"][strategy]
            assert tr["same"], strategy
            assert tr["message_spans"] == sched.num_messages
            assert len(tr["hops"]) == sched.num_messages * (n - 1)
            for mi, a in enumerate(tr["hops"]):
                msg = sched.messages[mi]
                assert (a["message"], tuple(a["bucket_ids"]),
                        a["codec"]) == (mi, msg.bucket_ids, codec.name)


# ---- the reference under shard_map (one subprocess a world size) -----------

def reference_main(out_path: str, n: int) -> None:
    """Run ref_cases(n) through the reference's compressed_allreduce under
    jax.shard_map on n virtual CPU devices, one jit a case, and save the
    outputs (each step's, and the final EF)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from test_torch_ref import reference

    def jflat(tree_):
        return jnp.concatenate([leaf.reshape(-1) for leaf in
                                jax.tree_util.tree_leaves(tree_)])
    res = {}
    with reference() as ref:
        import repro.core.aggregation as A
        mesh = jax.sharding.Mesh(np.array(jax.devices()[:n]), ("data",))
        for c in ref_cases(n):
            def f(x, m, c=c):
                x, m = x[0], m[0]
                cfg = ref.core.CompressionConfig(
                    qw=ref.core.make_compressor(
                        c.comp, **dict(COMP_KW.get(c.comp, ()))),
                    granularity=ref.core.Granularity(c.gran),
                    strategy=c.strategy, error_feedback=c.ef,
                    fusion_bytes=c.fusion)
                sm = ref.core.stacked_mask(unflatten(x[0], c.tree))
                ys = []
                for t in range(c.steps):
                    key = jax.random.key(KEY_SEED)
                    if c.ef:
                        key = jax.random.fold_in(key, t)
                    xt = x[t] - m if c.ef and c.comp == "qsgd" else x[t]
                    agg, ef = A.compressed_allreduce(
                        unflatten(xt, c.tree), sm, cfg, ("data",), key, n,
                        ef_state=unflatten(m, c.tree) if c.ef else None,
                        wire=True, stream_chunk_bytes=c.chunk)
                    ys.append(jflat(agg))
                    if c.ef:
                        m = jflat(ef)
                return jnp.stack(ys)[None], m[None]
            ys, m = jax.jit(jax.shard_map(
                f, mesh=mesh, in_specs=(P("data"), P("data")),
                out_specs=(P("data"), P("data")), check_vma=False))(
                    *inputs(c, n))
            res[c.name] = np.asarray(ys)
            res[c.name + "/ef"] = np.asarray(m)
    np.savez(out_path, **res)


@pytest.fixture(scope="module", autouse=True)
def reference_run(tmp_path_factory):
    """Start the reference's subprocesses (one a world size) with the
    module's first test, so they run beside the ranks; the test that needs
    one waits for it."""
    tmp = tmp_path_factory.mktemp("stream")
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           str(ROOT / "tests")]))
    procs = {n: subprocess.Popen(
        [sys.executable, "-c", "import sys, test_torch_stream as t; "
         "t.reference_main(sys.argv[1], int(sys.argv[2]))",
         str(tmp / f"reference{n}.npz"), str(n)],
        env=env, cwd=str(ROOT / "tests"), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for n in N_RANKS}
    box = {}

    def result(n):
        if n not in box:
            log, _ = procs[n].communicate(timeout=REF_TIMEOUT)
            assert procs[n].returncode == 0, log[-4000:]
            box[n] = dict(np.load(tmp / f"reference{n}.npz"))
        return box[n]
    yield result
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


@pytest.mark.timeout(660)
@pytest.mark.parametrize("n", N_RANKS)
def test_stream_matches_reference(n, reference_run):
    results = rank_results(n)
    ref = reference_run(n)
    for case in ref_cases(n):
        want = ref[case.name]
        for r in range(n):
            _bitwise(want[r], want[0], (case.name, "reference device", r))
            _bitwise(results[r][case.name][0], want[r], (case.name, r))
            if case.ef:
                _bitwise(results[r][case.name][1],
                         ref[case.name + "/ef"][r], (case.name, "ef", r))
