"""The port's resilience plane (repro_torch/resil/, the faults= hooks of
core/wire.py and core/aggregation.py) against the JAX package's.

Held bitwise against the reference on the same inputs and keys: the
injector's corrupted bytes for each mode, prob, n_bits and start; the
Fletcher-32 word at the sizes that straddle the reference's chunked
reduction (and the port's own spans); the serialized wire executors under
prob=1 bit flips and truncation, with and without resend, over the six
codecs of the fault campaign x both granularities (trees, EF residuals,
buffers, verdicts; ROADMAP Queue 3 item 6: for these input families
every decoded value is an exact product, so the reference's jitted
residual is its eager one bit for bit); aggregate_simulated_workers(
faults=, alive=) with its counters; the
ring, rs and allgather wire paths on 4 gloo ranks against the reference
on 4 virtual devices (tests/fault_checks.py's checks, one reference
subprocess and one rank spawn). train_resilient on the reference's toy
runner under corruption, the dense fallback and partial participation:
counters equal, losses within 1e-5 relative, params within Queue 3 item
15's rule; resume and resend-equals-clean bitwise within the port.

Inputs: random normal gradients, except QSGD (norm-exact, the l2 norm
is in its payload: Queue 3 item 1) and natural compression (signed powers
of two, whose exponents are exact in both packages: Queue 3 item 4).
"""
import math
import os
import subprocess
import sys
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_aggregation import N_WORKERS, _norm_exact_flat, _unflatten
from test_torch_ref import ROOT, jkey, key_data, reference, tkeys
from test_torch_wire import _to_jax, _to_torch

REF_TIMEOUT = 900
RING_N = 4

SIX = [
    ("topk", {"ratio": 0.25}),
    ("randomk", {"ratio": 0.3, "scale": True}),
    ("qsgd", {"levels": 16}),
    ("terngrad", {}),
    ("signsgd", {}),
    ("natural", {}),
]
GRANS = ("layerwise", "entire_model")


def _bits_equal(a, b, ctx=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (ctx, a.shape, b.shape,
                                                       a.dtype, b.dtype)
    assert a.tobytes() == b.tobytes(), ctx


def _leaves(tree):
    from repro_torch.convert import tree_leaves
    return [np.asarray(l) for l in tree_leaves(tree)]


def _received_equal(want, got, name, ctx=""):
    """A tree decoded from RECEIVED (possibly corrupted) bytes against the
    reference's (ROADMAP Queue 3 item 21): bitwise, except that XLA's CPU
    code flushes a subnormal product of garbage fields to zero where the
    port keeps it, and natural compression's corrupted exponent fields
    decode through the reference's inexact jnp.exp2 (within 4e-6
    relative)."""
    want, got = np.asarray(want), np.asarray(got)
    flushed = (want == 0) & (np.abs(got) < np.finfo(np.float32).tiny)
    got = np.where(flushed, want, got)
    if name != "natural":
        _bits_equal(want, got, ctx)
        return
    np.testing.assert_allclose(got, want, rtol=4e-6, atol=0,
                               equal_nan=True, err_msg=str(ctx))


def _trees_equal(a, b, ctx=""):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb), ctx
    for i, (x, y) in enumerate(zip(la, lb)):
        _bits_equal(x, y, (ctx, i))


#: the wire cases' tree: a stacked leaf of 3 units and a matrix, so a
#: layerwise step has 2 messages (tags 0 and 1) and an entire-model one 1
WIRE_SHAPES = {"blocks": {"w": (3, 16, 8)}, "embed": (20, 4)}


def _plan(gran):
    from repro_torch.core.granularity import Granularity, stacked_mask
    from repro_torch.core.plan import build_plan
    tree = {"blocks": {"w": torch.zeros(WIRE_SHAPES["blocks"]["w"])},
            "embed": torch.zeros(WIRE_SHAPES["embed"])}
    return build_plan(tree, stacked_mask(tree), Granularity(gran))


def _grads(name, gran, seed):
    """(N_WORKERS, ...) gradient trees for codec `name` (module doc)."""
    plan = _plan(gran)
    rng = np.random.default_rng(seed)
    if name == "qsgd":
        flat = _norm_exact_flat(plan, rng)
    elif name == "natural":
        flat = (rng.choice(np.float32([-1, 1]), (N_WORKERS, plan.total))
                * np.exp2(rng.integers(-4, 3, (N_WORKERS, plan.total)))
                ).astype(np.float32)
    else:
        flat = rng.standard_normal((N_WORKERS, plan.total)).astype(np.float32)
    return plan, _unflatten(plan, flat)


# ---- the injector ------------------------------------------------------------

INJECT = [("bitflip", 1.0, 1, 0), ("bitflip", 1.0, 3, 12),
          ("bitflip", 0.5, 2, 8), ("truncate", 1.0, 1, 0),
          ("truncate", 0.5, 1, 12), ("drop_hop", 1.0, 1, 8),
          ("dup_hop", 0.5, 1, 8)]


@pytest.mark.parametrize("mode,prob,n_bits,start", INJECT,
                         ids=[f"{m}-{p}-{b}-{s}" for m, p, b, s in INJECT])
def test_injector_bytes_bitwise(mode, prob, n_bits, start):
    """corrupt (a (B, nbytes) batch with (B, 2) keys against the
    reference's per-row calls) and corrupt_hop (one buffer, the step
    key) give the reference's bytes for every tag; a pass-through is the
    very same object."""
    from repro_torch import random as R
    from repro_torch.resil import FaultInjector
    from repro_torch.sim import CorruptionSpec
    rng = np.random.default_rng(hash((mode, prob, n_bits, start)) % 2**32)
    bufs = rng.integers(0, 256, (6, 97), dtype=np.uint8)
    stale = rng.integers(0, 256, (97,), dtype=np.uint8)
    spec = CorruptionSpec(prob=prob, mode=mode, n_bits=n_bits, seed=11)
    inj = FaultInjector(spec)
    with reference("repro.resil", "repro.sim") as ref:
        jinj = ref.resil.FaultInjector(ref.sim.CorruptionSpec(
            prob=prob, mode=mode, n_bits=n_bits, seed=11))
        keys = [jax.random.fold_in(jkey(3), i) for i in range(6)]
        tk = tkeys(np.stack([key_data(k) for k in keys]))
        for tag in (0, 5, (2 << 12) | 3):
            if mode in ("drop_hop", "dup_hop"):
                for i in range(6):
                    want = jinj.corrupt_hop(jnp.asarray(bufs[i]),
                                            jnp.asarray(stale), keys[i],
                                            tag=tag, start=start)
                    got = inj.corrupt_hop(torch.from_numpy(bufs[i]),
                                          torch.from_numpy(stale), tk[i],
                                          tag=tag, start=start)
                    _bits_equal(want, got.numpy(), (tag, i))
                b = torch.from_numpy(bufs)
                assert inj.corrupt(b, tk, tag=tag) is b
                continue
            want = np.stack([np.asarray(jinj.corrupt(
                jnp.asarray(bufs[i]), keys[i], tag=tag, start=start))
                for i in range(6)])
            got = inj.corrupt(torch.from_numpy(bufs), tk, tag=tag,
                              start=start)
            _bits_equal(want, got.numpy(), tag)
            one = inj.corrupt(torch.from_numpy(bufs[2]), tk[2], tag=tag,
                              start=start)
            _bits_equal(want[2], one.numpy(), (tag, "1-d"))
            assert (want[:, :start] == bufs[:, :start]).all()
    zero = FaultInjector(CorruptionSpec(prob=0.0, mode=mode))
    b = torch.from_numpy(bufs)
    assert zero.corrupt(b, R.key(0)[None].expand(6, 2), tag=1) is b
    b0 = b[0]
    assert zero.corrupt_hop(b0, b[1], R.key(0), tag=1) is b0
    assert zero.take_flags().shape == (0,)


def _fletcher_serial(data: bytes) -> int:
    if len(data) % 2:
        data = data + b"\x00"
    s1, s2 = 1, 0
    w = np.frombuffer(data, np.uint16).astype(np.int64)
    for v in w.tolist():
        s1 = (s1 + v) % 65535
        s2 = (s2 + s1) % 65535
    return (s2 << 16) | s1


@pytest.mark.parametrize("size", [0, 7, 65534, 65535, 65536, 65537, 200001])
def test_fletcher32_chunked_bitwise(size, monkeypatch):
    """The port's Fletcher-32, in one span and in spans of 4,096 and
    65,538 bytes (the full-width path's exact span sum), equals the
    reference's staged reduction and the byte-serial loop, on one buffer
    and on a batch of three."""
    from repro_torch.core import wire
    rng = np.random.default_rng(size)
    data = rng.integers(0, 256, (3, size), dtype=np.uint8)
    with reference() as ref:
        want = [int(ref.wire.fletcher32(jnp.asarray(d))) for d in data]
    assert want[0] == _fletcher_serial(data[0].tobytes())
    for span in (wire.FLETCHER_SPAN, 4096, 65538):
        monkeypatch.setattr(wire, "FLETCHER_SPAN", span)
        assert wire.fletcher32(torch.from_numpy(data)).tolist() == want, span
        assert int(wire.fletcher32(torch.from_numpy(data[1]))) == want[1]


# ---- the reference's runs: one subprocess, beside the port's tests -----------

# (codec, kwargs, granularity, mode, resend): the six codecs x both
# granularities, each under one of the four (mode, resend) pairs in turn
WIRE_CASES = [(name, kw, gran, *(("bitflip", False), ("bitflip", True),
                                  ("truncate", False),
                                  ("truncate", True))[i % 4])
              for i, ((name, kw), gran) in enumerate(
                  (c, g) for c in SIX for g in GRANS)]
WIRE_IDS = [f"{n}-{g}-{m}-{'resend' if r else 'noresend'}"
            for n, _, g, m, r in WIRE_CASES]
ALIVE = (True, False, True, True)


def _wire_inputs(name, gran, i):
    """Worker gradients and EF residuals of wire case i (numpy trees)."""
    plan, wg = _grads(name, gran, 100 + i)
    if name in ("qsgd", "natural"):
        # m = 0 keeps e = x + m norm-exact, or signed powers of two
        m = np.zeros((N_WORKERS, plan.total), np.float32)
    else:
        m = (np.random.default_rng(200 + i).standard_normal(
            (N_WORKERS, plan.total)) * 0.25).astype(np.float32)
    return wg, _unflatten(plan, m)


def _per_worker(tree):
    return {k: ({kk: vv[0] for kk, vv in v.items()} if isinstance(v, dict)
                else v[0]) for k, v in tree.items()}


def _ring_tree():
    rng = np.random.default_rng(33)
    return {"dense": rng.standard_normal((8, 16)).astype(np.float32),
            "blocks": rng.standard_normal((3, 4, 10)).astype(np.float32)}


# (tag, strategy, spec kwargs or None, resend, chunk, fusion):
# fault_checks.py's runs, plus rs_stream; a "_c64" run fuses both buckets
# into one message whose two regions ride the ring as two 64-byte-budget
# chunks (per-bucket messages have one region, so one chunk)
RING_RUNS = [
    ("ring_clean", "ring", None, True, None, 0.0),
    ("ring_flip_resend", "ring", dict(prob=1.0, seed=5), True, None, 0.0),
    ("ring_flip_resend_c64", "ring", dict(prob=1.0, seed=5), True, 64.0,
     math.inf),
    ("ring_flip", "ring", dict(prob=1.0, seed=5), False, None, 0.0),
    ("ring_flip_c64", "ring", dict(prob=1.0, seed=5), False, 64.0, math.inf),
    ("ring_drop", "ring", dict(prob=1.0, mode="drop_hop", seed=6), True,
     None, 0.0),
    ("ring_dup", "ring", dict(prob=1.0, mode="dup_hop", seed=8), True, None,
     0.0),
    ("ring_prob0", "ring", dict(prob=0.0), True, None, 0.0),
    ("ag_clean", "allgather", None, True, None, 0.0),
    ("ag_flip_resend", "allgather", dict(prob=1.0, seed=9), True, None, 0.0),
    ("ag_flip", "allgather", dict(prob=1.0, seed=9), False, None, 0.0),
    ("rs_clean", "rs_stream", None, True, None, 0.0),
    ("rs_flip_resend", "rs_stream", dict(prob=1.0, seed=10), True, None,
     0.0),
    ("rs_flip", "rs_stream", dict(prob=1.0, seed=10), False, None, 0.0),
]
#: the runs the reference makes too: dropped and duplicated (stale) hops,
#: and byte-level corruption of chunked ring hops and of the allgather's
#: received regions, none of it resent, so every corrupted byte reaches
#: the result. The resent and prob-0 runs are the port's clean ring and
#: allgather bit for bit (test_ring_and_allgather_faults_across_ranks),
#: which tests/test_torch_stream.py holds against the reference.
REF_RING_RUNS = ("ring_flip_c64", "ring_drop", "ring_dup", "ag_flip")
EF_STEPS = 3
RING_KEY = 7


def ToyRunner():
    """The reference's tests/test_resil.py ToyRunner (its
    benchmarks/faults.py _MlpRunner: a linear softmax classifier on the
    non-IID sampler) on the port, its init 0.1 x random.normal (jax's
    draw), on the CPU."""
    from repro_torch.faults import _MlpRunner
    return _MlpRunner("cpu")


# (name, scenario kwargs, recovery kwargs, steps, seed) of the
# train_resilient runs held against the reference
TRAIN_RUNS = [
    ("corrupt", dict(corruption=dict(prob=0.5, seed=5)), {}, 4, 1),
    ("fallback", dict(corruption=dict(prob=1.0, seed=4)),
     dict(resend=False, dense_fallback_after=2), 4, 4),
    ("straggle", dict(straggler=dict(prob=0.5, delay_us=1e6, seed=13)),
     dict(straggler_timeout_us=10.0), 3, 5),
]
#: the first runs of TRAIN_RUNS the reference makes too
REF_TRAIN_RUNS = len(TRAIN_RUNS)


def _ref_train_runs(ref):
    """The reference's train_resilient over TRAIN_RUNS on its ToyRunner."""
    import jax.scipy.special

    class JRunner:
        categories, global_batch = 4, 8

        def init(self, key):
            return {"w": 0.1 * jax.random.normal(key, (16, 4)),
                    "b": jnp.zeros((4,))}

        def loss(self, params, batch, key):
            x = batch["images"].reshape(batch["images"].shape[0], -1)
            logits = x @ params["w"] + params["b"]
            lse = jax.scipy.special.logsumexp(logits, axis=-1)
            picked = jnp.take_along_axis(
                logits, batch["labels"][:, None].astype(jnp.int32),
                1)[:, 0]
            return jnp.mean(lse - picked)

        def worker_batch(self, key, props, per):
            return ref.synthetic.noniid_classification_batch(
                key, props, per, classes=4, hw=4, channels=1)

    res = {}
    for name, scen, rec, steps, seed in TRAIN_RUNS[:REF_TRAIN_RUNS]:
        sc = ref.sim.Scenario(
            name=name, n_workers=4,
            corruption=ref.sim.CorruptionSpec(**scen.get("corruption", {})),
            straggler=ref.sim.StragglerSpec(**scen.get("straggler", {})))
        comp = ref.core.CompressionConfig(
            qw=ref.core.make_compressor("topk", ratio=0.25),
            granularity=ref.core.Granularity("layerwise"),
            error_feedback=True, integrity=True)
        out = ref.resil.train_resilient(
            JRunner(), sc, comp, steps=steps, seed=seed,
            recovery=ref.resil.RecoveryConfig(**rec))
        res[f"train/{name}/losses"] = np.asarray(out["losses"])
        for k, v in out["counters"].items():
            res[f"train/{name}/{k}"] = np.asarray(v)
        res[f"train/{name}/fallback"] = np.asarray(out["fallback_active"])
        for part in ("params", "ef"):
            for k, v in out[part].items():
                res[f"train/{name}/{part}/{k}"] = np.asarray(v)
    return res


def _ref_wire_cases(ref):
    res = {}
    for i, (name, kw, gran, mode, resend) in enumerate(WIRE_CASES):
        wg, m = _wire_inputs(name, gran, i)
        jone = _to_jax(_per_worker(wg))
        sched = ref.core.build_schedule(ref.core.build_plan(
            jone, ref.core.stacked_mask(jone), ref.core.Granularity(gran)),
            0.0)
        codec = ref.wire.wire_codec(ref.core.make_compressor(name, **kw),
                                    integrity=True)

        def run(g, mm, k, sched=sched, codec=codec, mode=mode,
                resend=resend):
            inj = ref.resil.FaultInjector(ref.sim.CorruptionSpec(
                prob=1.0, mode=mode, seed=3), resend=resend)
            t, mn, bufs = sched.execute_with_state(None, g, mm, k,
                                                   wire=codec, faults=inj)
            return {"tree": t, "ef": mn, "buf": bufs,
                    "flags": inj.take_flags()}
        key = jax.random.fold_in(jkey(21), i)
        wkeys = jax.vmap(lambda j: jax.random.fold_in(key, j))(
            jnp.arange(N_WORKERS))
        outs = jax.jit(jax.vmap(run))(_to_jax(wg), _to_jax(m), wkeys)
        for part, tree in outs.items():
            if part.startswith("flags"):
                res[f"wire/{i}/{part}"] = np.asarray(tree)
                continue
            for j, leaf in enumerate(jax.tree_util.tree_leaves(tree)):
                res[f"wire/{i}/{part}/{j}"] = np.asarray(leaf)
    return res


def _ref_aggregate(ref):
    wg, m = _wire_inputs("topk", "layerwise", 99)
    jone = _to_jax(_per_worker(wg))
    cfg = ref.core.CompressionConfig(
        qw=ref.core.make_compressor("topk", ratio=0.25),
        granularity=ref.core.Granularity("layerwise"),
        error_feedback=True, integrity=True)

    def agg(g, mm, k):
        inj = ref.resil.FaultInjector(ref.sim.CorruptionSpec(
            prob=1.0, seed=3), resend=False)
        return ref.aggregation.aggregate_simulated_workers(
            g, ref.core.stacked_mask(jone), cfg, k, ef_state=mm, wire=True,
            faults=inj, alive=np.array(ALIVE))
    out, ef, info = jax.jit(agg)(_to_jax(wg), _to_jax(m), jkey(31))
    res = {}
    for part, tree in (("out", out), ("ef", ef)):
        for j, leaf in enumerate(jax.tree_util.tree_leaves(tree)):
            res[f"agg/{part}/{j}"] = np.asarray(leaf)
    for k, v in info.items():
        res[f"agg/info/{k}"] = np.asarray(v)
    return res


def _ref_ring(ref):
    from jax.sharding import PartitionSpec as P
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:RING_N]), ("data",))
    t = _to_jax(_ring_tree())
    sm = ref.core.stacked_mask(t)

    def flat(tree):
        return jnp.concatenate([x.reshape(-1) for x in
                                jax.tree_util.tree_leaves(tree)])

    def f(g, key):
        i = jax.lax.axis_index("data").astype(jnp.float32)
        g = jax.tree_util.tree_map(lambda x: x * (1.0 + i), g)
        outs = {}

        def one(tag, strat, spec, resend, chunk, fusion):
            cfg = ref.core.CompressionConfig(
                qw=ref.core.make_compressor("topk", ratio=0.25),
                granularity=ref.core.Granularity("layerwise"),
                strategy=strat, integrity=True, fusion_bytes=fusion)
            inj = ref.resil.FaultInjector(ref.sim.CorruptionSpec(**spec),
                                          resend=resend)
            o, _ = ref.aggregation.compressed_allreduce(
                g, sm, cfg, ("data",), key, RING_N, wire=True, faults=inj,
                stream_chunk_bytes=chunk)
            outs[tag] = flat(o)
            flags = inj.take_flags()
            outs[tag + "/det"] = jax.lax.psum(
                jnp.sum(~flags).astype(jnp.int32), ("data",))
            outs[tag + "/msgs"] = jnp.asarray(flags.size, jnp.int32)
        for run in RING_RUNS:
            if run[0] in REF_RING_RUNS:
                one(*run)
        return outs
    outs = jax.jit(jax.shard_map(f, mesh=mesh, in_specs=(P(), P()),
                                 out_specs=P(), check_vma=False))(
        t, jkey(RING_KEY))
    return {f"ring/{k}": np.asarray(v) for k, v in outs.items()}


#: the reference's sections, in the order the subprocess writes them
SECTIONS = (("wire", "_ref_wire_cases"), ("agg", "_ref_aggregate"),
            ("train", "_ref_train_runs"), ("ring", "_ref_ring"))


def reference_main(out_dir: str) -> None:
    """Every reference run the module holds the port against, in one
    process on 4 virtual CPU devices (XLA_FLAGS set before jax starts),
    each section saved to out_dir/<section>.npz as soon as it is done:
    the wire cases (jitted, vmapped over the workers), the faulted
    simulated aggregate with alive=, train_resilient on the toy runner
    and the ring / allgather runs under jax.shard_map, in the order the
    tests read them."""
    with reference("repro.resil", "repro.sim", "repro.core.aggregation",
                   "repro.data") as ref:
        for section, fn in SECTIONS:
            res = globals()[fn](ref)
            tmp = os.path.join(out_dir, section + ".tmp.npz")
            np.savez(tmp, **res)
            os.replace(tmp, os.path.join(out_dir, section + ".npz"))


@pytest.fixture(scope="module", autouse=True)
def reference_run(tmp_path_factory):
    """Start the reference's subprocess with the module's first test (one
    XLA thread, so it runs beside the port's cases and ranks);
    reference_run(section) waits for that section's file only."""
    out = tmp_path_factory.mktemp("resil")
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4 "
                         "--xla_cpu_multi_thread_eigen=false "
                         "intra_op_parallelism_threads=1",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           str(ROOT / "tests")]))
    proc = subprocess.Popen(
        [sys.executable, "-c", "import sys, test_torch_resil as t; "
         "t.reference_main(sys.argv[1])", str(out)],
        env=env, cwd=str(ROOT / "tests"), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    box = {}

    def result(section):
        if section not in box:
            path = out / (section + ".npz")
            deadline = time.monotonic() + REF_TIMEOUT
            while not path.exists():
                if proc.poll() is not None and not path.exists():
                    log = proc.stdout.read()
                    raise AssertionError(f"reference run ended without "
                                         f"{section}: {log[-4000:]}")
                assert time.monotonic() < deadline, section
                time.sleep(0.1)
            box[section] = dict(np.load(path))
        return box[section]
    yield result
    if proc.poll() is None:
        proc.kill()
    proc.communicate()


# ---- port-only checks (they run while the reference works) -------------------

def test_faults_need_wire_and_prob0_is_the_clean_path():
    """faults= without wire=True raises the reference's ValueError on both
    entry points; a prob-0 injector runs the clean path bit for bit, notes
    nothing and counts 0 messages (int32 counters)."""
    from repro_torch import random as R
    from repro_torch.core import (CompressionConfig, Granularity,
                                  aggregate_simulated_workers,
                                  compressed_allreduce, make_compressor,
                                  stacked_mask)
    from repro_torch.resil import FaultInjector
    from repro_torch.sim import CorruptionSpec
    wg, _ = _wire_inputs("topk", "layerwise", 5)
    tg = _to_torch(wg)
    sm = stacked_mask(_per_worker(tg))
    cfg = CompressionConfig(qw=make_compressor("topk", ratio=0.25),
                            granularity=Granularity("layerwise"),
                            integrity=True)
    inj = FaultInjector(CorruptionSpec(prob=1.0))
    with pytest.raises(ValueError, match="pass wire=True"):
        aggregate_simulated_workers(tg, sm, cfg, R.key(0), faults=inj)
    with pytest.raises(ValueError, match="pass wire=True"):
        compressed_allreduce(_per_worker(tg), sm, cfg, None, R.key(0), 2,
                             faults=inj)
    clean, _ = aggregate_simulated_workers(tg, sm, cfg, R.key(0), wire=True)
    out, _, info = aggregate_simulated_workers(
        tg, sm, cfg, R.key(0), wire=True,
        faults=FaultInjector(CorruptionSpec(prob=0.0)))
    _trees_equal(out, clean)
    assert {k: int(v) for k, v in info.items()} == {
        "messages": 0, "corrupt_detected": 0, "resends": 0}
    assert all(v.dtype == torch.int32 for v in info.values())


def test_recovery_manager_state_roundtrips():
    """The reference's manager cases: consecutive (not total) failures
    flip the dense fallback; the state dict round-trips into a fresh
    manager through a checkpoint and equals the reference's; the resil/*
    counters reach the metrics registry."""
    from repro_torch.ckpt import load_checkpoint, save_checkpoint
    from repro_torch.obs import MetricsRegistry
    from repro_torch.resil import RecoveryConfig, RecoveryManager
    reg = MetricsRegistry()
    m = RecoveryManager(RecoveryConfig(dense_fallback_after=2), metrics=reg)
    steps = (dict(detected=3, resends=3), dict(detected=0),
             dict(detected=1), dict(detected=2, skipped=1))
    m.observe(**steps[0])
    assert not m.fallback_active and m.consecutive_failures == 1
    m.observe(**steps[1])
    assert m.consecutive_failures == 0
    for kw in steps[2:]:
        m.observe(**kw)
    assert m.fallback_active
    assert m.counters == {"resil/corrupt_detected": 6, "resil/resends": 3,
                          "resil/steps_skipped": 1}
    assert reg.counters["resil/corrupt_detected"] == 6
    m2 = RecoveryManager(RecoveryConfig(dense_fallback_after=2))
    with tempfile.TemporaryDirectory() as d:
        _, st = load_checkpoint(save_checkpoint(d, 1, m.state()),
                                like=m.state())
    m2.restore({k: v.numpy() for k, v in st.items()})
    assert m2.fallback_active and m2.counters == m.counters
    with pytest.raises(ValueError, match="dense_fallback_after"):
        RecoveryConfig(dense_fallback_after=0)
    with pytest.raises(ValueError, match="straggler"):
        RecoveryConfig(straggler_timeout_us=-1.0)
    with reference("repro.resil") as ref:
        j = ref.resil.RecoveryManager(ref.resil.RecoveryConfig(
            dense_fallback_after=2))
        for kw in steps:
            j.observe(**kw)
        want = j.state()
    got = m.state()
    assert sorted(got) == sorted(want)
    for k in want:
        _bits_equal(want[k], got[k], k)


def _toy_comp():
    from repro_torch.core import (CompressionConfig, Granularity,
                                  make_compressor)
    return CompressionConfig(qw=make_compressor("topk", ratio=0.25),
                             granularity=Granularity("layerwise"),
                             error_feedback=True, integrity=True)


def test_train_resilient_resume_and_resend_bitwise(tmp_path):
    """Within the port: train 4 == train 2 + kill + resume + train 2,
    leaf for leaf (params, EF, losses, counters), and a run under prob=1
    corruption with resend is bitwise the clean run."""
    import shutil
    from repro_torch.resil import RecoveryConfig, train_resilient
    from repro_torch.sim import CorruptionSpec, Scenario
    runner = ToyRunner()
    scen = Scenario(name="corrupt", n_workers=4,
                    corruption=CorruptionSpec(prob=0.5, seed=5))
    full = train_resilient(runner, scen, _toy_comp(), steps=4, seed=1,
                           ckpt_dir=str(tmp_path / "a"), ckpt_every=2)
    d = tmp_path / "b"
    d.mkdir()
    shutil.copy(tmp_path / "a" / "resil_00000002_s0.npz", d)
    resumed = train_resilient(runner, scen, _toy_comp(), steps=4, seed=1,
                              ckpt_dir=str(d), ckpt_every=2, resume=True)
    _trees_equal(resumed["params"], full["params"], "params")
    _trees_equal(resumed["ef"], full["ef"], "ef")
    assert resumed["losses"] == full["losses"][2:]
    assert resumed["counters"] == full["counters"]
    assert full["counters"]["resil/corrupt_detected"] > 0
    clean = train_resilient(runner, Scenario(name="clean", n_workers=4),
                            _toy_comp(), steps=3, seed=2)
    bad = train_resilient(runner, Scenario(
        name="bad", n_workers=4, corruption=CorruptionSpec(prob=1.0, seed=9)),
        _toy_comp(), steps=3, seed=2, recovery=RecoveryConfig(resend=True))
    assert bad["counters"]["resil/resends"] == \
        bad["counters"]["resil/corrupt_detected"] > 0
    _trees_equal(bad["params"], clean["params"], "resend-params")
    _trees_equal(bad["ef"], clean["ef"], "resend-ef")
    assert bad["losses"] == clean["losses"]


def test_train_resilient_step_guard_conserves_params_and_ef():
    """A non-finite grad_hook step is skipped: params and EF stay those of
    the step before, bit for bit; without the guard the NaN lands."""
    from repro_torch.convert import tree_map
    from repro_torch.resil import RecoveryConfig, train_resilient
    from repro_torch.sim import Scenario
    runner = ToyRunner()
    scen = Scenario(name="clean", n_workers=4)
    calls = []

    def poison(wg, key):
        calls.append(1)
        return tree_map(lambda g: torch.full_like(g, torch.nan)
                        if len(calls) == 2 else g, wg)
    one = train_resilient(runner, scen, _toy_comp(), steps=1, seed=3)
    guarded = train_resilient(runner, scen, _toy_comp(), steps=2, seed=3,
                              recovery=RecoveryConfig(step_guard=True),
                              grad_hook=poison)
    assert guarded["counters"]["resil/steps_skipped"] == 1
    _trees_equal(guarded["params"], one["params"], "guard-params")
    _trees_equal(guarded["ef"], one["ef"], "guard-ef")
    calls.clear()
    bare = train_resilient(runner, scen, _toy_comp(), steps=2, seed=3,
                           recovery=RecoveryConfig(step_guard=False),
                           grad_hook=poison)
    assert any(not bool(torch.isfinite(leaf).all())
               for leaf in bare["params"].values())


# ---- the ranks: ring, allgather and rs_stream under faults ---------------------

def _rank_runs(rank, n, dev):
    """Every RING_RUNS run and the EF steps on this rank (gradients x
    (1 + rank), the step key RING_KEY) -> {tag: flat output, tag/det,
    tag/msgs}."""
    from repro_torch import random as R
    from repro_torch.convert import tree_leaves, tree_map
    from repro_torch.core import (CompressionConfig, Granularity,
                                  compressed_allreduce, make_compressor,
                                  stacked_mask)
    from repro_torch.resil import FaultInjector
    from repro_torch.sim import CorruptionSpec
    torch.set_num_threads(1)
    t = {k: torch.from_numpy(v) for k, v in _ring_tree().items()}
    g = tree_map(lambda x: x * (1.0 + rank), t)
    sm = stacked_mask(t)
    key = R.key(RING_KEY)
    outs = {}

    def one(tag, strat, spec, resend, chunk, fusion, ef=None, k=key):
        cfg = CompressionConfig(qw=make_compressor("topk", ratio=0.25),
                                granularity=Granularity("layerwise"),
                                strategy=strat,
                                error_feedback=ef is not None,
                                integrity=True, fusion_bytes=fusion)
        inj = (None if spec is None
               else FaultInjector(CorruptionSpec(**spec), resend=resend))
        o, new_ef = compressed_allreduce(g, sm, cfg, None, k, n,
                                         ef_state=ef, wire=True, faults=inj,
                                         stream_chunk_bytes=chunk)
        outs[tag] = torch.cat([x.reshape(-1) for x in tree_leaves(o)]
                              ).numpy()
        if inj is not None:
            flags = inj.take_flags()
            outs[tag + "/det"] = int((~flags).sum())
            outs[tag + "/msgs"] = flags.numel()
        return new_ef
    for run in RING_RUNS:
        one(*run)
    for tag, spec in (("ef_clean", None),
                      ("ef_flip", dict(prob=1.0, seed=12))):
        ef = tree_map(torch.zeros_like, g)
        for s in range(EF_STEPS):
            ef = one(f"{tag}{s}", "ring", spec, True, None, 0.0, ef=ef,
                     k=R.fold_in(key, s))
        outs[f"{tag}/state"] = torch.cat(
            [x.reshape(-1) for x in tree_leaves(ef)]).numpy()
    return outs


@pytest.fixture(scope="module")
def ring_ranks():
    """RING_RUNS and the EF steps on 4 gloo ranks (one spawn)."""
    from repro_torch.launch.mesh import run_ranks
    return run_ranks(_rank_runs, RING_N, backend="gloo", device="cpu",
                     timeout=300)


def test_ring_and_allgather_faults_across_ranks(ring_ranks):
    """fault_checks.py's checks on 4 gloo ranks, equal on every rank where
    no corrupted hop is kept: per-hop bit flips (whole and 64-byte chunked
    hops) all detected and resend equal to the clean ring (without resend
    the aggregate differs); dropped hops all detected and resent; a
    duplicated stale hop passes every check and the aggregate differs; a
    prob-0 injector is the clean ring with nothing noted; the allgather
    and rs_stream wire paths under bit flips all detected and resent; 3
    EF steps of the ring under bit flips with resend equal the clean
    ones, residuals too."""
    ranks = ring_ranks
    r0, n = ranks[0], RING_N
    # a corrupted hop kept (no resend) or a stale one poisons each rank's
    # ring its own way; every other run is the same on every rank
    own = ("ring_flip", "ring_flip_c64", "ring_dup", "rs_flip")
    for r in ranks[1:]:
        for k, v in r0.items():
            if (isinstance(v, np.ndarray) and k not in own
                    and not k.endswith("/state")):
                _bits_equal(v, r[k], k)

    def det(tag):
        return sum(r[tag + "/det"] for r in ranks)
    for tag in ("ring_flip_resend", "ring_flip_resend_c64", "ring_drop",
                "ag_flip_resend", "rs_flip_resend", "ring_flip",
                "ring_flip_c64", "ag_flip", "rs_flip"):
        assert r0[tag + "/msgs"] > 0 and det(tag) == n * r0[tag + "/msgs"]
    clean = {"ring": r0["ring_clean"], "ag": r0["ag_clean"],
             "rs": r0["rs_clean"]}
    for tag in ("ring_flip_resend", "ring_flip_resend_c64", "ring_drop",
                "ring_prob0"):
        _bits_equal(r0[tag], clean["ring"], tag)
    _bits_equal(r0["ag_flip_resend"], clean["ag"], "ag")
    _bits_equal(r0["rs_flip_resend"], clean["rs"], "rs")
    _bits_equal(r0["ring_clean"], clean["ag"], "ring == allgather")
    for tag in ("ring_flip", "ring_flip_c64", "ag_flip", "rs_flip"):
        assert not np.array_equal(r0[tag], clean[tag.split("_")[0]]), tag
    assert det("ring_dup") == 0 and r0["ring_dup/msgs"] > 0
    assert not np.array_equal(r0["ring_dup"], clean["ring"])
    assert det("ring_prob0") == 0 and r0["ring_prob0/msgs"] == 0
    assert det("ef_flip0") > 0
    for s in range(EF_STEPS):
        _bits_equal(r0[f"ef_flip{s}"], r0[f"ef_clean{s}"], ("ef", s))
    _bits_equal(r0["ef_flip/state"], r0["ef_clean/state"], "ef state")


# ---- against the reference's runs ----------------------------------------------

@pytest.mark.parametrize("i", range(len(WIRE_CASES)), ids=WIRE_IDS)
def test_wire_executors_under_faults_bitwise(i, reference_run):
    """execute_schedule_wire_with_state under the case's prob=1 fault (a
    bit flip or a truncation a message, with or without resend): trees,
    EF residuals, the returned (clean) buffers and the (worker, message)
    verdicts are the reference's (natural compression's trees decoded
    from corrupted bytes within Queue 3 item 21); the residual is the
    clean run's, resend gives the clean tree (either executor), and
    execute_schedule_wire catches every single bit flip."""
    from repro_torch import random as R
    from repro_torch.convert import tree_leaves
    from repro_torch.core import (Granularity, build_plan, build_schedule,
                                  make_compressor, stacked_mask, wire_codec)
    from repro_torch.core.wire import (execute_schedule_wire,
                                       execute_schedule_wire_with_state)
    from repro_torch.resil import FaultInjector
    from repro_torch.sim import CorruptionSpec
    name, kw, gran, mode, resend = WIRE_CASES[i]
    wg, m = _wire_inputs(name, gran, i)
    tg, tm = _to_torch(wg), _to_torch(m)
    one = _per_worker(tg)
    sched = build_schedule(build_plan(one, stacked_mask(one),
                                      Granularity(gran)), 0.0)
    codec = wire_codec(make_compressor(name, **kw), integrity=True)
    key = R.fold_in(R.key(21), i)
    wkeys = R.fold_in(key[None], torch.arange(N_WORKERS))
    inj = FaultInjector(CorruptionSpec(prob=1.0, mode=mode, seed=3),
                        resend=resend)
    t, mn, bufs = execute_schedule_wire_with_state(sched, codec, tg, tm,
                                                   wkeys, faults=inj)
    flags = inj.take_flags()
    clean, clean_m, clean_bufs = execute_schedule_wire_with_state(
        sched, codec, tg, tm, wkeys)
    inj1 = FaultInjector(CorruptionSpec(prob=1.0, mode="bitflip", n_bits=1,
                                        seed=4))
    execute_schedule_wire(sched, codec, tg, wkeys, faults=inj1)
    flags1 = inj1.take_flags()
    assert flags.shape == (N_WORKERS, sched.num_messages)
    assert not flags1.any() and (mode == "truncate" or not flags.any())
    _trees_equal(mn, clean_m, "residual is the sender's")
    if resend:
        _trees_equal(t, clean, "resend")
    for j, (b, c) in enumerate(zip(bufs, clean_bufs)):
        _bits_equal(b.numpy(), c.numpy(), ("clean buf", j))
    inj2 = FaultInjector(CorruptionSpec(prob=1.0, mode="bitflip", n_bits=1,
                                        seed=4), resend=True)
    t2, _ = execute_schedule_wire(sched, codec, tg, wkeys, faults=inj2)
    _trees_equal(t2, execute_schedule_wire(sched, codec, tg, wkeys)[0],
                 "resend (no EF)")
    ref = reference_run("wire")
    for part, tree in (("tree", t), ("ef", mn)):
        for j, leaf in enumerate(tree_leaves(tree)):
            want = ref[f"wire/{i}/{part}/{j}"]
            if part == "ef" or (part == "tree" and resend):
                _bits_equal(want, leaf.numpy(), (part, j))
            else:
                _received_equal(want, leaf.numpy(), name, (part, j))
    for j, b in enumerate(bufs):
        _bits_equal(ref[f"wire/{i}/buf/{j}"], b.numpy(), ("buf", j))
    _bits_equal(ref[f"wire/{i}/flags"], flags.numpy(), "flags")


def test_aggregate_faults_alive_bitwise(reference_run):
    """aggregate_simulated_workers(faults=, alive=) under prob=1 bit flips
    without resend (top-k EF, layerwise): the aggregate, the residuals and
    the counters are the reference's; the dead worker's EF row is frozen
    and every message is detected."""
    from repro_torch.convert import tree_leaves
    from repro_torch.core import (CompressionConfig, Granularity,
                                  aggregate_simulated_workers,
                                  make_compressor, stacked_mask)
    from repro_torch.resil import FaultInjector
    from repro_torch.sim import CorruptionSpec
    wg, m = _wire_inputs("topk", "layerwise", 99)
    tg, tm = _to_torch(wg), _to_torch(m)
    cfg = CompressionConfig(qw=make_compressor("topk", ratio=0.25),
                            granularity=Granularity("layerwise"),
                            error_feedback=True, integrity=True)
    out, ef, info = aggregate_simulated_workers(
        tg, stacked_mask(_per_worker(tg)), cfg,
        tkeys(key_data(jkey(31))), ef_state=tm, wire=True,
        faults=FaultInjector(CorruptionSpec(prob=1.0, seed=3)),
        alive=np.array(ALIVE))
    assert int(info["corrupt_detected"]) == int(info["messages"]) > 0
    assert int(info["resends"]) == 0
    for new, old in zip(tree_leaves(ef), tree_leaves(tm)):
        _bits_equal(new[1].numpy(), old[1].numpy(), "dead row frozen")
    ref = reference_run("agg")
    for part, tree in (("out", out), ("ef", ef)):
        for j, leaf in enumerate(tree_leaves(tree)):
            _bits_equal(ref[f"agg/{part}/{j}"], leaf.numpy(), (part, j))
    for k, v in info.items():
        assert int(ref[f"agg/info/{k}"]) == int(v), k


def test_train_resilient_against_the_reference(reference_run):
    """train_resilient on the toy runner under corruption with resend,
    under the dense fallback (no resend, after 2 corrupted steps) and
    under partial participation (straggler timeout): in each run the
    counters and the fallback decision equal the reference's exactly,
    each loss within 1e-5 relative, params and EF within Queue 3 item
    15's rule (1e-4 of the leaf's largest change over the run plus one
    f32 ulp of its max)."""
    from repro_torch.random import key as make_key
    from repro_torch.resil import RecoveryConfig, train_resilient
    from repro_torch.sim import CorruptionSpec, Scenario, StragglerSpec
    outs = {}
    for name, scen, rec, steps, seed in TRAIN_RUNS:
        sc = Scenario(name=name, n_workers=4,
                      corruption=CorruptionSpec(**scen.get("corruption",
                                                           {})),
                      straggler=StragglerSpec(**scen.get("straggler", {})))
        outs[name] = train_resilient(ToyRunner(), sc, _toy_comp(),
                                     steps=steps, seed=seed,
                                     recovery=RecoveryConfig(**rec))
    assert outs["fallback"]["fallback_active"]
    assert outs["straggle"]["losses"] and all(
        np.isfinite(outs["straggle"]["losses"]))
    ref = reference_run("train")
    for name, scen, rec, steps, seed in TRAIN_RUNS[:REF_TRAIN_RUNS]:
        out = outs[name]
        for k, v in out["counters"].items():
            assert int(ref[f"train/{name}/{k}"]) == v, (name, k)
        assert bool(ref[f"train/{name}/fallback"]) == out["fallback_active"]
        np.testing.assert_allclose(out["losses"],
                                   ref[f"train/{name}/losses"], rtol=1e-5,
                                   err_msg=name)
        init = ToyRunner().init(make_key(seed))
        for part in ("params", "ef"):
            for k, v in out[part].items():
                w = ref[f"train/{name}/{part}/{k}"]
                base = init[k].numpy() if part == "params" else 0.0
                change = np.abs(w - base).max()
                ulp = np.spacing(np.float32(np.abs(w).max()))
                assert np.abs(v.numpy() - w).max() <= 1e-4 * change + ulp, \
                    (name, part, k)



def test_ring_faults_match_the_reference(ring_ranks, reference_run):
    """Dropped and duplicated (stale) ring hops and the runs that keep
    every corrupted byte (chunked ring hops, the allgather's received
    regions) are bitwise the reference's on 4 virtual devices (rank 0
    against device 0), with its verdict counts."""
    r0 = ring_ranks[0]
    ref = reference_run("ring")
    for tag in REF_RING_RUNS:
        _bits_equal(ref[f"ring/{tag}"], r0[tag], tag)
        assert int(ref[f"ring/{tag}/det"]) == sum(
            r[tag + "/det"] for r in ring_ranks), tag
        assert int(ref[f"ring/{tag}/msgs"]) == r0[tag + "/msgs"], tag
