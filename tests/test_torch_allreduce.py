"""compressed_allreduce across real ranks: n = 2 and 4 spawned CPU processes
joined in one gloo process group (launch/mesh.py), every case of a given
n run inside one group so the suite pays for process start-up once per n.

Each rank feeds its own row of the same seeded numpy gradients. Held:

  (i)  every rank returns the same bytes, and they equal a single-process
       Algorithm 1 in the same key scheme (per rank r, Q_W keyed by
       fold_in(unit key, r), then the rank-order mean; error-feedback
       residuals too), bitwise; the key-free compressors (signSGD, top-k,
       identity) also equal aggregate_simulated_workers on the stack.
       The collectives move exactly comm_report's bytes under allgather
       with wire=True, and its uplink under simulated.
  (ii) the reference's compressed_allreduce under jax.shard_map on n
       virtual CPU devices, run in ONE subprocess for both n: bitwise
       (XLA's CPU psum and mean sum in device order here), except the
       dense mean over survivors (alive=): the reference's jitted
       psum(g) / 3.0 becomes a multiply by the rounded reciprocal of 3,
       while the port divides, so it holds 1 ulp (ROADMAP Queue 3).

Input families: QSGD gets norm-exact units (every unit's sum of squares
exact in any order, see test_torch_aggregation.py); under error feedback
the encoded e = x + m is norm-exact. Natural compression gets magnitudes
in [2^-3, 2^3), exponents where the reference's CPU log2 / exp2 are exact
(its tolerance elsewhere is Queue 3 item 4, held in test_torch_codecs.py).

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

ROOT = pathlib.Path(__file__).resolve().parents[1]
N_RANKS = (2, 4)
SHAPES = {"blocks": {"w": (3, 33)}, "embed": (5, 13), "gain": ()}
KEY_SEED = 3
RANK_TIMEOUT = 240.0
REF_TIMEOUT = 600.0


@dataclasses.dataclass(frozen=True)
class Case:
    comp: str
    strategy: str
    wire: bool = False
    gran: str = "layerwise"
    ef: bool = False
    wire_dtype: str = "float32"
    alive: Optional[Tuple[bool, ...]] = None
    kw: Tuple = ()

    @property
    def name(self) -> str:
        return (f"{self.comp}{dict(self.kw) or ''}-{self.strategy}"
                f"-{'wire' if self.wire else 'records'}-{self.gran}"
                f"{'-ef' if self.ef else ''}"
                f"{'-bf16' if self.wire_dtype != 'float32' else ''}"
                f"{'-alive' if self.alive else ''}")

    @property
    def divides_by_reciprocal(self) -> bool:
        """The reference's jit turns its division by the survivor count
        into a multiply by the rounded reciprocal (not exact unless the
        count is a power of two)."""
        return self.alive is not None and sum(self.alive) & (
            sum(self.alive) - 1) != 0


@functools.lru_cache(maxsize=None)
def cases(n: int):
    out = []
    for comp in ("qsgd", "terngrad", "signsgd", "natural", "topk"):
        for strategy in ("simulated", "allgather"):
            for wire in (False, True):
                if n == 2 and (strategy, wire) != ("allgather", True):
                    continue
                out.append(Case(comp, strategy, wire))
    out += [Case("qsgd", "allgather", True, "entire_model"),
            Case("qsgd", "simulated", True, ef=True),
            Case("qsgd", "allgather", True, ef=True),
            Case("topk", "rs_compress_ag"),
            Case("identity", "dense")]
    if n == 4:
        out += [Case("signsgd", "allgather", True, "entire_model"),
                Case("topk", "simulated", True, "entire_model"),
                Case("topk", "allgather", False, ef=True),
                Case("topk", "simulated", False, ef=True),
                Case("terngrad", "rs_compress_ag"),
                Case("identity", "rs_compress_ag"),
                Case("randomk", "shared_random", kw=(("ratio", 0.25),
                                                      ("scale", True))),
                Case("topk", "allgather", False, wire_dtype="bfloat16"),
                Case("identity", "dense", alive=(True, False, True, True))]
    return tuple(out)


# ---- inputs (numpy, shared by the ranks, the oracle and the reference) ----

def _tree_shapes():
    return [(("blocks", "w"), (3, 33)), (("embed",), (5, 13)),
            (("gain",), ())]


def _units(gran):
    """(offset, dim) of each exec unit in the sorted-leaf flat vector."""
    if gran == "entire_model":
        return [(0, 99 + 65 + 1)]
    return [(0, 33), (33, 33), (66, 33), (99, 65), (164, 1)]


def _norm_exact(rng, d):
    t = max(1, math.isqrt(d))
    w = int(rng.integers(0, t + 1))
    rest = t * t - w * w
    c2 = int(rng.integers(0, rest // 4 + 1))
    c1 = rest - 4 * c2
    vals = np.zeros(d, np.float32)
    pos = rng.permutation(d)
    vals[pos[:c1]] = 1
    vals[pos[c1:c1 + c2]] = 2
    if w:
        vals[pos[c1 + c2]] = w
    return vals * rng.choice(np.float32([-1, 1]), d) * np.float32(0.125)


def inputs(case: Case, n: int):
    """(n, 165) flat gradients and (n, 165) EF state (or None)."""
    rng = np.random.default_rng(zlib.crc32(f"{case.name}/{n}".encode()))
    total = 165
    if case.comp == "qsgd":
        e = np.zeros((n, total), np.float32)
        for r in range(n):
            for off, d in _units(case.gran):
                e[r, off:off + d] = _norm_exact(rng, d)
        m = (rng.integers(-8, 9, (n, total)) / 64.0).astype(np.float32)
        return (e - m, m) if case.ef else (e, None)
    if case.comp == "natural":
        x = (rng.choice(np.float32([-1, 1]), (n, total))
             * 2.0 ** rng.uniform(-3, 3, (n, total))).astype(np.float32)
        x[:, ::9] = 0.0
    else:
        x = rng.standard_normal((n, total)).astype(np.float32)
    m = (0.1 * rng.standard_normal((n, total))).astype(np.float32)
    return x, (m if case.ef else None)


def unflatten(flat):
    """(..., 165) -> nested dict of (..., *shape) arrays / tensors."""
    lead = flat.shape[:-1]
    out, off = {}, 0
    for path, shape in _tree_shapes():
        size = math.prod(shape)
        leaf = flat[..., off:off + size].reshape(lead + shape)
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
        off += size
    return out


def flatten(tree):
    """Nested dict of (..., *shape) arrays -> (..., 165), sorted leaves."""
    leaves, lead = [], None
    for path, shape in _tree_shapes():
        leaf = tree
        for k in path:
            leaf = leaf[k]
        leaf = np.asarray(leaf)
        lead = leaf.shape[:leaf.ndim - len(shape)]
        leaves.append(leaf.reshape(lead + (-1,)))
    return np.concatenate(leaves, axis=-1)


def _torch_tree(flat):
    return unflatten(torch.from_numpy(np.ascontiguousarray(flat)))


def port_config(case: Case):
    from repro_torch.core.aggregation import CompressionConfig
    from repro_torch.core.compressors import make_compressor
    from repro_torch.core.granularity import Granularity
    kw = dict(case.kw)
    return CompressionConfig(qw=make_compressor(case.comp, **kw),
                             granularity=Granularity(case.gran),
                             strategy=case.strategy, error_feedback=case.ef,
                             wire_dtype=case.wire_dtype)


# ---- the ranks -------------------------------------------------------------

def rank_main(rank, n, dev):
    """Every case of `n` on this rank -> {name: (out, ef, counts)}."""
    torch.set_num_threads(1)
    from repro_torch import random as R
    from repro_torch.core import collectives
    from repro_torch.core.aggregation import compressed_allreduce
    from repro_torch.core.granularity import stacked_mask
    out = {}
    for case in cases(n):
        x, m = inputs(case, n)
        g = _torch_tree(x[rank])
        collectives.reset_counts()
        agg, ef = compressed_allreduce(
            g, stacked_mask(g), port_config(case), None, R.key(KEY_SEED), n,
            ef_state=_torch_tree(m[rank]) if m is not None else None,
            wire=case.wire, alive=case.alive)
        out[case.name] = (flatten(agg), flatten(ef) if case.ef else None,
                          collectives.counts())
    return out


@functools.lru_cache(maxsize=None)
def rank_results(n: int):
    from repro_torch.launch.mesh import run_ranks
    return run_ranks(rank_main, n, backend="gloo", device="cpu",
                     timeout=RANK_TIMEOUT)


# ---- single-process oracles ------------------------------------------------

def oracle(case: Case, n: int):
    """Algorithm 1 in compressed_allreduce's key scheme on one process ->
    (mean (165,), per-rank EF (n, 165) or None)."""
    from repro_torch import random as R
    from repro_torch.core.aggregation import worker_mean
    from repro_torch.core.granularity import Granularity, stacked_mask
    from repro_torch.core.plan import build_plan
    cfg = port_config(case)
    x, m = inputs(case, n)
    key = R.key(KEY_SEED)
    ys, ms = [], []
    for r in range(n):
        g = _torch_tree(x[r])
        plan = build_plan(g, stacked_mask(g), Granularity(case.gran))
        if case.ef:
            def fn(xx, mm, k, r=r):
                e = xx + mm
                q = cfg.qw.sim(e, R.fold_in(k, r))
                return q, e - q
            y, mn = plan.execute_with_state(fn, g, _torch_tree(m[r]), key)
            ms.append(flatten(mn))
        else:
            y = plan.execute(lambda xx, k, r=r: cfg.qw.sim(xx, R.fold_in(
                k, r)), g, key)
        ys.append(flatten(y))
    mean = worker_mean(torch.from_numpy(np.stack(ys))).numpy()
    return mean, (np.stack(ms) if case.ef else None)


def _bitwise(a, b, what):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape, what
    assert np.array_equal(a.view(np.uint32), b.view(np.uint32)), (
        what, float(np.max(np.abs(a.astype(np.float64) - b))))


@pytest.mark.timeout(300)
@pytest.mark.parametrize("n", N_RANKS)
def test_compressed_allreduce_across_ranks(n):
    from repro_torch import random as R
    from repro_torch.core.aggregation import aggregate_simulated_workers
    from repro_torch.core.bits import comm_report
    from repro_torch.core.granularity import Granularity, stacked_mask
    from repro_torch.core.plan import build_plan
    results = rank_results(n)
    for case in cases(n):
        outs = [r[case.name] for r in results]
        for r in range(1, n):
            _bitwise(outs[r][0], outs[0][0], (case.name, "rank", r))
        got = outs[0][0]
        x, m = inputs(case, n)
        if case.strategy in ("simulated", "allgather") and \
                case.wire_dtype == "float32":
            want, want_ef = oracle(case, n)
            _bitwise(got, want, case.name)
            if case.ef:
                for r in range(n):
                    _bitwise(outs[r][1], want_ef[r], (case.name, "ef", r))
        if case.strategy == "dense" and case.alive is None or \
                case.comp == "identity" and case.strategy == "rs_compress_ag":
            want = x[0]
            for r in range(1, n):
                want = want + x[r]
            _bitwise(got, want / np.float32(n), case.name)
        if case.comp in ("signsgd", "topk") and case.strategy in (
                "simulated", "allgather") and case.wire_dtype == "float32":
            tg = _torch_tree(x)
            cfg = dataclasses.replace(port_config(case),
                                      strategy="simulated")
            agg, ef = aggregate_simulated_workers(
                tg, stacked_mask(_torch_tree(x[0])), cfg, R.key(KEY_SEED),
                ef_state=_torch_tree(m) if case.ef else None)
            _bitwise(got, flatten(agg), (case.name, "simulated workers"))
        if case.wire and case.strategy in ("simulated", "allgather"):
            g0 = _torch_tree(x[0])
            plan = build_plan(g0, stacked_mask(g0), Granularity(case.gran))
            rep = comm_report(port_config(case), plan, n, measured=True)
            counts = outs[0][2]
            assert 8 * counts["sent_bytes"] == rep.uplink_bits_per_worker
            if case.strategy == "allgather":
                assert 8 * counts["recv_bytes"] == \
                    rep.downlink_bits_per_worker, case.name
            assert counts["calls"] == len(plan.buckets), case.name


# ---- the reference under shard_map (one subprocess for every n) ------------

def reference_main(out_path: str) -> None:
    """Run every case of every n through the reference's
    compressed_allreduce under jax.shard_map on n virtual CPU devices and
    save the outputs. Needs XLA_FLAGS with 4 host devices set before jax
    starts, so it runs in its own process."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from test_torch_ref import reference

    def jflat(tree):
        return jnp.concatenate([leaf.reshape(-1) for leaf in
                                jax.tree_util.tree_leaves(tree)])[None]
    res = {}
    with reference() as ref:
        import repro.core.aggregation as A
        for n in N_RANKS:
            mesh = jax.sharding.Mesh(np.array(jax.devices()[:n]), ("data",))
            data = {c.name: inputs(c, n) for c in cases(n)}
            tmpl = jax.tree_util.tree_map(
                lambda a: a[0], unflatten(next(iter(data.values()))[0]))
            sm = ref.core.stacked_mask(tmpl)

            def f(arrays, n=n):
                outs = {}
                for c in cases(n):
                    x, m = arrays[c.name]
                    kw = dict(c.kw)
                    cfg = ref.core.CompressionConfig(
                        qw=ref.core.make_compressor(c.comp, **kw),
                        granularity=ref.core.Granularity(c.gran),
                        strategy=c.strategy, error_feedback=c.ef,
                        wire_dtype=c.wire_dtype)
                    agg, ef = A.compressed_allreduce(
                        unflatten(x[0]), sm, cfg, ("data",),
                        jax.random.key(KEY_SEED), n,
                        ef_state=unflatten(m[0]) if c.ef else None,
                        wire=c.wire, alive=c.alive)
                    outs[c.name] = jflat(agg)
                    if c.ef:
                        outs[c.name + "/ef"] = jflat(ef)
                return outs
            arrays = {k: (x, m if m is not None else np.zeros_like(x))
                      for k, (x, m) in data.items()}
            outs = jax.jit(jax.shard_map(
                f, mesh=mesh, in_specs=(P("data"),), out_specs=P("data"),
                check_vma=False))(arrays)
            for k, v in outs.items():
                res[f"{n}/{k}"] = np.asarray(v)
    np.savez(out_path, **res)


@pytest.fixture(scope="module", autouse=True)
def reference_run(tmp_path_factory):
    """Start the reference's subprocess with the module's first test, so it
    runs beside the ranks; the test that needs it waits for it."""
    path = tmp_path_factory.mktemp("allreduce") / "reference.npz"
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           str(ROOT / "tests")]))
    proc = subprocess.Popen(
        [sys.executable, "-c", "import sys, test_torch_allreduce as t; "
         "t.reference_main(sys.argv[1])", str(path)],
        env=env, cwd=str(ROOT / "tests"), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    box = {}

    def result():
        if "npz" not in box:
            log, _ = proc.communicate(timeout=REF_TIMEOUT)
            assert proc.returncode == 0, log[-4000:]
            box["npz"] = dict(np.load(path))
        return box["npz"]
    yield result
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


# ---- launch/mesh.py ---------------------------------------------------------

def _raise_on_rank_1(rank, n, dev):
    if rank == 1:
        raise ArithmeticError("rank 1 gives up")
    return rank


def _hang_on_rank_1(rank, n, dev):
    import time
    if rank == 1:
        time.sleep(600)
    return rank


@pytest.mark.timeout(120)
def test_run_ranks_reports_a_failing_and_a_hung_rank():
    from repro_torch.launch.mesh import run_ranks
    with pytest.raises(RuntimeError, match="rank 1 gives up"):
        run_ranks(_raise_on_rank_1, 2, backend="gloo", device="cpu",
                  timeout=60)
    with pytest.raises(TimeoutError, match="did not finish within 10"):
        run_ranks(_hang_on_rank_1, 2, backend="gloo", device="cpu",
                  timeout=10)


def test_run_ranks_refuses_what_the_machine_cannot_do():
    from repro_torch.launch.mesh import run_ranks
    with pytest.raises(ValueError, match="nccl runs on CUDA"):
        run_ranks(_raise_on_rank_1, 2, backend="nccl", device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_ranks(_raise_on_rank_1, 2, backend="gloo", device="cuda")
    with pytest.raises(ValueError, match="backend"):
        run_ranks(_raise_on_rank_1, 2, backend="mpi", device="cpu")


# ---- the experiment across ranks -------------------------------------------

TRAIN = dict(steps=2, batch=16, seed=5)


def train_main(rank, n, dev):
    torch.set_num_threads(1)
    from repro_torch.convert import tree_leaves
    from repro_torch.core.aggregation import CompressionConfig
    from repro_torch.core.compressors import SignSGD
    from repro_torch.experiment import train_cnn_ranks
    cfg = CompressionConfig(qw=SignSGD(), strategy="allgather")
    acc, loss, params = train_cnn_ranks("resnet9", cfg, device=dev, **TRAIN)
    return acc, loss, np.concatenate([p.reshape(-1).numpy()
                                      for p in tree_leaves(params)])


@pytest.mark.timeout(180)
def test_train_cnn_ranks_equals_train_cnn():
    """train_cnn_ranks on 2 ranks (signSGD over the allgather wire) ends
    with the same parameters on both ranks, and with train_cnn's on 2
    simulated workers (signSGD takes no key, so the two aggregations are
    the same function)."""
    from repro_torch.core.aggregation import CompressionConfig
    from repro_torch.core.compressors import SignSGD
    from repro_torch.experiment import train_cnn
    from repro_torch.launch.mesh import run_ranks
    results = run_ranks(train_main, 2, backend="gloo", device="cpu",
                        timeout=150)
    _bitwise(results[1][2], results[0][2], "params across ranks")
    assert results[0][:2] == results[1][:2]
    assert math.isfinite(results[0][1])
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        acc, loss = train_cnn("resnet9", CompressionConfig(qw=SignSGD()),
                              workers=2, device="cpu", **TRAIN)
    finally:
        torch.set_num_threads(threads)
    assert (acc, loss) == results[0][:2]


# ---- against the reference (last: its subprocess runs beside the others)

@pytest.mark.timeout(660)
@pytest.mark.parametrize("n", N_RANKS)
def test_compressed_allreduce_matches_reference(n, reference_run):
    results = rank_results(n)
    ref = reference_run()
    for case in cases(n):
        got, ef = results[0][case.name][:2]
        want = ref[f"{n}/{case.name}"]
        for r in range(n):
            _bitwise(want[r], want[0], (case.name, "reference device", r))
        if case.divides_by_reciprocal:
            np.testing.assert_array_max_ulp(got, want[0], maxulp=1)
        else:
            _bitwise(got, want[0], case.name)
        if case.ef:
            for r in range(n):
                _bitwise(results[r][case.name][1],
                         ref[f"{n}/{case.name}/ef"][r], (case.name, "ef", r))
