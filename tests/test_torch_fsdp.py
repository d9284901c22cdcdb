"""FSDP with tensor parallelism (the Engine with cfg.use_fsdp on a (data=2,
model=2) mesh: models/dist.py fsdp_param and its backward-hook Q_W, the
FSDP plan's Q_M, sharded checkpoints) and the train CLI across TP ranks,
against the JAX package, on 4 gloo CPU ranks.

The module's first test starts, together:
  - the reference in a subprocess with 4 virtual CPU devices (the jax-0.9
    shim, threefry_partitionable(False), jax.jit's donate_argnums dropped
    in the harness: with donation the reference's TP step fails at its
    first call, ROADMAP "harness facts"): llama3 smoke in f32 with
    use_fsdp=True, momentum SGD (lr 0.05), 2 steps on
    lm_batches(vocab, 8, 16, seed=0) from its init_state(0), with no
    compressor, top-k(1%) layerwise and QSGD(16) layerwise; then its
    memory estimates of the three use_fsdp configs at (2, 2) and the
    train CLI's header lines with --data 2 --model 2;
  - two run_ranks spawns of 4 gloo ranks, each in a thread: (A) the
    port's cases from the reference's params and batches, a QSGD wire
    twin, and a sharded checkpoint saved after step 0 and resumed into a
    fresh engine's shards; (B) the train CLI's rank loop, 3 steps with a
    checkpoint, then a resumed run.
The reference writes each case's results as it finishes them, and each
test waits for the run it reads.

Tolerances, ROADMAP Queue 3 item 15's rules: no compressor and top-k(1%):
each loss within 1e-5 relative, every param leaf within 1e-4 of its
largest |change| over the run plus one f32 ulp of its largest entry, the
momentum within 1e-4 of its max; QSGD(16): step 0's loss within 1e-5, its
momentum at most 0.1% of entries beyond 1e-4 of their leaf's max, each at
most one level L = G / (16 n) off, G the largest rank's gradient norm
(its rows through the one-device model, a bound on every unit norm its
Q_W sees, FSDP hook units included); step 1's loss within 1e-4 and the
final params the same share rule against 1e-4 of their leaf's change,
each within lr (2 + beta) L. Bitwise within the port: the wire step
against the simulated step, a resumed run against the uninterrupted one,
the sharded checkpoint's file against the global arrays written by one
process, the hook's Q_W against the reference's _hook_compress (top-k,
random-k, TernGrad, signSGD; QSGD on inputs of {0, +-1/8, +-1/4}, whose
norms are exact in any order).

This module imports no jax at module level: the spawned ranks import it.
"""
import json
import os
import pathlib
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
DATA, MODEL = 2, 2
STEPS = 2
BATCH, SEQ = 8, 16
LR = 0.05
LEVELS = 16
CASES = ("none", "topk", "qsgd")
FSDP_ARCHS = ("llama3-405b", "qwen3-moe-235b-a22b",
              "llama4-maverick-400b-a17b")
SHAPES = (("train", 4096, 256), ("prefill", 2048, 32), ("decode", 4096, 64))
CLI = ["--arch", "llama3-405b", "--smoke", "--data", "2", "--model", "2",
       "--compressor", "qsgd", "--granularity", "layerwise"]
RANK_TIMEOUT = 420.0
REF_TIMEOUT = 600.0


def _flat(tree) -> dict:
    import jax
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path)] = np.asarray(leaf)
    return out


def _sub(flat: dict, prefix: str) -> dict:
    """The entries under `prefix`, keyed by the rest of their path."""
    return {k[len(prefix) + 1:]: v for k, v in flat.items()
            if k.startswith(prefix + "/")}


def _unflat(flat: dict, prefix: str) -> dict:
    out = {}
    for k, v in flat.items():
        if not k.startswith(prefix + "/"):
            continue
        node = out
        parts = k[len(prefix) + 1:].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


# ---- the reference (subprocess) -----------------------------------------------

def reference_main(out_dir: str) -> None:
    import contextlib
    import dataclasses
    import functools
    import io
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from test_torch_ref import reference
    _jit = jax.jit

    @functools.wraps(_jit)
    def jit(f, *a, donate_argnums=None, **k):
        return _jit(f, *a, **k)
    out = pathlib.Path(out_dir)
    meta = {"seconds": {}}
    t0 = time.perf_counter()
    mods = ("repro.launch.engine", "repro.launch.train",
            "repro.configs.registry", "repro.optim", "repro.models.config")
    with reference(*mods) as ref:
        jax.jit = jit
        E, T = sys.modules["repro.launch.engine"], sys.modules[
            "repro.launch.train"]
        IS = sys.modules["repro.models.config"].InputShape
        mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(
            DATA, MODEL), ("data", "model"))
        cfg = dataclasses.replace(ref.registry.get_smoke("llama3-405b"),
                                  use_fsdp=True)
        opt = ref.optim.OptConfig("momentum", lr=LR)
        params, _ = E.Engine(cfg, mesh, opt=opt).init_state(0)
        inputs = {f"params/{k}": v for k, v in _flat(params).items()}
        it = ref.synthetic.lm_batches(cfg.vocab, BATCH, SEQ, seed=0)
        for i in range(STEPS):
            b = next(it)
            for k in ("tokens", "targets"):
                inputs[f"batch{i}/{k}"] = np.asarray(b[k])
        np.savez(out / "inputs.tmp.npz", **inputs)
        os.replace(out / "inputs.tmp.npz", out / "inputs.npz")
        meta["memory"] = {}
        for arch in FSDP_ARCHS:
            eng = E.Engine(ref.registry.get_config(arch), mesh, opt=opt)
            for kind, seq, batch in SHAPES:
                meta["memory"][f"{arch}/{kind}"] = {
                    k: (bool(v) if isinstance(v, bool) else float(v))
                    for k, v in eng.memory_estimate(
                        IS(kind, seq, batch, kind)).items()}
        T.make_host_mesh = lambda data=1, model=1, pod=None: mesh
        lines = io.StringIO()
        with contextlib.redirect_stdout(lines):
            T.main(CLI + ["--wire", "--steps", "0"])
        meta["cli"] = lines.getvalue().splitlines()
        meta["seconds"]["cli"] = time.perf_counter() - t0
        (out / "results.tmp.json").write_text(json.dumps(meta))
        os.replace(out / "results.tmp.json", out / "results.json")
        for case in CASES:
            res = {}
            comp = None if case == "none" else ref.core.CompressionConfig(
                qw=ref.core.make_compressor(case, **(
                    {"levels": LEVELS} if case == "qsgd" else
                    {"ratio": 0.01})),
                granularity=ref.core.Granularity("layerwise"))
            eng = E.Engine(cfg, mesh, comp=comp, opt=opt)
            put = lambda t, ps: jax.tree_util.tree_map(
                lambda x, p: jax.device_put(x, NamedSharding(mesh, p)), t, ps)
            p = put(params, eng.model.param_pspecs())
            st = put(ref.optim.init_opt_state(opt, params),
                     eng._opt_pspecs())
            step = eng.build_train_step()
            for i in range(STEPS):
                b = {k: jnp.asarray(inputs[f"batch{i}/{k}"])
                     for k in ("tokens", "targets")}
                p, st, m = step(p, st, b, jnp.int32(i))
                res[f"{case}/{i}/loss"] = np.float32(m["loss"])
                res.update({f"{case}/{i}/params/{k}": v
                            for k, v in _flat(p).items()})
                res.update({f"{case}/{i}/m/{k}": v
                            for k, v in _flat(st["m"]).items()})
            meta["seconds"][case] = time.perf_counter() - t0
            np.savez(out / "results.tmp.npz", **res)
            os.replace(out / "results.tmp.npz", out / f"results_{case}.npz")


# ---- the port's ranks ---------------------------------------------------------

def _port_comp(case):
    from repro_torch.core import CompressionConfig, Granularity, \
        make_compressor
    if case == "none":
        return None
    kw = {"levels": LEVELS} if case == "qsgd" else {"ratio": 0.01}
    return CompressionConfig(qw=make_compressor(case, **kw),
                             granularity=Granularity("layerwise"))


def _host(tree) -> dict:
    from repro_torch.convert import tree_leaves, tree_paths
    return {"/".join(p): l.detach().cpu().numpy().copy()
            for p, l in zip(tree_paths(tree), tree_leaves(tree))}


def _tree(flat: dict, prefix: str) -> dict:
    from repro_torch.convert import tree_map
    return tree_map(lambda a: torch.from_numpy(np.array(a)),
                    _unflat(flat, prefix))


def _batch(inputs, i):
    return {k: torch.from_numpy(inputs[f"batch{i}/{k}"].astype(np.int64))
            for k in ("tokens", "targets")}


def _cfg():
    import dataclasses
    from repro_torch.configs import get_smoke
    return dataclasses.replace(get_smoke("llama3-405b"), use_fsdp=True)


def _rank_grad_norm(eng, params, inputs) -> float:
    """The norm of this data rank's gradient through the one-device model
    (its rows, the global params)."""
    from repro_torch.convert import tree_leaves, tree_paths, tree_unflatten
    from repro_torch.models import DistConfig, Model
    from repro_torch.models.dist import bind_axes
    from repro_torch.launch.engine import TrainStep
    m1 = Model(eng.cfg, DistConfig())
    paths, leaves = tree_paths(params), tree_leaves(params)
    p = [l.detach().requires_grad_(True) for l in leaves]
    bind_axes({})
    loss = m1.loss(tree_unflatten(paths, p), eng.local_batch(
        _batch(inputs, 0)), TrainStep.key(0))
    g = torch.autograd.grad(loss, p)
    eng.bind()
    return float(torch.sqrt(sum(torch.sum(x.double() ** 2) for x in g)))


def _wait(path):
    deadline = time.monotonic() + REF_TIMEOUT
    while not path.exists():
        if time.monotonic() > deadline:
            raise TimeoutError(f"no {path}")
        time.sleep(0.05)


def fsdp_rank_main(rank, world, dev, out_dir):
    """Spawn A: the Engine cases, a sharded checkpoint and its resume."""
    from repro_torch.ckpt import (load_sharded_checkpoint,
                                  save_sharded_checkpoint)
    from repro_torch.launch.engine import Engine
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim import OptConfig, init_opt_state
    torch.set_num_threads(1)
    out_dir = pathlib.Path(out_dir)
    mesh = make_host_mesh(data=DATA, model=MODEL)
    _wait(out_dir / "inputs.npz")
    inputs = dict(np.load(out_dir / "inputs.npz"))
    params0 = _tree(inputs, "params")
    opt = OptConfig("momentum", lr=LR)
    out = {"index": (mesh.axis_index("data"), mesh.axis_index("model"))}
    specs = None
    for case, wire in (("none", False), ("topk", False), ("qsgd", False),
                       ("qsgd", True)):
        eng = Engine(_cfg(), mesh, comp=_port_comp(case), opt=opt,
                     device=dev)
        specs = eng.state_pspecs()
        params = eng.shard_tree(params0, specs["params"])
        state = init_opt_state(opt, params)
        step = eng.build_train_step(wire=wire)
        rec = {}
        for i in range(STEPS):
            params, state, m = step(params, state, _batch(inputs, i), i)
            full = eng.global_tree({"params": params, "m": state["m"]},
                                   {"params": specs["params"],
                                    "m": specs["opt"]["m"]})
            rec[i] = {"loss": float(m["loss"]), "local": _host(params),
                      "params": _host(full["params"]),
                      "m": _host(full["m"])}
            if case == "qsgd" and not wire and i == 0:
                ck = save_sharded_checkpoint(str(out_dir / "ckpt"), 1,
                                             {"params": params,
                                              "opt": state}, eng)
                rec["ckpt"] = ck
                rec["shards"] = _host({"params": params, "opt": state})
        out[(case, wire)] = rec
    # resume: a fresh engine's shards from the step-0 checkpoint, step 1
    eng = Engine(_cfg(), mesh, comp=_port_comp("qsgd"), opt=opt,
                 device=dev)
    torch.distributed.barrier()
    path = str(out_dir / "ckpt" / "ckpt_00000001_s0.npz")
    start, state = load_sharded_checkpoint(path, eng)
    params, opt_state, m = eng.build_train_step()(
        state["params"], state["opt"], _batch(inputs, 1), start)
    out["resumed"] = {"start": start, "loss": float(m["loss"]),
                      "local": _host(params)}
    out["grad_norm"] = _rank_grad_norm(eng, params0, inputs)
    out["specs"] = specs["params"]
    return out


def cli_rank_main(rank, world, dev, out_dir):
    """Spawn B: the train CLI's rank loop with --data 2 --model 2, 3 steps
    with a checkpoint at step 2, then a run resumed from it -> (rank 0's
    printed lines, the run's result, the resumed run's)."""
    import contextlib
    import io
    from repro_torch.launch import train
    torch.set_num_threads(1)
    d = pathlib.Path(out_dir) / "cli"
    base = CLI + ["--wire", "--device", "cpu", "--backend", "gloo",
                  "--batch", "8", "--seq", "16", "--ckpt-dir", str(d)]
    lines = io.StringIO()
    with contextlib.redirect_stdout(lines):
        full = train._train_rank(rank, world, dev, train._parse(
            base + ["--steps", "3", "--ckpt-every", "2"]), True)
    resumed = train._train_rank(rank, world, dev, train._parse(
        base + ["--steps", "3", "--resume"]), True)
    return lines.getvalue().splitlines(), full, resumed


# ---- the module fixture -------------------------------------------------------

class _Run:
    """The module's runs, started together by the fixture; each test waits
    for what it reads (so no test waits for them all)."""

    def __init__(self, out, proc, spawns):
        self.out, self.proc, self.spawns = out, proc, spawns

    def _file(self, name):
        path = self.out / name
        deadline = time.monotonic() + REF_TIMEOUT
        while not path.exists():
            if self.proc.poll() not in (None, 0):
                log, _ = self.proc.communicate()
                raise AssertionError(log[-4000:])
            assert time.monotonic() < deadline, f"no {name}"
            time.sleep(0.1)
        return path

    def ref(self, case):
        return dict(np.load(self._file(f"results_{case}.npz")))

    def meta(self):
        return json.loads(self._file("results.json").read_text())

    def inputs(self):
        return dict(np.load(self._file("inputs.npz")))

    def ranks(self, name):
        th, box = self.spawns[name]
        th.join()
        if "error" in box:
            raise box["error"]
        return box["ranks"]


@pytest.fixture(scope="module")
def fsdp_run(tmp_path_factory):
    import repro_torch.launch.engine  # noqa: F401  (imports before threads)
    import repro_torch.launch.train  # noqa: F401
    from repro_torch.launch.mesh import run_ranks
    out = tmp_path_factory.mktemp("fsdp")
    # one XLA thread a device: beside loaded test workers, spinning thread
    # pools thrash
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4 "
                         "--xla_cpu_multi_thread_eigen=false "
                         "intra_op_parallelism_threads=1",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           str(ROOT / "tests")]))
    proc = subprocess.Popen(
        [sys.executable, "-c", "import sys, test_torch_fsdp as t; "
         "t.reference_main(sys.argv[1])", str(out)], env=env,
        cwd=str(ROOT / "tests"), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    spawns = {}
    for name, fn in (("engine", fsdp_rank_main), ("cli", cli_rank_main)):
        box = {}

        def ranks(fn=fn, box=box):
            try:
                box["ranks"] = run_ranks(fn, DATA * MODEL, backend="gloo",
                                         device="cpu", args=(str(out),),
                                         timeout=RANK_TIMEOUT)
            except BaseException as e:     # re-raised in the main thread
                box["error"] = e
        th = threading.Thread(target=ranks)
        th.start()
        spawns[name] = (th, box)
    yield _Run(out, proc, spawns)
    for th, _ in spawns.values():
        th.join()
    if proc.poll() is None:
        proc.kill()
    proc.communicate()


def _leaf_close(got, want, scale, frac, what):
    worst = 0.0
    for k, w in want.items():
        s = max(float(scale[k]), 1e-30)
        ulp = float(np.spacing(np.float32(np.abs(w).max())))
        err = float(np.abs(got[k].astype(np.float64) - w).max())
        assert err <= frac * s + ulp, (what, k, err / s)
        worst = max(worst, err / s)
    return worst


def _share_close(got, want, scale, frac, level, what):
    off = total = 0
    worst = 0.0
    for k, w in want.items():
        d = np.abs(got[k].astype(np.float64) - w)
        bad = d > frac * max(float(scale[k]), 1e-30)
        off += int(bad.sum())
        total += w.size
        if bad.any():
            worst = max(worst, float(d[bad].max()))
    assert off <= 1e-3 * total, (what, off, total)
    assert worst <= level, (what, worst, level)
    return off / total, worst


# ---- tests --------------------------------------------------------------------

@pytest.mark.parametrize("comp", ["topk", "randomk", "terngrad", "signsgd",
                                  "qsgd"])
def test_hook_compress_matches_reference(comp):
    """_hook_compress at each of 4 dp ranks against the reference's under
    vmap with the dp axis name (its axis_index is the rank), jitted, on
    the same gradient and key bits: bitwise."""
    import jax
    from test_torch_ref import reference
    from repro_torch import random as R
    from repro_torch.core import CompressionConfig, make_compressor
    from repro_torch.models import dist as D
    n = 4
    rng = np.random.default_rng(5)
    if comp == "qsgd":
        g = rng.choice(np.float32([0, 0.125, -0.125, 0.25, -0.25]),
                       (37, 19))
    else:
        g = rng.standard_normal((37, 19)).astype(np.float32)
    kw = {"ratio": 0.1} if comp in ("topk", "randomk") else (
        {"levels": LEVELS} if comp == "qsgd" else {})
    kb = D.key_to_bits(R.fold_in(R.key(42), 3))
    with reference("repro.models.dist", "repro.core.aggregation") as ref:
        JD = sys.modules["repro.models.dist"]
        cfg = ref.aggregation.CompressionConfig(
            qw=ref.core.make_compressor(comp, **kw))
        dist = JD.DistConfig(fsdp="data", dp=("data",))
        jb = jax.numpy.asarray(kb.numpy())
        want = np.asarray(jax.jit(jax.vmap(
            lambda x: JD._hook_compress(x, jb, cfg, dist),
            axis_name="data"))(np.broadcast_to(g, (n,) + g.shape)))
    mine = CompressionConfig(qw=make_compressor(comp, **kw))
    dist = D.DistConfig(fsdp="data", dp=("data",))
    try:
        for r in range(n):
            D.bind_axes({"data": D.Axis(None, n, r)})
            got = D._hook_compress(torch.from_numpy(g), kb, mine, dist)
            np.testing.assert_array_equal(got.numpy().view(np.int32),
                                          want[r].view(np.int32),
                                          err_msg=(comp, r))
    finally:
        D.bind_axes({})


@pytest.mark.parametrize("arch", FSDP_ARCHS)
def test_memory_estimate_matches_reference_with_fsdp(fsdp_run, arch):
    from repro_torch.configs import get_config
    from repro_torch.launch.engine import Engine
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import InputShape
    from repro_torch.optim import OptConfig
    cfg = get_config(arch)
    assert cfg.use_fsdp
    eng = Engine(cfg, make_host_mesh(data=DATA, model=MODEL), device="cpu",
                 opt=OptConfig("momentum", lr=LR))
    for kind, seq, batch in SHAPES:
        got = eng.memory_estimate(InputShape(kind, seq, batch, kind))
        assert got == fsdp_run.meta()["memory"][f"{arch}/{kind}"], kind



@pytest.mark.parametrize("case", CASES)
def test_fsdp_engine_matches_reference(fsdp_run, case):
    ref = fsdp_run.ref(case)
    ranks = fsdp_run.ranks("engine")
    port = ranks[0][(case, False)]
    p0 = _sub(fsdp_run.inputs(), "params")
    last = _sub(ref, f"{case}/{STEPS - 1}/params")
    change = {k: np.abs(last[k].astype(np.float64) - p0[k]).max()
              for k in p0}
    gnorm = max(r["grad_norm"] for r in ranks)
    level = 1.001 * gnorm / (LEVELS * DATA)
    seen = {}
    for i in range(STEPS):
        got = port[i]
        want_loss = float(ref[f"{case}/{i}/loss"])
        rp = _sub(ref, f"{case}/{i}/params")
        rm = _sub(ref, f"{case}/{i}/m")
        assert sorted(got["params"]) == sorted(rp)
        rel = abs(got["loss"] - want_loss) / abs(want_loss)
        mscale = {k: np.abs(v).max() for k, v in rm.items()}
        if case == "qsgd":
            if i == 0:
                assert rel <= 1e-5, (i, rel)
                seen["m0"] = _share_close(got["m"], rm, mscale, 1e-4, level,
                                          i)
            else:
                assert rel <= 1e-4, (i, rel)
                seen["params"] = _share_close(got["params"], rp, change,
                                              1e-4, LR * (2 + 0.9) * level,
                                              i)
        else:
            assert rel <= 1e-5, (case, i, rel)
            seen[i] = (_leaf_close(got["params"], rp, change, 1e-4, i),
                       _leaf_close(got["m"], rm, mscale, 1e-4, i))
    print(case, json.dumps(seen))


def test_ranks_agree_and_wire_is_bitwise_sim(fsdp_run):
    ranks = fsdp_run.ranks("engine")
    for r in ranks:
        for i in range(STEPS):
            sim, wire = r[("qsgd", False)][i], r[("qsgd", True)][i]
            assert sim["loss"] == wire["loss"]
            for k, v in sim["local"].items():
                np.testing.assert_array_equal(v, wire["local"][k],
                                              err_msg=k)
    r0 = ranks[0]
    for r in ranks[1:]:
        for case in CASES:
            for i in range(STEPS):
                assert r[(case, False)][i]["loss"] == r0[(case, False)][i][
                    "loss"]
                for k, v in r[(case, False)][i]["params"].items():
                    np.testing.assert_array_equal(
                        v, r0[(case, False)][i]["params"][k])


def test_sharded_checkpoint_is_the_global_file_and_resumes_bitwise(
        fsdp_run, tmp_path):
    """rank 0's file holds what one process writes from the global arrays
    (every rank's shards concatenated here by numpy along the sharded
    dims); a fresh engine resumed from it takes step 1 bitwise as the
    uninterrupted run."""
    from repro_torch.ckpt import load_checkpoint, save_checkpoint
    from repro_torch.convert import tree_map
    ranks = fsdp_run.ranks("engine")
    specs = ranks[0]["specs"]
    sizes = {"data": DATA, "model": MODEL}
    by_index = {r["index"]: r[("qsgd", False)]["shards"] for r in ranks}

    def assemble(key, spec):
        def block(d, m):
            return by_index[(d, m)][key]
        axes = [(dim, ax) for dim, ax in enumerate(spec) if ax is not None]
        grid = {}
        for d in range(DATA):
            for m in range(MODEL):
                grid[(d, m)] = block(d, m)
        out = grid
        for dim, ax in reversed(axes):
            merged = {}
            for idx, a in out.items():
                rest = tuple(v if name != ax else 0 for name, v in
                             zip(("data", "model"), idx))
                merged.setdefault(rest, {})[idx[("data", "model").index(
                    ax)]] = a
            out = {k: np.concatenate([v[j] for j in range(sizes[ax])],
                                     axis=dim) for k, v in merged.items()}
        return next(iter(out.values()))
    flat_specs = {}

    def walk(t, pre):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, pre + (k,))
            else:
                flat_specs["/".join(pre + (k,))] = v
    walk(specs, ())
    full = {}
    for k, spec in flat_specs.items():
        full[f"params/{k}"] = assemble(f"params/{k}", spec)
        full[f"opt/m/{k}"] = assemble(f"opt/m/{k}", spec)
    tree = tree_map(torch.from_numpy, _unflat(full, "params"))
    mine = save_checkpoint(str(tmp_path), 1, {
        "params": tree, "opt": {"m": tree_map(torch.from_numpy,
                                              _unflat(full, "opt/m"))}})
    theirs = ranks[0][("qsgd", False)]["ckpt"]
    assert theirs is not None and all(
        r[("qsgd", False)]["ckpt"] is None for r in ranks[1:])
    with np.load(mine) as a, np.load(theirs) as b:
        assert sorted(a.files) == sorted(b.files)
        for f in a.files:
            np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    like = {"params": tree, "opt": {"m": tree}}
    assert load_checkpoint(theirs, like)[0] == 1
    for r in ranks:
        res = r["resumed"]
        want = r[("qsgd", False)][1]
        assert res["start"] == 1 and res["loss"] == want["loss"]
        for k, v in want["local"].items():
            np.testing.assert_array_equal(res["local"][k], v, err_msg=k)


def test_train_cli_across_tp_ranks(fsdp_run):
    """train --data 2 --model 2's rank loop prints the reference's header
    lines, and a run resumed from its step-2 checkpoint ends bitwise where
    the uninterrupted run does."""
    ranks = fsdp_run.ranks("cli")
    lines = ranks[0][0]
    want = fsdp_run.meta()["cli"]
    assert [l for l in lines if not l.startswith("step ")][:len(want)] \
        == want
    for _, full, resumed in ranks:
        assert resumed["start"] == 2
        assert resumed["losses"] == full["losses"][2:]
        for k, v in full["state"].items():
            np.testing.assert_array_equal(v, resumed["state"][k], err_msg=k)
