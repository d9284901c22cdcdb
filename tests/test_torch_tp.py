"""Tensor and sequence parallelism on process groups (models/dist.py,
launch/mesh.py, the TP lines of models/) against the JAX package, on 4
gloo CPU ranks as a (data=2, model=2) mesh (rank = d * 2 + m).

The module's first test starts, together:
  - the reference's serving run in a subprocess with 4 virtual CPU
    devices (the jax-0.9 shim, threefry_partitionable(False), jax.jit's
    donate_argnums dropped in the harness): the dense family of
    tests/dist_checks.py on Mesh(devices.reshape(2, 2), ("data", "model")),
    Engine.build_prefill and two build_serve_step steps;
  - two run_ranks spawns of 4 gloo ranks, each in a thread: (A) the five
    families' aggregated gradients (SP on and off) and the boundary ops
    on the model group; (B) the Engine's prefill and 2 decode steps, then
    the serve CLI's and the two examples' rank functions, then phi4
    smoke's TP decode with a padding head;
and each gradient test jits the reference's single-device gradients of
its family in the main process, so no test waits for every run.

The reference's own gate, tests/dist_checks.py check_grad_equivalence:
the FAMILIES, the batch next(lm_batches(256, 16, 32, seed=3)) and key(7)
as there; the port's gradients after Engine._aggregate_grads (dense),
gathered to global arrays, against the reference's jitted single-device
gradients on the same params, the worst leaf's max |a - b| / max |b|
within dist_checks.TOL (1e-4; MoE 2e-2: each data rank routes its own
tokens, so expert capacity drops differ).

Serving bounds (ROADMAP Queue 3 item 12): the prefill logits within 1e-5
of max |logit|; the two decode steps, each chained from the port's own
cache, within 1e-4; every rank's cache leaves within 1e-5 of their max
of the reference's shard of the cache (slot_pos bitwise). The boundary
ops are held to their definitions bitwise.

TP decode with padding heads (ROADMAP Queue 3 item 18): phi4 smoke has 3
heads, so at model 2 each rank holds 2 and one is padding. On the
reference's params (its Engine's init_state(0), padded shapes) the
port's decode step is finite and within item 18's decode bound (1e-4 of
max |logit|) of its own one-device decode on the same params without the
padding head; the reference's TP decode on the same inputs is NaN.

This module imports no jax at module level: the spawned ranks import it.
"""
import ast
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
FAMILIES = ("dense", "moe", "mla", "ssm", "hybrid")
DATA, MODEL = 2, 2
BATCH, SEQ = 16, 32
SERVE_B, SERVE_CACHE = 8, 36        # two decode tokens past the prompt
SERVE_CLI = ["--arch", "llama3-405b", "--smoke", "--device", "cpu",
             "--batch", "4", "--prompt", "8", "--gen", "4"]
RANK_TIMEOUT = 420.0
REF_TIMEOUT = 600.0


def _dist_checks():
    """FAMILIES (config kwargs) and TOL of tests/dist_checks.py, read from
    its source (importing it would set XLA_FLAGS in this process)."""
    tree = ast.parse((ROOT / "tests" / "dist_checks.py").read_text())
    fams, tol = None, None
    for node in tree.body:
        if isinstance(node, ast.Assign) and isinstance(node.targets[0],
                                                       ast.Name):
            name = node.targets[0].id
            if name == "FAMILIES":
                fams = {ast.literal_eval(k): {kw.arg: ast.literal_eval(
                    kw.value) for kw in v.keywords}
                    for k, v in zip(node.value.keys, node.value.values)}
            elif name == "TOL":
                tol = ast.literal_eval(node.value)
    return fams, tol


FAMILY_KW, TOL = _dist_checks()


# ---- the reference's serving run (subprocess) ---------------------------------

def reference_serve_main(out_dir: str) -> None:
    """Prefill and two decode steps of the dense family on a (2, 2) mesh
    of virtual devices -> serve_ref.npz: params (its Engine's
    init_state(0)), logits, the global cache after each call."""
    import functools
    import jax
    import jax.numpy as jnp
    from test_torch_ref import reference
    _jit = jax.jit

    @functools.wraps(_jit)
    def jit(f, *a, donate_argnums=None, **k):
        return _jit(f, *a, **k)
    out = pathlib.Path(out_dir)
    with reference("repro.launch.engine", "repro.models.config",
                   "repro.optim", "repro.configs.registry") as ref:
        jax.jit = jit
        E = sys.modules["repro.launch.engine"]
        C = sys.modules["repro.models.config"]
        inputs = _wait_npz(out / "inputs.npz")    # the grads run writes it
        cfg = C.ModelConfig(**FAMILY_KW["dense"])
        mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(
            DATA, MODEL), ("data", "model"))
        eng = E.Engine(cfg, mesh)
        params, _ = eng.init_state(0)
        res = {f"params/{k}": v for k, v in _flat(params).items()}
        tokens = jnp.asarray(inputs["tokens"][:SERVE_B])
        pre = eng.build_prefill(C.InputShape("p", SEQ, SERVE_B, "prefill"),
                                cache_len=SERVE_CACHE)
        srv = eng.build_serve_step(C.InputShape("d", SERVE_CACHE, SERVE_B,
                                                "decode"))
        logits, cache = pre(params, {"tokens": tokens})
        res["prefill"] = np.asarray(logits)
        res.update({f"cache0/{k}": v for k, v in _flat(cache).items()})
        for i in range(2):
            tok = jnp.asarray(inputs["tokens"][:SERVE_B, i])
            logits, cache = srv(params, {"token": tok,
                                         "pos": jnp.int32(SEQ + i)}, cache)
            res[f"decode{i}"] = np.asarray(logits)
            res.update({f"cache{i + 1}/{k}": v
                        for k, v in _flat(cache).items()})
        # phi4 smoke at model 2: 3 heads, one padding head on rank m = 1
        cfg = ref.registry.get_smoke("phi4-mini-3.8b")
        peng = E.Engine(cfg, mesh)
        pparams, _ = peng.init_state(0)
        _save(out / "params_phi4.npz", _flat(pparams))
        pre = peng.build_prefill(C.InputShape("p", SEQ, SERVE_B, "prefill"),
                                 cache_len=SERVE_CACHE)
        srv = peng.build_serve_step(C.InputShape("d", SERVE_CACHE, SERVE_B,
                                                 "decode"))
        logits, cache = pre(pparams, {"tokens": tokens})
        res["phi4_prefill"] = np.asarray(logits)
        logits, _ = srv(pparams, {"token": jnp.asarray(
            inputs["tokens"][:SERVE_B, 0]), "pos": jnp.int32(SEQ)}, cache)
        res["phi4_decode"] = np.asarray(logits)
    np.savez(out / "serve_ref.npz", **res)


def _flat(tree) -> dict:
    import jax
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path)] = np.asarray(leaf)
    return out


# ---- the port's ranks ---------------------------------------------------------

def _port_cfg(name):
    from repro_torch.models.config import ModelConfig
    return ModelConfig(**FAMILY_KW[name])


def _params(flat):
    """A family's params file -> the port's tree."""
    from repro_torch.convert import tree_unflatten
    keys = sorted(flat)
    return tree_unflatten([tuple(k.split("/")) for k in keys],
                          [torch.from_numpy(flat[k].copy()) for k in keys])


def _host(tree) -> dict:
    from repro_torch.convert import tree_leaves, tree_paths
    return {"/".join(p): l.detach().cpu().numpy().copy()
            for p, l in zip(tree_paths(tree), tree_leaves(tree))}


def _grad_cases(mesh, dev, inputs, rank, out_dir):
    """Each family's dense-aggregated gradients, SP off and on, gathered;
    rank 0 writes a family's file as soon as it is done."""
    import dataclasses
    from repro_torch import random as R
    from repro_torch.convert import tree_leaves, tree_paths, tree_unflatten
    from repro_torch.core.aggregation import CompressionConfig
    from repro_torch.launch.engine import Engine
    from repro_torch.optim import OptConfig
    batch = {k: torch.from_numpy(inputs[k].astype(np.int64))
             for k in ("tokens", "targets")}
    key = R.key(7)
    for name in FAMILIES:
        params = _params(_wait_npz(out_dir / f"params_{name}.npz"))
        res = {}
        for sp in (False, True):
            eng = Engine(_port_cfg(name), mesh,
                         comp=CompressionConfig(strategy="dense"),
                         opt=OptConfig(), device=dev)
            if not sp:
                eng.dist = dataclasses.replace(eng.dist, sp=False)
                eng.model.dist = eng.dist
            eng.bind()
            specs = eng.model.param_pspecs()
            local = eng.shard_tree(params, specs)
            paths, leaves = tree_paths(local), tree_leaves(local)
            p = [l.detach().requires_grad_(True) for l in leaves]
            loss = eng.model.loss(tree_unflatten(paths, p),
                                  eng.local_batch(batch), key)
            g = torch.autograd.grad(loss, p)
            agg = eng._aggregate_grads(tree_unflatten(paths, list(g)), key)
            full = eng.global_tree(agg, specs)
            res.update({f"sp_{'on' if sp else 'off'}/{k}": v
                        for k, v in _host(full).items()})
        if rank == 0:      # a family's file as soon as it is done
            np.savez(out_dir / "grads.tmp.npz", **res)
            os.replace(out_dir / "grads.tmp.npz",
                       out_dir / f"grads_{name}.npz")


def _ops_cases(mesh, rank):
    """Every boundary op on this rank's model group (2 ranks) and, for the
    FSDP ones, its data group, against its definition: {name: max |err|}
    (0.0 = bitwise)."""
    from repro_torch.models import dist as D
    m, d = mesh.axis_index("model"), mesh.axis_index("data")
    gen = torch.Generator().manual_seed(11)
    base = torch.randn(3, 4, 6, generator=gen)
    gout = torch.randn(3, 4, 6, generator=gen)
    xs = [base * (r + 1) + r for r in range(MODEL)]      # each rank's input
    gs = [gout * (r + 2) - r for r in range(MODEL)]      # each rank's grad
    err = {}

    def run(fn, x, g):
        x = x.clone().requires_grad_(True)
        y = fn(x)
        (gx,) = torch.autograd.grad(y, x, g)
        return y.detach(), gx

    def diff(a, b):
        return float((a - b).abs().max()) if a.shape == b.shape else 1e9

    def record(name, y, gx, want_y, want_g):
        err[name] = max(diff(y, want_y), diff(gx, want_g))

    x, g = xs[m], gs[m]
    # tp_region_in / tp_shared: identity, psum backward
    for name, fn in (("tp_region_in", D.tp_region_in),
                     ("tp_shared", D.tp_shared)):
        y, gx = run(lambda t: fn(t, "model"), x, g)
        record(name, y, gx, x, gs[0] + gs[1])
    y, gx = run(lambda t: D.tp_region_out(t, "model"), x, g)
    record("tp_region_out", y, gx, xs[0] + xs[1], g)
    y, gx = run(lambda t: D.gather_replicated(t, "model", 1), x,
                torch.cat(gs, 1))
    record("gather_replicated", y, gx, torch.cat(xs, 1),
           torch.cat(gs, 1)[:, 4 * m:4 * (m + 1)])
    y, gx = run(lambda t: D.make_slice_replicated(MODEL)(t, "model", 1), x,
                g[:, :2])
    record("make_slice_replicated", y, gx, x[:, 2 * m:2 * (m + 1)],
           torch.cat([gg[:, :2] for gg in gs], 1))
    sp = D.DistConfig(tp="model", sp=True)
    nsp = D.DistConfig(tp="model")
    big = [torch.cat([gg, gg * 3], 1) for gg in gs]
    y, gx = run(lambda t: D.region_in(t, sp, 1), x, big[m])
    record("region_in_sp", y, gx, torch.cat(xs, 1),
           (big[0] + big[1])[:, 4 * m:4 * (m + 1)])
    y, gx = run(lambda t: D.region_out(t, sp, 1), x, g[:, :2])
    record("region_out_sp", y, gx, (xs[0] + xs[1])[:, 2 * m:2 * (m + 1)],
           torch.cat([gg[:, :2] for gg in gs], 1))
    y, gx = run(lambda t: D.region_in(t, nsp, 1), x, g)
    record("region_in", y, gx, x, gs[0] + gs[1])
    y, gx = run(lambda t: D.region_out(t, nsp, 1), x, g)
    record("region_out", y, gx, xs[0] + xs[1], g)
    y = D.pmax_sg(x.clone().requires_grad_(True), "model")
    err["pmax_sg"] = diff(y, torch.maximum(xs[0], xs[1])) + float(
        y.requires_grad)                 # no gradient flows through it
    err["psum"] = diff(D.psum(x, "model"), xs[0] + xs[1])
    err["pmean"] = diff(D.pmean(x, "model"), (xs[0] + xs[1]) / 2)
    err["axis_index"] = float(D.axis_index("model") != m)
    # fsdp_param over the data group: gather forward; scatter-mean backward
    fd = D.DistConfig(fsdp="data", dp=("data",))
    wd = [base[:, :2] * (r + 1) for r in range(DATA)]
    gd = [gout * (r + 3) for r in range(DATA)]
    w = wd[d].clone().requires_grad_(True)
    y = D.fsdp_param(w, torch.zeros(2), 1, fd, None)
    (gw,) = torch.autograd.grad(y, w, gd[d][:, :4])
    want = ((gd[0][:, :4] + gd[1][:, :4]) / 2)[:, 2 * d:2 * (d + 1)]
    err["fsdp_param"] = max(diff(y.detach(), torch.cat(wd, 1)),
                            diff(gw, want))
    # fdot: input-dim and output-dim sharded weights against x @ W
    full_w = torch.randn(6, 8, generator=gen)
    xin = torch.randn(3, 6, generator=gen)
    w_in = full_w[3 * d:3 * (d + 1)]
    err["fdot_in"] = diff(D.fdot(xin, w_in, 0, fd),
                          xin[:, :3] @ full_w[:3] + xin[:, 3:] @ full_w[3:])
    w_out = full_w[:, 4 * d:4 * (d + 1)]
    err["fdot_out"] = diff(D.fdot(xin, w_out, 1, fd), xin @ full_w)
    # vocab-parallel embedding / cross-entropy against one shard's
    V, dm = 16, 5
    table = torch.randn(V, dm, generator=gen)
    ids = torch.tensor([[0, 7, 8, 15, 3]])
    loc = table[8 * m:8 * (m + 1)]
    err["vp_embed"] = diff(D.vp_embed(loc, ids, "model", V), table[ids])
    logits = torch.randn(5, V, generator=gen)
    tgt = torch.tensor([0, 9, 15, 4, 12])
    got = D.vp_xent(logits[:, 8 * m:8 * (m + 1)], tgt, "model", vocab=14)
    D.bind_axes({})
    want = D.vp_xent(logits, tgt, None, vocab=14)
    mesh.bind()
    err["vp_xent"] = float((got - want).abs()) / float(want.abs())
    hx = torch.randn(5, dm, generator=gen)
    hw = torch.randn(dm, V, generator=gen)
    got = D.vp_xent_chunked(hx, hw[:, 8 * m:8 * (m + 1)], tgt, "model", 14,
                            chunk=2)
    D.bind_axes({})
    want = D.vp_xent_chunked(hx, hw, tgt, None, 14, chunk=2)
    mesh.bind()
    err["vp_xent_chunked"] = float((got - want).abs()) / float(want.abs())
    return err


def _serve_case(mesh, dev, inputs, params):
    from repro_torch.launch.engine import Engine
    from repro_torch.models import InputShape
    eng = Engine(_port_cfg("dense"), mesh, device=dev)
    local = eng.shard_tree(_params(params), eng.model.param_pspecs())
    tokens = torch.from_numpy(inputs["tokens"][:SERVE_B].astype(np.int64))
    pre = eng.build_prefill(InputShape("p", SEQ, SERVE_B, "prefill"),
                            cache_len=SERVE_CACHE)
    srv = eng.build_serve_step(InputShape("d", SERVE_CACHE, SERVE_B,
                                          "decode"))
    logits, cache = pre(local, {"tokens": tokens})
    out = {"prefill": eng.gather_logits(logits).numpy(),
           "cache0": _host_cache(cache)}
    for i in range(2):
        logits, cache = srv(local, {"token": tokens[:, i], "pos": SEQ + i},
                            cache)
        out[f"decode{i}"] = eng.gather_logits(logits).numpy()
        out[f"cache{i + 1}"] = _host_cache(cache)
    out["index"] = (mesh.axis_index("data"), mesh.axis_index("model"))
    return out


def _pad_heads_case(mesh, dev, inputs, params):
    """phi4 smoke (3 heads) on the (2, 2) mesh from the reference's params:
    prefill, then one decode step -> this rank's gathered logits."""
    from repro_torch.configs import get_smoke
    from repro_torch.launch.engine import Engine
    from repro_torch.models import InputShape
    eng = Engine(get_smoke("phi4-mini-3.8b"), mesh, device=dev)
    local = eng.shard_tree(_params(params), eng.model.param_pspecs())
    tokens = torch.from_numpy(inputs["tokens"][:SERVE_B].astype(np.int64))
    pre = eng.build_prefill(InputShape("p", SEQ, SERVE_B, "prefill"),
                            cache_len=SERVE_CACHE)
    srv = eng.build_serve_step(InputShape("d", SERVE_CACHE, SERVE_B,
                                          "decode"))
    _, cache = pre(local, {"tokens": tokens})
    logits, _ = srv(local, {"token": tokens[:, 0], "pos": SEQ}, cache)
    return {"decode": eng.gather_logits(logits).numpy(),
            "index": (mesh.axis_index("data"), mesh.axis_index("model"))}


def _host_cache(cache) -> dict:
    return {k: v.cpu().numpy().copy() for k, v in cache.items()}


def _wait_npz(path):
    """An npz the fixture writes, once it is there (the ranks start before
    the fixture has drawn the reference's inputs)."""
    deadline = time.monotonic() + REF_TIMEOUT
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"no {path}")
        time.sleep(0.05)
    return dict(np.load(path))


def tp_rank_main(rank, world, dev, inputs_path):
    """Spawn A: the five families' aggregated gradients and the boundary
    ops."""
    from repro_torch.launch.mesh import make_host_mesh
    torch.set_num_threads(1)
    mesh = make_host_mesh(data=DATA, model=MODEL)
    inputs = _wait_npz(inputs_path)
    _grad_cases(mesh, dev, inputs, rank, pathlib.Path(inputs_path).parent)
    return {"ops": _ops_cases(mesh, rank)}


def serve_rank_main(rank, world, dev, inputs_path):
    """Spawn B: the Engine's prefill and decode, then the serve CLI's and
    the two examples' rank functions on the same 4 ranks."""
    import argparse
    from repro_torch import serve_batched, train_lm_distributed
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_host_mesh
    torch.set_num_threads(1)
    inputs = _wait_npz(inputs_path)
    params = _wait_npz(pathlib.Path(inputs_path).parent / "params_dense.npz")
    out = {"serve": _serve_case(make_host_mesh(data=DATA, model=MODEL), dev,
                                inputs, params)}
    args = serve.parser().parse_args(SERVE_CLI + ["--data", str(DATA),
                                                  "--model", str(MODEL)])
    out["cli"] = serve._serve_rank(rank, world, dev, args, True)
    ex = argparse.Namespace(steps=2, data=DATA, model=MODEL, batch=8,
                            seq=16)
    out["train_example"] = train_lm_distributed._rank(rank, world, dev, ex)
    out["serve_example"] = serve_batched._rank(
        rank, world, dev, argparse.Namespace(gen=2, data=DATA, model=MODEL))
    out["pad_heads"] = _pad_heads_case(
        make_host_mesh(data=DATA, model=MODEL), dev, inputs,
        _wait_npz(pathlib.Path(inputs_path).parent / "params_phi4.npz"))
    return out


# ---- the module fixture -------------------------------------------------------

def _save(path, arrays):
    """np.savez, then an atomic rename: the ranks poll for the file."""
    tmp = path.with_name(path.stem + ".tmp.npz")
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def reference_grads_main(out_dir: str) -> None:
    """The reference's inputs, then per family its init params (the
    ranks' params_<family>.npz) and its jitted one-device gradients
    (want_<family>.npz), each file as soon as it is made."""
    import jax
    from test_torch_ref import reference
    out = pathlib.Path(out_dir)
    with reference("repro.models.model", "repro.models.config",
                   "repro.models.dist", "repro.data.synthetic"):
        JM = sys.modules["repro.models.model"]
        JC = sys.modules["repro.models.config"]
        JD = sys.modules["repro.models.dist"]
        syn = sys.modules["repro.data.synthetic"]
        batch = next(syn.lm_batches(256, BATCH, SEQ, seed=3))
        inputs = {k: np.asarray(batch[k]) for k in ("tokens", "targets")}
        _save(out / "inputs.npz", inputs)
        bj = {k: jax.numpy.asarray(v) for k, v in inputs.items()}
        for name in FAMILIES:
            m0 = JM.Model(JC.ModelConfig(**FAMILY_KW[name]), JD.DistConfig())
            params = m0.init(jax.random.key(0))
            _save(out / f"params_{name}.npz", _flat(params))
            g = jax.jit(jax.grad(lambda p, b, m0=m0: m0.loss(
                p, b, jax.random.key(7))))(params, bj)
            _save(out / f"want_{name}.npz", _flat(g))


class _Run:
    """The module's runs, started together by the fixture; each test waits
    for the file or run it reads (so no test waits for them all)."""

    def __init__(self, out, procs, spawns):
        self.out, self.procs, self.spawns = out, procs, spawns
        self._serve_ref = None

    def file(self, name) -> dict:
        """An npz a run writes, once it is there."""
        path = self.out / name
        deadline = time.monotonic() + REF_TIMEOUT
        while not path.exists():
            for proc in self.procs.values():
                if proc.poll() not in (None, 0):
                    raise AssertionError(proc.communicate()[0][-4000:])
            for th, box in self.spawns.values():
                if "error" in box:
                    raise box["error"]
            assert time.monotonic() < deadline, f"no {name}"
            time.sleep(0.1)
        return dict(np.load(path))

    def ranks(self, name):
        th, box = self.spawns[name]
        th.join()
        if "error" in box:
            raise box["error"]
        return box["ranks"]

    def grads(self, name) -> dict:
        """Family `name`'s gathered gradients from spawn A."""
        return self.file(f"grads_{name}.npz")

    def want(self, name) -> dict:
        """The reference's jitted one-device gradients of family `name`."""
        return self.file(f"want_{name}.npz")

    def params(self, name) -> dict:
        return self.file(f"params_{name}.npz")

    def serve_ref(self):
        if self._serve_ref is None:
            proc = self.procs["serve"]
            log, _ = proc.communicate(timeout=REF_TIMEOUT)
            assert proc.returncode == 0, log[-4000:]
            self._serve_ref = dict(np.load(self.out / "serve_ref.npz"))
        return self._serve_ref


@pytest.fixture(scope="module")
def tp_run(tmp_path_factory):
    import repro_torch.launch.serve  # noqa: F401  (imports before threads)
    import repro_torch.serve_batched  # noqa: F401
    import repro_torch.train_lm_distributed  # noqa: F401
    from repro_torch.launch.mesh import run_ranks
    out = tmp_path_factory.mktemp("tp")
    path = os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests")])
    procs = {}
    # the one-device gradients on one XLA thread (beside loaded test
    # workers, spinning thread pools thrash); serving on 4 virtual devices
    for name, main, flags in (
            ("grads", "reference_grads_main",
             "--xla_cpu_multi_thread_eigen=false "
             "intra_op_parallelism_threads=1"),
            ("serve", "reference_serve_main",
             "--xla_force_host_platform_device_count=4 "
             "--xla_cpu_multi_thread_eigen=false "
             "intra_op_parallelism_threads=1")):
        procs[name] = subprocess.Popen(
            [sys.executable, "-c", f"import sys, test_torch_tp as t; "
             f"t.{main}(sys.argv[1])", str(out)],
            env=dict(os.environ, XLA_FLAGS=flags, JAX_PLATFORMS="cpu",
                     PYTHONPATH=path),
            cwd=str(ROOT / "tests"), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    spawns = {}
    for name, fn in (("grads", tp_rank_main), ("serve", serve_rank_main)):
        box = {}

        def ranks(fn=fn, box=box):
            try:
                box["ranks"] = run_ranks(fn, DATA * MODEL, backend="gloo",
                                         device="cpu",
                                         args=(str(out / "inputs.npz"),),
                                         timeout=RANK_TIMEOUT)
            except BaseException as e:     # re-raised in the main thread
                box["error"] = e
        th = threading.Thread(target=ranks)
        th.start()
        spawns[name] = (th, box)
    yield _Run(out, procs, spawns)
    for proc in procs.values():
        if proc.poll() is None:
            proc.communicate(timeout=REF_TIMEOUT)
    for th, _ in spawns.values():
        th.join()


# ---- tests --------------------------------------------------------------------

def test_dist_checks_families_are_read():
    assert set(FAMILY_KW) == set(FAMILIES) and set(TOL) == set(FAMILIES)


@pytest.mark.parametrize("sp", [False, True], ids=["sp_off", "sp_on"])
@pytest.mark.parametrize("name", FAMILIES)
def test_grad_equivalence_matches_reference(tp_run, name, sp):
    want = tp_run.want(name)
    tag = f"sp_{'on' if sp else 'off'}/"
    got = {k[len(tag):]: v for k, v in tp_run.grads(name).items()
           if k.startswith(tag)}
    assert sorted(got) == sorted(want)
    worst = max(float(np.abs(got[k] - want[k]).max()
                      / (np.abs(want[k]).max() + 1e-9)) for k in want)
    print(name, sp, f"worst {worst:.3e}")
    assert worst < TOL[name], (name, sp, worst)


def test_boundary_ops_match_their_definitions(tp_run):
    for rank, res in enumerate(tp_run.ranks("grads")):
        for name, e in res["ops"].items():
            tol = 1e-6 if name.startswith("vp_xent") else 0.0
            assert e <= tol, (rank, name, e)


def test_serve_prefill_and_decode_match_reference(tp_run):
    ref = tp_run.serve_ref()
    per = SERVE_B // DATA
    for res in tp_run.ranks("serve"):
        s = res["serve"]
        d, m = s["index"]
        rows = slice(d * per, (d + 1) * per)
        for tag, bound in (("prefill", 1e-5), ("decode0", 1e-4),
                           ("decode1", 1e-4)):
            want = ref[tag][rows]
            scale = np.abs(want).max()
            assert np.abs(s[tag] - want).max() <= bound * scale, (tag, d, m)
        for i in range(3):
            for leaf, got in s[f"cache{i}"].items():
                full = ref[f"cache{i}/{leaf}"]
                Ss = full.shape[-1 if leaf == "slot_pos" else 3] // MODEL
                if leaf == "slot_pos":
                    want = full[:, m * Ss:(m + 1) * Ss]
                    np.testing.assert_array_equal(got, want)
                    continue
                want = full[:, rows, :, m * Ss:(m + 1) * Ss]
                assert got.shape == want.shape, (leaf, got.shape)
                assert np.abs(got - want).max() <= \
                    1e-5 * max(np.abs(want).max(), 1e-30), (i, leaf, d, m)


def test_serve_params_are_the_families_init(tp_run):
    dense = tp_run.params("dense")
    for k, v in tp_run.serve_ref().items():
        if k.startswith("params/"):
            np.testing.assert_array_equal(v, dense[k[len("params/"):]],
                                          err_msg=k)


def test_serve_cli_across_ranks_matches_one_device(tp_run):
    """serve --data 2 --model 2's rank function (the path the one-device
    port refused): every rank's rows of the greedy continuation equal the
    one-device serve's on the same params and prompts (llama3 smoke: its
    heads divide the model axis, so the declared params are the one-device
    ones), logits within 1e-4 of max |logit|."""
    from repro_torch import random as R
    from repro_torch.configs import get_smoke
    from repro_torch.launch import serve
    from repro_torch.models import DistConfig, Model
    cfg = get_smoke("llama3-405b")
    model = Model(cfg, DistConfig())
    params = model.init(R.key(0), device="cpu")
    batch = serve.make_batch(cfg, 4, 8, 0, torch.device("cpu"))
    want = serve.generate(model, params, batch, 4, keep_logits=True)
    for r in tp_run.ranks("serve"):
        r = r["cli"]
        d, _ = r["index"]
        rows = slice(2 * d, 2 * d + 2)
        np.testing.assert_array_equal(r["tokens"],
                                      want["tokens"][rows].numpy())
        for got, w in zip(r["logits"], want["logits"]):
            w = w[rows].numpy()
            assert np.abs(got - w).max() <= 1e-4 * np.abs(w).max()


def test_examples_run_across_ranks(tp_run):
    """The ported examples' rank functions on (data 2, model 2): every rank
    reports the same finite losses and the same continuations, which
    equal the one-device serve of the example's engine params and
    prompts."""
    from repro_torch import random as R
    from repro_torch import serve_batched as SB
    from repro_torch.launch.engine import Engine
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.serve import generate
    ranks = tp_run.ranks("serve")
    losses = [r["train_example"] for r in ranks]
    assert all(l == losses[0] for l in losses)
    assert len(losses[0]) == 2 and all(np.isfinite(losses[0]))
    eng = Engine(SB.CFG, make_host_mesh(data=1, model=1), device="cpu")
    params, _ = eng.init_state(seed=1)
    g = R.generator(R.key(0))
    prompts = torch.randint(0, SB.CFG.vocab, (SB.BATCH, SB.PROMPT),
                            generator=g)
    want = generate(eng.model, params, {"tokens": prompts}, 3)["tokens"]
    for r in ranks:
        assert r["serve_example"].shape == (SB.BATCH, 3)
        np.testing.assert_array_equal(r["serve_example"], want.numpy())


def test_tp_decode_with_padding_heads(tp_run):
    """ROADMAP Queue 3 item 18: phi4 smoke's 3 heads at model 2 (one
    padding head). Every rank's rows of the port's TP decode step are
    finite and within 1e-4 of max |logit| of the port's one-device
    decode on the same params without the padding head; the reference's
    TP decode of the same inputs is NaN (its split-KV gather of a kv head
    past the last)."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import DistConfig, Model
    cfg = get_smoke("phi4-mini-3.8b")
    ref = tp_run.serve_ref()
    assert np.isnan(ref["phi4_decode"]).all(), \
        "the reference's TP decode with a padding head is not NaN"
    assert np.isfinite(ref["phi4_prefill"]).all()
    flat = tp_run.file("params_phi4.npz")
    hd = cfg.n_heads * cfg.d_head
    assert flat["blocks/wq"].shape[-1] == 4 * cfg.d_head   # padded to 4
    flat = dict(flat, **{"blocks/wq": flat["blocks/wq"][..., :hd],
                         "blocks/wo": flat["blocks/wo"][:, :hd]})
    model = Model(cfg, DistConfig())
    tokens = torch.from_numpy(tp_run.file("inputs.npz")["tokens"][:SERVE_B]
                              .astype(np.int64))
    params = _params(flat)
    _, cache = model.prefill(params, {"tokens": tokens},
                             cache_len=SERVE_CACHE)
    want, _ = model.decode_step(params, tokens[:, 0], SEQ, cache)
    want = want[:, :cfg.vocab].numpy()
    per = SERVE_B // DATA
    for res in tp_run.ranks("serve"):
        got = res["pad_heads"]
        d, _ = got["index"]
        g = got["decode"][:, :cfg.vocab]
        w = want[d * per:(d + 1) * per]
        assert np.isfinite(g).all()
        assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max(), d
