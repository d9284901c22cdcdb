"""The pod axis (launch/mesh.py's (pod, data, model) meshes, models/dist.py's
flattened ("pod", "data") group, the Engine with dp = ("pod", "data"))
against the JAX package, on 4 gloo CPU ranks.

The module's first test starts, together:
  - the reference in a subprocess with 4 virtual CPU devices (the jax-0.9
    shim, threefry_partitionable(False), one XLA thread): llama3 smoke in
    f32, momentum SGD (lr 0.05), 2 steps on Mesh(devices.reshape(2, 2,
    1), ("pod", "data", "model")), with no compressor and with QSGD(16)
    layerwise;
  - one run_ranks spawn of 4 gloo ranks, in a thread: the port's Engine,
    both cases, on (pod 2, data 2, model 1) and (data 4, model 1), then on
    (pod 2, data 1, model 2) and (data 2, model 2); each rank writes its
    own shards (on the model-1 meshes the global arrays) a (twin, case)
    as it finishes them.
Both start from the same inputs, written first: the port's init params
(Model.init(key(0))) and numpy batches of 8 x 16 tokens. The reference
writes each case's results as it finishes it, and each test waits for
the files it reads.

Tolerances, ROADMAP Queue 3 item 15's rules (tests/test_torch_engine.py
holds the same on the data axis): no compressor: each loss within 1e-5
relative, every param leaf within 1e-4 of its largest |change| over the
run plus one f32 ulp of its largest entry, the momentum within 1e-4 of
its max; QSGD(16): step 0's loss within 1e-5, its momentum at most 0.1%
of entries beyond 1e-4 of their leaf's max, each at most one level L = G
/ (16 n) off (G the largest rank's gradient norm); step 1's loss within
1e-4 and the final params the same share rule against 1e-4 of their
leaf's change, each within lr (2 + beta) L. Within the port, bitwise:
(pod 2, data 2) against (data 4): the flattened group's ranks are the
data group's in pod-major order, so the rank-order sums, the worker keys
and the batch rows are the same; (pod 2, data 1, model 2) against (data
2, model 2).

This module imports no jax at module level: the spawned ranks import it.
"""
import os
import pathlib
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import test_torch_engine as TE

ROOT = pathlib.Path(__file__).resolve().parents[1]
STEPS = 2
BATCH, SEQ = 8, 16
LR = 0.05
LEVELS = 16
CASES = ("dense", "qsgd")
MESHES = {"pod": (2, 2, 1), "data4": (4, 1), "pod_tp": (2, 1, 2),
          "data_tp": (2, 2)}
TWINS = (("pod", "data4"), ("pod_tp", "data_tp"))
RANK_TIMEOUT = 300.0
REF_TIMEOUT = 600.0


# ---- the reference (subprocess) -----------------------------------------------

def reference_main(out_dir: str) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from test_torch_ref import reference
    out = pathlib.Path(out_dir)
    inputs = dict(np.load(out / "inputs.npz"))
    mods = ("repro.launch.engine", "repro.configs.registry", "repro.optim")
    with reference(*mods) as ref:
        E = sys.modules["repro.launch.engine"]
        mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(
            MESHES["pod"]), ("pod", "data", "model"))
        cfg = ref.registry.get_smoke("llama3-405b")
        opt = ref.optim.OptConfig("momentum", lr=LR)
        for case in CASES:
            # a fresh copy a case: the step donates its params
            params = jax.tree_util.tree_map(jnp.asarray,
                                            TE._unflat(inputs, "params"))
            comp = None if case == "dense" else ref.core.CompressionConfig(
                qw=ref.core.make_compressor("qsgd", levels=LEVELS),
                granularity=ref.core.Granularity("layerwise"))
            eng = E.Engine(cfg, mesh, comp=comp, opt=opt)
            put = lambda t, ps: jax.tree_util.tree_map(
                lambda x, p: jax.device_put(x, NamedSharding(mesh, p)), t, ps)
            p = put(params, eng.model.param_pspecs())
            st = put(ref.optim.init_opt_state(opt, params),
                     eng._opt_pspecs())
            step = eng.build_train_step()
            res = {}
            for i in range(STEPS):
                b = {k: jnp.asarray(inputs[f"batch{i}/{k}"])
                     for k in ("tokens", "targets")}
                p, st, m = step(p, st, b, jnp.int32(i))
                res[f"{i}/loss"] = np.float32(m["loss"])
                res.update({f"{i}/params/{k}": v
                            for k, v in TE._flat_np(p).items()})
                res.update({f"{i}/m/{k}": v
                            for k, v in TE._flat_np(st["m"]).items()})
            np.savez(out / "results.tmp.npz", **res)
            os.replace(out / "results.tmp.npz", out / f"results_{case}.npz")


# ---- the port's ranks ---------------------------------------------------------

def _comp(case):
    from repro_torch.core import CompressionConfig, Granularity, \
        make_compressor
    if case == "dense":
        return None
    return CompressionConfig(qw=make_compressor("qsgd", levels=LEVELS),
                             granularity=Granularity("layerwise"))


def _batch(inputs, i):
    return {k: torch.from_numpy(inputs[f"batch{i}/{k}"].astype(np.int64))
            for k in ("tokens", "targets")}


def write_inputs(path: pathlib.Path) -> None:
    """The port's init params of llama3 smoke and STEPS numpy batches."""
    from repro_torch import random as R
    from repro_torch.configs import get_smoke
    from repro_torch.models import DistConfig, Model
    cfg = get_smoke("llama3-405b")
    params = Model(cfg, DistConfig()).init(R.key(0), device="cpu")
    inputs = {f"params/{k}": v for k, v in TE._host_tree(params).items()}
    rng = np.random.default_rng(0)
    for i in range(STEPS):
        s = rng.integers(0, cfg.vocab, (BATCH, SEQ + 1), dtype=np.int32)
        inputs[f"batch{i}/tokens"] = s[:, :-1].copy()
        inputs[f"batch{i}/targets"] = s[:, 1:].copy()
    np.savez(path, **inputs)


def _save(path: pathlib.Path, arrays: dict) -> None:
    np.savez(path.with_suffix(".tmp.npz"), **arrays)
    os.replace(path.with_suffix(".tmp.npz"), path)


def pod_rank_main(rank, world, dev, out_dir):
    """Every case on every mesh of MESHES, a twin at a time: after each
    (twin, case) this rank writes rank{r}_{pod}_{case}.npz, both meshes'
    losses, params and momentum after each step (its own shards), and
    with the pod mesh's QSGD case its step-0 gradient norm."""
    from repro_torch.configs import get_smoke
    from repro_torch.convert import params_from_jax, tree_leaves
    from repro_torch.launch.engine import Engine
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import OptConfig, init_opt_state
    torch.set_num_threads(1)
    out_dir = pathlib.Path(out_dir)
    meshes = {name: make_mesh(MESHES[name], ("pod", "data", "model")
                              if len(MESHES[name]) == 3
                              else ("data", "model"))
              for name in MESHES}
    inputs = dict(np.load(out_dir / "inputs.npz"))
    params0 = params_from_jax(TE._unflat(inputs, "params"), device=dev)
    opt = OptConfig("momentum", lr=LR)
    for twin in TWINS:
        for case in CASES:
            rec = {}
            for name in twin:
                eng = Engine(get_smoke("llama3-405b"), meshes[name],
                             comp=_comp(case), opt=opt, device=dev)
                params = eng.shard_tree(params0,
                                        eng.model.param_pspecs())
                state = init_opt_state(opt, params)
                step = eng.build_train_step()
                if name == "pod" and case == "qsgd":
                    _, g = step.grads(params, _batch(inputs, 0), 0)
                    rec["grad_norm"] = np.float64(torch.sqrt(sum(
                        torch.sum(x.double() ** 2) for x in tree_leaves(g))))
                for i in range(STEPS):
                    params, state, m = step(params, state,
                                            _batch(inputs, i), i)
                    rec[f"{name}/{i}/loss"] = np.float32(m["loss"])
                    for part, tree in (("params", params),
                                       ("m", state["m"])):
                        rec.update({f"{name}/{i}/{part}/{k}": v for k, v
                                    in TE._host_tree(tree).items()})
            _save(out_dir / f"rank{rank}_{twin[0]}_{case}.npz", rec)


# ---- the module fixture -------------------------------------------------------

def _wait(path: pathlib.Path, failed):
    deadline = time.monotonic() + REF_TIMEOUT
    while not path.exists():
        failed()
        assert time.monotonic() < deadline, f"no {path}"
        time.sleep(0.05)


class _Run:
    def __init__(self, out, proc, thread, box):
        self.out, self.proc, self.thread, self.box = out, proc, thread, box

    def _proc_failed(self):
        if self.proc.poll() not in (None, 0):
            log, _ = self.proc.communicate()
            raise AssertionError(log[-4000:])

    def _ranks_failed(self):
        if "error" in self.box:
            raise self.box["error"]

    def ref(self, case):
        path = self.out / f"results_{case}.npz"
        _wait(path, self._proc_failed)
        return dict(np.load(path))

    def inputs(self):
        return dict(np.load(self.out / "inputs.npz"))

    def ranks(self, twin, case):
        """Every rank's records of (twin, case), in rank order."""
        paths = [self.out / f"rank{r}_{twin[0]}_{case}.npz"
                 for r in range(4)]
        for path in paths:
            _wait(path, self._ranks_failed)
        return [dict(np.load(path)) for path in paths]


@pytest.fixture(scope="module")
def pod_run(tmp_path_factory):
    import repro_torch.launch.engine  # noqa: F401  (imports before threads)
    from repro_torch.launch.mesh import run_ranks
    out = tmp_path_factory.mktemp("pod")
    write_inputs(out / "inputs.npz")
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4 "
                         "--xla_cpu_multi_thread_eigen=false "
                         "intra_op_parallelism_threads=1",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           str(ROOT / "tests")]))
    proc = subprocess.Popen(
        [sys.executable, "-c", "import sys, test_torch_pod as t; "
         "t.reference_main(sys.argv[1])", str(out)], env=env,
        cwd=str(ROOT / "tests"), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    box = {}

    def ranks():
        try:
            run_ranks(pod_rank_main, 4, backend="gloo", device="cpu",
                      args=(str(out),), timeout=RANK_TIMEOUT)
        except BaseException as e:     # re-raised in the main thread
            box["error"] = e
    th = threading.Thread(target=ranks)
    th.start()
    yield _Run(out, proc, th, box)
    th.join()
    if proc.poll() is None:
        proc.kill()
    if not proc.stdout.closed:
        proc.communicate()


# ---- the tests ------------------------------------------------------------------

@pytest.mark.parametrize("twin,case", [(t, c) for t in TWINS
                                       for c in CASES],  # the ranks' order
                         ids=[f"{t[0]}-{c}" for t in TWINS for c in CASES])
def test_pod_mesh_bitwise_its_data_twin(pod_run, twin, case):
    """(pod 2, data 2, model 1) gives every rank the losses, params and
    momentum of (data 4, model 1), and (pod 2, data 1, model 2) those of
    (data 2, model 2), bit for bit, with and without QSGD(16)."""
    pod, data = twin
    for rank, r in enumerate(pod_run.ranks(twin, case)):
        for i in range(STEPS):
            assert r[f"{pod}/{i}/loss"] == r[f"{data}/{i}/loss"], (rank, i)
            for part in ("params", "m"):
                TE._bitwise_trees(TE._ref_tree(r, f"{pod}/{i}/{part}"),
                                  TE._ref_tree(r, f"{data}/{i}/{part}"),
                                  (rank, pod, case, i, part))


@pytest.mark.parametrize("case", CASES)
def test_pod_engine_matches_reference(pod_run, case):
    """The port's Engine on (pod 2, data 2, model 1) against the
    reference's on 4 virtual devices, within item 15's rules (model 1:
    rank 0's shards are the global arrays)."""
    ranks = pod_run.ranks(TWINS[0], case)
    ref = pod_run.ref(case)
    inputs = pod_run.inputs()
    p0 = TE._ref_tree(inputs, "params")
    last = TE._ref_tree(ref, f"{STEPS - 1}/params")
    change = {k: np.abs(last[k].astype(np.float64) - p0[k]).max()
              for k in p0}
    got = ranks[0]
    for i in range(STEPS):
        loss = float(got[f"pod/{i}/loss"])
        rel = abs(loss - float(ref[f"{i}/loss"])) / abs(
            float(ref[f"{i}/loss"]))
        gp, gm = (TE._ref_tree(got, f"pod/{i}/{part}")
                  for part in ("params", "m"))
        rp, rm = TE._ref_tree(ref, f"{i}/params"), TE._ref_tree(ref, f"{i}/m")
        mscale = {k: np.abs(v).max() for k, v in rm.items()}
        if case == "qsgd":
            level = 1.001 * max(float(r["grad_norm"]) for r in ranks) / (
                LEVELS * 4)
        if case == "qsgd" and i == 0:
            assert rel <= 1e-5, (case, i, rel)
            TE._share_close(gm, rm, mscale, 1e-4, level, (case, i))
        elif case == "qsgd":
            assert rel <= 1e-4, (case, i, rel)
            TE._share_close(gp, rp, change, 1e-4, LR * (2 + 0.9) * level,
                            (case, i))
        else:
            assert rel <= 1e-5, (case, i, rel)
            TE._leaf_close(gp, rp, change, 1e-4, (case, i))
            TE._leaf_close(gm, rm, mscale, 1e-4, (case, i))
