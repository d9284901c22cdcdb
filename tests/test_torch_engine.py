"""The port's data-parallel Engine (launch/engine.py), its train CLI
(launch/train.py) with checkpoints and resume, comm_sched and the mesh
builders against the JAX package's, on the CPU.

The reference runs in two subprocesses started with the module, one per
rank count (4 virtual CPU devices, the jax-0.9 shim,
threefry_partitionable(False), meshes Mesh(devices[:n].reshape(n, 1),
("data", "model")) with the params and optimizer state placed on the
engine's shardings, so each step compiles once). The n = 2 one first
writes the shared inputs: its init_state params (llama3 smoke, and
internvl2 smoke for the step guard) and its lm_batches (8 x 16 tokens a
step; the VLM's patch embeddings from numpy). The port runs every case
of both rank counts inside ONE run_ranks spawn of 4 gloo CPU ranks (the
2-rank cases on a group of its first two), params from params_from_jax,
while the reference goes on with its steps. The CLI's checkpointing run
is the uninterrupted run that a fresh resumed run is held against.
Momentum SGD (lr 0.05) over 2 steps: after step 0 the momentum is the
aggregated gradient itself (fma(0, beta, g) = g in both packages).

The reference runs the simulated-record cases (dense, QSGD(16) layerwise
and entire-model, top-k(1%), train_microbatch=2, the step guard), and
the port runs them at both rank counts. The port's wire, allgather and
ring runs are each the bitwise twin of a simulated run
(test_engine_within_the_port), run at one rank count each (the wire
twins at 2, allgather and the ring at 4), and are held against the
reference's simulated run of the same compressor. The reference's
Engine runs no wire case here: each wire step it compiles costs more
than the module's test-time budget leaves under a loaded parallel run.
What ties the port's wire path to the reference's own wire path is the
step the Engine aggregates with: test_torch_allreduce.py holds the
port's compressed_allreduce with wire=True (QSGD, TernGrad, signSGD,
natural, top-k; simulated and allgather, QSGD entire-model too) bitwise
against the reference's wire=True compressed_allreduce under
jax.shard_map on 2 and 4 virtual devices, and test_torch_stream.py its
ring and rs_stream. So at 4 devices, on those inputs, the reference's
wire run equals the port's, which equals the port's simulated run,
which equals the reference's simulated run: the reference's
wire-equals-simulated contract is checked there, not assumed.

Tolerances (ROADMAP Queue 3, items 1 and 11; item 15 has the largest
errors seen):
  - dense, top-k(1%), train_microbatch=2 and the step guard: each step's
    loss within 1e-5 relative, every param leaf within 1e-4 of the
    largest |change| of that leaf over the run plus one f32 ulp of its
    largest entry (the rounding of p - lr m), the momentum within 1e-4
    of its max (item 11's gradient tolerance carried through lr);
  - QSGD(16): step 0's loss within 1e-5 relative; its aggregate (the
    momentum after step 0) has at most 0.1% of its entries more than
    1e-4 of their leaf's max |m| from the reference's, each at most one
    quantization level L (the largest rank's gradient norm / (16 n)) off:
    item 1's rule, the unit norms summing in another order and a code
    flipping where |x| / norm * 16 + u lands within ulps of an integer.
    Step 1 starts from those params: its loss within 1e-4 relative, and
    the final params hold the same share rule against 1e-4 of their
    leaf's largest |change|, each off by at most lr (2 + beta) L.
Within the port, bitwise: every rank's params; wire=True against the
simulated records; the ring against allgather; the step guard's skipped
step leaves params and momentum unchanged.

This module imports no jax at module level: the spawned ranks import it.
"""
import contextlib
import dataclasses
import io
import json
import math
import os
import pathlib
import subprocess
import sys
import time
from typing import Optional, Tuple

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
N_RANKS = (2, 4)
STEPS = 2
BATCH, SEQ = 8, 16
LR = 0.05
LEVELS = 16
NAN_ROW = 4          # one rank's row: rank 1 of 2, rank 2 of 4
RANK_TIMEOUT = 300.0
REF_TIMEOUT = 900.0
ARCHS = ("llama3-405b", "internvl2-2b")
CLI = ["--arch", "llama3-405b", "--smoke", "--data", "2", "--compressor",
       "qsgd", "--granularity", "layerwise", "--wire", "--fusion-bytes",
       "65536"]
MEMORY = (("llama3-405b", True, 2, "train", 128, 8),
          ("phi4-mini-3.8b", False, 2, "train", 4096, 256),
          ("mamba2-1.3b", False, 4, "prefill", 2048, 32),
          ("zamba2-7b", False, 4, "decode", 4096, 64))
FUSIONS = (0.0, 65536.0, math.inf)
# the CLI's own run here: 4 steps, a checkpoint every 2
CLI_RUN = CLI + ["--steps", "4", "--device", "cpu", "--backend", "gloo",
                 "--batch", "8", "--seq", "16", "--ckpt-every", "2"]


@dataclasses.dataclass(frozen=True)
class Case:
    name: str
    comp: str = "none"
    gran: str = "layerwise"
    wire: bool = False
    collective: Optional[str] = None
    microbatch: int = 1
    guard: bool = False
    arch: str = "llama3-405b"
    like: Optional[str] = None   # the reference case it is held against,
                                 # of which the port's run is the bitwise
                                 # twin (None: the reference runs it)
    at: Tuple[int, ...] = N_RANKS   # rank counts the port runs it at


# the reference's cases run at both rank counts; each twin at one (the
# ring and allgather at 4, where the ring makes 3 hops)
CASES = (
    Case("dense"),
    Case("qsgd_layerwise", "qsgd"),
    Case("qsgd_layerwise_wire", "qsgd", wire=True, like="qsgd_layerwise",
         at=(2,)),
    Case("qsgd_entire_model", "qsgd", "entire_model"),
    Case("qsgd_entire_model_wire", "qsgd", "entire_model", wire=True,
         like="qsgd_entire_model", at=(2,)),
    Case("qsgd_layerwise_allgather", "qsgd", wire=True,
         collective="allgather", like="qsgd_layerwise", at=(4,)),
    Case("qsgd_layerwise_ring", "qsgd", wire=True, collective="ring",
         like="qsgd_layerwise", at=(4,)),
    Case("topk_layerwise", "topk"),
    Case("topk_layerwise_wire", "topk", wire=True, like="topk_layerwise",
         at=(2,)),
    Case("dense_microbatch2", microbatch=2),
    Case("step_guard_nan", guard=True, arch="internvl2-2b"),
)
TWINS = (("qsgd_layerwise_wire", "qsgd_layerwise"),
         ("qsgd_entire_model_wire", "qsgd_entire_model"),
         ("qsgd_layerwise_allgather", "qsgd_layerwise"),
         ("qsgd_layerwise_ring", "qsgd_layerwise_allgather"),
         ("topk_layerwise_wire", "topk_layerwise"))
CASE = {c.name: c for c in CASES}


def _flat_np(tree) -> dict:
    """{path: numpy} of a jax tree (leaf paths joined as the checkpoint
    format's)."""
    import jax
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        k = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path)
        out[k] = np.asarray(leaf)
    return out


def _unflat(flat: dict, prefix: str) -> dict:
    """The nested dict of the entries under `prefix/`."""
    out: dict = {}
    for k, v in flat.items():
        if not k.startswith(prefix + "/"):
            continue
        node = out
        parts = k[len(prefix) + 1:].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def _batch_np(inputs: dict, case: Case, i: int) -> dict:
    b = {k: inputs[f"{case.arch}/batch{i}/{k}"]
         for k in ("tokens", "targets", "patch_embeds")
         if f"{case.arch}/batch{i}/{k}" in inputs}
    if case.guard and i == 0:
        b["patch_embeds"] = b["patch_embeds"].copy()
        b["patch_embeds"][NAN_ROW] = np.nan
    return b


# ---- the reference (one subprocess for the module) --------------------------

def reference_main(out_dir: str, n: int) -> None:
    """The reference's run on n virtual devices, one process per n, both
    started together. The n = 2 process writes inputs.npz (the
    reference's init params and batches) first, and last results.json
    (the CLI's header lines, memory estimates, schedule reports, batch
    specs, the EF error); the other reads those inputs. Each writes
    results{n}.npz: every case's losses, skipped flags, params and
    momentum after each step."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from test_torch_ref import reference
    out = pathlib.Path(out_dir)
    mods = ("repro.launch.engine", "repro.launch.train",
            "repro.launch.comm_sched", "repro.configs.registry",
            "repro.optim", "repro.models.config")
    res, meta = {}, {"seconds": {}}
    t0 = time.perf_counter()
    with reference(*mods) as ref:
        E, T = sys.modules["repro.launch.engine"], sys.modules[
            "repro.launch.train"]
        CS = sys.modules["repro.launch.comm_sched"]

        def mesh_of(n):
            return jax.sharding.Mesh(np.array(jax.devices()[:n]).reshape(
                n, 1), ("data", "model"))

        def comp_of(case):
            if case.comp == "none":
                return None
            kw = {"levels": LEVELS} if case.comp == "qsgd" else {
                "ratio": 0.01}
            return ref.core.CompressionConfig(
                qw=ref.core.make_compressor(case.comp, **kw),
                granularity=ref.core.Granularity(case.gran))

        def cfg_of(case):
            return dataclasses.replace(ref.registry.get_smoke(case.arch),
                                       train_microbatch=case.microbatch)

        opt = ref.optim.OptConfig("momentum", lr=LR)
        if n == N_RANKS[0]:
            inputs = {}
            for arch in ARCHS:
                cfg = ref.registry.get_smoke(arch)
                params, _ = E.Engine(cfg, mesh_of(1), opt=opt).init_state(0)
                inputs.update({f"{arch}/params/{k}": v
                               for k, v in _flat_np(params).items()})
                it = ref.synthetic.lm_batches(cfg.vocab, BATCH, SEQ, seed=0)
                rng = np.random.default_rng(7)
                for i in range(STEPS):
                    b = next(it)
                    for k in ("tokens", "targets"):
                        inputs[f"{arch}/batch{i}/{k}"] = np.asarray(b[k])
                    if cfg.arch_type == "vlm":
                        inputs[f"{arch}/batch{i}/patch_embeds"] = (
                            0.02 * rng.standard_normal(
                                (BATCH, cfg.frontend_seq, cfg.d_model))
                        ).astype(np.float32)
            np.savez(out / "inputs.tmp.npz", **inputs)
            os.replace(out / "inputs.tmp.npz", out / "inputs.npz")
        else:
            while not (out / "inputs.npz").exists():
                time.sleep(0.1)
            inputs = dict(np.load(out / "inputs.npz"))
        meta["seconds"]["inputs"] = time.perf_counter() - t0

        mesh = mesh_of(n)
        for case in CASES:
            if case.like is not None:
                continue
            eng = E.Engine(cfg_of(case), mesh, comp=comp_of(case),
                           opt=opt)
            put = lambda t, ps: jax.tree_util.tree_map(
                lambda x, p: jax.device_put(x, NamedSharding(mesh, p)),
                t, ps)
            params = put(jax.tree_util.tree_map(
                jnp.asarray, _unflat(inputs, f"{case.arch}/params")),
                eng.model.param_pspecs())
            state = put(ref.optim.init_opt_state(opt, params),
                        eng._opt_pspecs())
            step = eng.build_train_step(
                wire=case.wire, collective=case.collective,
                step_guard=case.guard)
            for i in range(STEPS):
                b = _batch_np(inputs, case, i)
                params, state, m = step(params, state, b, jnp.int32(i))
                tag = f"{n}/{case.name}/{i}"
                res[f"{tag}/loss"] = np.float32(m["loss"])
                if case.guard:
                    res[f"{tag}/skipped"] = np.float32(m["skipped"])
                for k, v in _flat_np(params).items():
                    res[f"{tag}/params/{k}"] = v
                for k, v in _flat_np(state["m"]).items():
                    res[f"{tag}/m/{k}"] = v
            meta["seconds"][f"{n}/{case.name}"] = time.perf_counter() - t0
        np.savez(out / f"results{n}.npz", **res)
        if n != N_RANKS[0]:
            return

        def host_mesh(data=1, model=1, pod=None):
            return mesh_of(data * model)
        T.make_host_mesh = host_mesh
        lines = io.StringIO()
        with contextlib.redirect_stdout(lines):
            T.main(CLI + ["--steps", "0"])
        meta["cli"] = lines.getvalue().splitlines()
        meta["seconds"]["cli"] = time.perf_counter() - t0

        meta["batch"] = {}
        IS = sys.modules["repro.models.config"].InputShape
        for arch in ARCHS:
            eng = E.Engine(ref.registry.get_smoke(arch), mesh_of(2), opt=opt)
            for shape in (IS("train", SEQ, BATCH, "train"),
                          IS("decode", SEQ, BATCH, "decode"),
                          IS("prefill", SEQ, 3, "prefill")):
                meta["batch"][f"{arch}/{shape.kind}/{shape.global_batch}"] = {
                    k: [list(v.shape), str(v.dtype),
                        list(eng.batch_pspecs(shape)[k])]
                    for k, v in eng.batch_shapes(shape).items()}

        meta["memory"] = []
        for arch, smoke, n, kind, seq, batch in MEMORY:
            cfg = (ref.registry.get_smoke(arch) if smoke
                   else ref.registry.get_config(arch))
            eng = E.Engine(cfg, mesh_of(n), opt=opt)
            shape = sys.modules["repro.models.config"].InputShape(
                kind, seq, batch, kind)
            meta["memory"].append({k: (bool(v) if isinstance(v, bool)
                                       else float(v))
                                   for k, v in
                                   eng.memory_estimate(shape).items()})

        meta["schedules"] = []
        qsgd = comp_of(CASES[1])
        eng = E.Engine(ref.registry.get_smoke("llama3-405b"), mesh_of(2),
                       comp=qsgd, opt=opt)
        for fb in FUSIONS:
            s = CS.engine_schedule(eng, fb)
            rep = CS.schedule_report(s, qsgd, 2)
            meta["schedules"].append(json.loads(json.dumps(rep)))

        efc = dataclasses.replace(qsgd, error_feedback=True)
        eng = E.Engine(ref.registry.get_smoke("llama3-405b"), mesh_of(2),
                       comp=efc, opt=opt)
        try:
            params, state = eng.init_state(0)
            eng.build_train_step()(params, state,
                                   _batch_np(inputs, CASES[0], 0),
                                   jnp.int32(0))
            meta["ef_error"] = None
        except ValueError as e:
            meta["ef_error"] = str(e)
    (out / "results.json").write_text(json.dumps(meta))


@pytest.fixture(scope="module", autouse=True)
def reference_run(tmp_path_factory):
    """Start the reference's two subprocesses with the module's first
    test; the tests that need their inputs or results wait for them."""
    out = tmp_path_factory.mktemp("engine")
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           str(ROOT / "tests")]))
    procs = [subprocess.Popen(
        [sys.executable, "-c", "import sys, test_torch_engine as t; "
         "t.reference_main(sys.argv[1], int(sys.argv[2]))", str(out),
         str(n)], env=env, cwd=str(ROOT / "tests"), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for n in N_RANKS]
    box = {}

    def inputs():
        path = out / "inputs.npz"
        deadline = time.monotonic() + REF_TIMEOUT
        while not path.exists():
            assert procs[0].poll() is None or path.exists(), \
                procs[0].communicate()[0][-4000:]
            assert time.monotonic() < deadline, "reference inputs"
            time.sleep(0.2)
        return str(path)

    def results():
        if "npz" not in box:
            box["npz"] = {}
            for n, proc in zip(N_RANKS, procs):
                log, _ = proc.communicate(timeout=REF_TIMEOUT)
                assert proc.returncode == 0, log[-4000:]
                box["npz"].update(np.load(out / f"results{n}.npz"))
            box["json"] = json.loads((out / "results.json").read_text())
        return box["npz"], box["json"]
    yield inputs, results, str(out / "inputs.npz")
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


# ---- the port, every case inside one spawn per rank count -------------------

def _port_comp(case: Case):
    from repro_torch.core import CompressionConfig, Granularity, \
        make_compressor
    if case.comp == "none":
        return None
    kw = {"levels": LEVELS} if case.comp == "qsgd" else {"ratio": 0.01}
    return CompressionConfig(qw=make_compressor(case.comp, **kw),
                             granularity=Granularity(case.gran))


def _host_tree(tree) -> dict:
    from repro_torch.convert import tree_leaves, tree_paths
    return {"/".join(p): l.detach().numpy().copy()
            for p, l in zip(tree_paths(tree), tree_leaves(tree))}


def _mesh(n: int, group):
    """A data mesh of the first n ranks (their process group)."""
    from repro_torch.launch.mesh import Mesh
    return Mesh(("data", "model"), (n, 1), {"data": group})


def rank_cases(rank, world, dev, inputs_path):
    """Every CASES case on this rank, for each rank count n of N_RANKS on
    the first n ranks of the one spawn (ranks past n wait) -> {n: {case:
    {step: record}}, and "serve": ...}. The ranks start beside the
    reference and wait here for its inputs."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    deadline = time.monotonic() + REF_TIMEOUT
    while not os.path.exists(inputs_path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"no reference inputs at {inputs_path}")
        time.sleep(0.1)
    inputs = dict(np.load(inputs_path))
    groups = {n: (None if n == world else dist.new_group(list(range(n))))
              for n in N_RANKS}
    out = {}
    for n in N_RANKS:
        if rank < n:
            out[n] = _cases_on_rank(_mesh(n, groups[n]), dev, inputs)
        if n == N_RANKS[0] and rank < n:
            out["serve"] = _serve_on_rank(_mesh(n, groups[n]), dev, inputs)
    return out


def _cases_on_rank(mesh, dev, inputs):
    from repro_torch.configs import get_smoke
    from repro_torch.convert import params_from_jax, tree_leaves
    from repro_torch.launch.engine import Engine
    from repro_torch.optim import OptConfig, init_opt_state
    n = mesh.shape[0]
    out = {}
    for case in CASES:
        if n not in case.at:
            continue
        cfg = dataclasses.replace(get_smoke(case.arch),
                                  train_microbatch=case.microbatch)
        eng = Engine(cfg, mesh, comp=_port_comp(case),
                     opt=OptConfig("momentum", lr=LR), device=dev)
        params = params_from_jax(_unflat(inputs, f"{case.arch}/params"),
                                 device=dev)
        state = init_opt_state(eng.opt, params)
        step = eng.build_train_step(wire=case.wire,
                                    collective=case.collective,
                                    step_guard=case.guard)
        rec = {}
        for i in range(STEPS):
            b = {k: torch.from_numpy(v)
                 for k, v in _batch_np(inputs, case, i).items()}
            if i == 0 and case.comp == "qsgd" and "grad_norm" not in out:
                # this rank's step-0 gradient, the same for every QSGD case
                _, g = step.grads(params, b, 0)
                out["grad_norm"] = float(torch.sqrt(sum(
                    torch.sum(x.double() ** 2) for x in tree_leaves(g))))
            params, state, m = step(params, state, b, i)
            rec[i] = {"loss": float(m["loss"]),
                      "skipped": m.get("skipped"),
                      "params": _host_tree(params),
                      "m": _host_tree(state["m"])}
        out[case.name] = rec
    return out


def _serve_on_rank(mesh, dev, inputs):
    """build_prefill / build_serve_step on the data mesh: this rank's rows
    of the global batch through Model.prefill / decode_step, bitwise the
    model's own calls on those rows."""
    from repro_torch.configs import get_smoke
    from repro_torch.convert import params_from_jax
    from repro_torch.launch.engine import Engine
    from repro_torch.models import InputShape
    n = mesh.shape[0]
    eng = Engine(get_smoke("llama3-405b"), mesh, device=dev)
    params = params_from_jax(_unflat(inputs, "llama3-405b/params"), dev)
    tokens = torch.from_numpy(inputs["llama3-405b/batch0/tokens"])
    tok = tokens[:, 0].contiguous()
    pre = eng.build_prefill(InputShape("prefill", SEQ, BATCH, "prefill"),
                            cache_len=SEQ + 1)
    dec = eng.build_serve_step(InputShape("decode", SEQ + 1, BATCH,
                                          "decode"))
    logits, cache = pre(params, {"tokens": tokens})
    step, _ = dec(params, {"token": tok, "pos": SEQ}, cache)
    r, per = eng._rank(), BATCH // n
    want, wcache = eng.model.prefill(
        params, {"tokens": tokens[r * per:(r + 1) * per]},
        cache_len=SEQ + 1)
    wstep, _ = eng.model.decode_step(params, tok[r * per:(r + 1) * per],
                                     SEQ, wcache)
    return {"rows": tuple(logits.shape), "prefill": torch.equal(logits, want),
            "decode": torch.equal(step, wstep)}


_RANK_RUNS = {}


def port_runs(n: int, inputs_path: str):
    """Rank r's results at rank count n, r < n: one spawn of the largest
    rank count runs both."""
    if not _RANK_RUNS:
        from repro_torch.launch.mesh import run_ranks
        _RANK_RUNS["all"] = run_ranks(
            rank_cases, N_RANKS[-1], backend="gloo", device="cpu",
            args=(inputs_path,), timeout=RANK_TIMEOUT)
    return _RANK_RUNS["all"][:n]


def _bitwise_trees(a: dict, b: dict, what):
    assert a.keys() == b.keys(), what
    for k in a:
        assert a[k].tobytes() == b[k].tobytes(), (what, k)


def _leaf_close(got: dict, want: dict, scale: dict, frac: float, what):
    """Every leaf within frac of its scale (the largest |change| of that
    leaf over the run, or max |m|) plus one f32 ulp of its largest entry
    (the rounding of p - lr m itself) -> the largest error seen, as a
    fraction of the scale."""
    worst = 0.0
    for k, w in want.items():
        s = max(float(scale[k]), 1e-30)
        ulp = float(np.spacing(np.float32(np.abs(w).max())))
        err = float(np.abs(got[k].astype(np.float64) - w).max())
        assert err <= frac * s + ulp, (what, k, err / s)
        worst = max(worst, err / s)
    return worst


def _share_close(got: dict, want: dict, scale: dict, frac: float,
                 level: float, what):
    """QSGD's rule: at most 0.1% of all entries more than frac of their
    leaf's scale apart, each of them at most `level` off -> (share,
    largest difference)."""
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


def _ref_tree(ref: dict, tag: str) -> dict:
    p = tag + "/"
    return {k[len(p):]: v for k, v in ref.items() if k.startswith(p)}


@pytest.mark.timeout(600)
@pytest.mark.parametrize("n", N_RANKS)
def test_engine_within_the_port(n, reference_run):
    """build_prefill / build_serve_step give each rank of the 2-rank mesh
    its rows' logits and cache, bitwise Model.prefill / decode_step on
    those rows. Every rank ends each case with the same bits; wire=True
    equals the simulated records (QSGD(16) layerwise and entire-model,
    top-k(1%)) and allgather equals them, the ring equals allgather,
    bitwise; the step guard skips step 0 on every rank (one rank's batch
    holds a NaN) and leaves params and momentum untouched, then takes
    step 1."""
    inputs, _, path = reference_run
    ranks = port_runs(n, path)
    results = [r[n] for r in ranks]
    for r in ranks[:N_RANKS[0]]:
        serve = r["serve"]
        assert serve["rows"][0] == BATCH // N_RANKS[0]
        assert serve["prefill"] and serve["decode"]
    ran = [c.name for c in CASES if n in c.at]
    for r in range(1, n):
        for name in ran:
            for i in range(STEPS):
                _bitwise_trees(results[r][name][i]["params"],
                               results[0][name][i]["params"], (name, r))
    got = results[0]
    for a, b in TWINS:
        if a not in ran:
            continue
        for i in range(STEPS):
            assert got[a][i]["loss"] == got[b][i]["loss"], (a, b, i)
            _bitwise_trees(got[a][i]["params"], got[b][i]["params"], (a, b))
            _bitwise_trees(got[a][i]["m"], got[b][i]["m"], (a, b))
    guard = got["step_guard_nan"]
    assert guard[0]["skipped"] == 1.0 and guard[1]["skipped"] == 0.0
    assert math.isnan(guard[0]["loss"]) and math.isfinite(guard[1]["loss"])
    inputs_np = dict(np.load(inputs()))
    p0 = _ref_tree(inputs_np, "internvl2-2b/params")
    _bitwise_trees(guard[0]["params"], p0, "guard step 0 params")
    assert all(not v.any() for v in guard[0]["m"].values())
    assert any(v.any() for v in guard[1]["m"].values())


@pytest.mark.timeout(900)
@pytest.mark.parametrize("n", N_RANKS)
def test_engine_matches_reference(n, reference_run):
    """The port's Engine on n gloo ranks against the reference's on n
    virtual devices within the module's stated tolerances: every case the
    reference runs at n against that run, the others against the run of
    their `like` case, of which the port's run is bitwise the twin
    (test_engine_within_the_port): the wire, allgather and ring QSGD runs
    against the reference's simulated run (see the module docstring for
    what holds the wire path against the reference's)."""
    inputs, results, path = reference_run
    ranks = [r[n] for r in port_runs(n, path)]
    port = ranks[0]
    gnorm = max(r["grad_norm"] for r in ranks)
    ref, _ = results()
    inputs_np = dict(np.load(inputs()))
    seen = {}
    for case in CASES:
        if n not in case.at:
            continue
        held = case.like or case.name
        p0 = _ref_tree(inputs_np, f"{case.arch}/params")
        tag = f"{n}/{held}"
        last = _ref_tree(ref, f"{tag}/{STEPS - 1}/params")
        change = {k: np.abs(last[k].astype(np.float64) - p0[k]).max()
                  for k in p0}
        for i in range(STEPS):
            got = port[case.name][i]
            want_loss = float(ref[f"{tag}/{i}/loss"])
            rp = _ref_tree(ref, f"{tag}/{i}/params")
            rm = _ref_tree(ref, f"{tag}/{i}/m")
            if case.guard:
                assert got["skipped"] == float(ref[f"{tag}/{i}/skipped"])
                if got["skipped"]:
                    assert math.isnan(got["loss"]) and math.isnan(want_loss)
                    _bitwise_trees(got["params"], rp, (case.name, i))
                    continue
            rel = abs(got["loss"] - want_loss) / abs(want_loss)
            seen[f"{case.name}/{i}/loss"] = rel
            if case.comp == "qsgd":
                level = 1.001 * gnorm / (LEVELS * n)
                if i == 0:
                    assert rel <= 1e-5, (case.name, i, rel)
                    mscale = {k: np.abs(v).max() for k, v in rm.items()}
                    seen[f"{case.name}/m0"] = _share_close(
                        got["m"], rm, mscale, 1e-4, level, (case.name, i))
                else:
                    # a step-0 flip moves p by lr L and m by L; step 1
                    # adds beta L and at most one flip of its own
                    assert rel <= 1e-4, (case.name, i, rel)
                    seen[f"{case.name}/params"] = _share_close(
                        got["params"], rp, change, 1e-4,
                        LR * (2 + 0.9) * level, (case.name, i))
            else:
                assert rel <= 1e-5, (case.name, i, rel)
                mscale = {k: np.abs(v).max() for k, v in rm.items()}
                seen[f"{case.name}/{i}"] = (
                    _leaf_close(got["params"], rp, change, 1e-4,
                                (case.name, i)),
                    _leaf_close(got["m"], rm, mscale, 1e-4, (case.name, i)))
    print(json.dumps(seen))


# ---- the train CLI ----------------------------------------------------------

_CLI_RUN = {}


def _cli_run(tmp_path_factory, capfd):
    """The train CLI's 4 steps on 2 gloo CPU ranks, checkpointing at steps
    2 and 4, once for the module -> (its checkpoint directory, the ranks'
    results, rank 0's printed lines)."""
    if not _CLI_RUN:
        from repro_torch.launch import train
        full = tmp_path_factory.mktemp("cli") / "full"
        res = train.run(CLI_RUN + ["--ckpt-dir", str(full)], collect=True)
        _CLI_RUN["run"] = (full, res, capfd.readouterr().out.splitlines())
    return _CLI_RUN["run"]


@pytest.mark.timeout(300)
def test_train_cli_prints_the_reference_lines(reference_run,
                                              tmp_path_factory, capfd):
    """`python -m repro_torch.launch.train` on 2 gloo CPU ranks prints the
    reference's header lines (arch / mesh / comp, plan[dp], wire[dp],
    schedule[dp]) as its main prints them on 2 virtual devices, then 4
    finite step losses, equal on both ranks."""
    _, results, out = _cli_run(tmp_path_factory, capfd)
    _, res = reference_run[1]()
    head = [ln for ln in out if ln.split(" ")[0].startswith(
        ("arch=", "plan[", "wire[", "schedule["))]
    assert head == res["cli"]
    steps = [ln for ln in out if ln.startswith("step ")]
    assert len(steps) == 4
    assert results[0]["losses"] == results[1]["losses"]
    assert len(results[0]["losses"]) == 4
    assert all(math.isfinite(v) for v in results[0]["losses"])
    # the CPU runs the plain versions, which count no launch; the
    # simulated strategy gathers each of the 5 buckets' decoded values
    assert set(results[0]["launches"].values()) == {0}
    assert results[0]["wire"]["calls"] == 5 * 4


@pytest.mark.timeout(300)
def test_uninterrupted_run_checkpoints(tmp_path_factory, capfd):
    """The CLI's run checkpoints at steps 2 and 4 (ckpt/checkpoint.py), and
    its step-4 file holds the run's final params and optimizer state
    bitwise."""
    from repro_torch.ckpt import host_state, load_checkpoint
    full, whole, _ = _cli_run(tmp_path_factory, capfd)
    files = sorted(p.name for p in full.iterdir())
    assert files == ["ckpt_00000002_s0.npz", "ckpt_00000004_s0.npz"]
    assert whole[0]["start"] == 0
    like = {k: torch.zeros(v.shape) for k, v in whole[0]["state"].items()}
    _, last = load_checkpoint(str(full / files[1]), _unflat(
        {f"s/{k}": v for k, v in like.items()}, "s"))
    for k, v in host_state(last).items():
        assert v.tobytes() == whole[0]["state"][k].tobytes(), k


@pytest.mark.timeout(300)
def test_kill_and_resume_is_bitwise(tmp_path, tmp_path_factory, capfd):
    """A fresh run_ranks given only the CLI run's step-2 file (a run killed
    after that save) resumes there (`--resume`), replays the data stream,
    and ends on the uninterrupted run's bits on both ranks."""
    import shutil
    from repro_torch.launch import train
    full, whole, _ = _cli_run(tmp_path_factory, capfd)
    killed = tmp_path / "killed"
    killed.mkdir()
    shutil.copy(full / "ckpt_00000002_s0.npz", killed)
    resumed = train.run(CLI_RUN + ["--ckpt-dir", str(killed), "--resume"],
                        collect=True)
    assert resumed[0]["start"] == 2
    assert resumed[0]["losses"] == whole[0]["losses"][2:]
    for r in range(2):
        a, b = whole[r]["state"], resumed[r]["state"]
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].tobytes() == b[k].tobytes(), (r, k)


def test_error_feedback_raises_the_reference_error(reference_run):
    """The engine threads no error-feedback state in either package: the
    step of a config with error_feedback raises the reference's
    ValueError (the port at build_train_step, the reference at its first
    step), and so does `train --error-feedback`."""
    from repro_torch.configs import get_smoke
    from repro_torch.launch import train
    from repro_torch.launch.engine import Engine
    from repro_torch.launch.mesh import make_host_mesh
    _, res = reference_run[1]()
    want = res["ef_error"]
    assert want == "error_feedback=True requires ef_state"
    comp = dataclasses.replace(_port_comp(CASE["qsgd_layerwise"]),
                               error_feedback=True)
    eng = Engine(get_smoke("llama3-405b"), make_host_mesh(data=2),
                 comp=comp, device="cpu")
    with pytest.raises(ValueError) as e:
        eng.build_train_step()
    assert str(e.value) == want
    with pytest.raises(ValueError) as e:
        train.run(CLI + ["--error-feedback", "--device", "cpu"])
    assert str(e.value) == want


# ---- comm_sched, memory, batch specs: the reference's numbers ---------------

def test_comm_sched_matches_reference(reference_run):
    """engine_schedule / schedule_report at fusion 0, 64 KiB and one
    message: the reference's summaries, message / dispatch / unit counts,
    bits and modeled timeline, exactly."""
    from repro_torch.configs import get_smoke
    from repro_torch.launch import comm_sched
    from repro_torch.launch.engine import Engine
    from repro_torch.launch.mesh import make_host_mesh
    _, res = reference_run[1]()
    comp = _port_comp(CASE["qsgd_layerwise"])
    eng = Engine(get_smoke("llama3-405b"), make_host_mesh(data=2),
                 comp=comp, device="cpu")
    for fb, want in zip(FUSIONS, res["schedules"]):
        s = comm_sched.engine_schedule(eng, fb)
        assert s.plan is eng.comm_plans()[0]
        got = json.loads(json.dumps(comm_sched.schedule_report(s, comp, 2)))
        assert got == want, fb
        assert comm_sched.resolve_schedule(s.plan, s) is s
        assert comm_sched.resolve_schedule(s.plan, None) is None
    other = comm_sched.engine_schedule(
        Engine(get_smoke("phi4-mini-3.8b"), make_host_mesh(data=2),
               comp=comp, device="cpu"), 0.0)
    with pytest.raises(ValueError, match="different UnitPlan"):
        comm_sched.resolve_schedule(eng.comm_plans()[0], other)


def test_memory_estimate_matches_reference(reference_run):
    from repro_torch.configs import get_config, get_smoke
    from repro_torch.launch.engine import Engine
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import InputShape
    from repro_torch.optim import OptConfig
    _, res = reference_run[1]()
    for (arch, smoke, n, kind, seq, batch), want in zip(MEMORY,
                                                        res["memory"]):
        cfg = get_smoke(arch) if smoke else get_config(arch)
        eng = Engine(cfg, make_host_mesh(data=n), device="cpu",
                     opt=OptConfig("momentum", lr=LR))
        got = eng.memory_estimate(InputShape(kind, seq, batch, kind))
        assert got == want, (arch, kind)


def test_batch_shapes_and_specs_match_reference(reference_run):
    from repro_torch.configs import get_smoke
    from repro_torch.launch.engine import Engine
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import InputShape
    _, res = reference_run[1]()
    for key, want in res["batch"].items():
        arch, kind, batch = key.split("/")
        eng = Engine(get_smoke(arch), make_host_mesh(data=2), device="cpu")
        shape = InputShape(kind, SEQ, int(batch), kind)
        specs = eng.batch_pspecs(shape)
        got = {k: [list(v.shape), str(v.dtype).replace("torch.", ""),
                   list(specs[k])]
               for k, v in eng.batch_shapes(shape).items()}
        assert got == want, key


# ---- the port's own contract ------------------------------------------------

def test_microbatch_rows_that_do_not_split_raise():
    """train_microbatch splits a rank's rows into equal microbatches, as the
    reference's reshape to (mb, rows // mb) does: rows it cannot split
    raise, where dropping the rest would train on fewer rows."""
    from repro_torch.configs import get_smoke
    from repro_torch.launch.engine import Engine
    from repro_torch.launch.mesh import make_host_mesh
    cfg = dataclasses.replace(get_smoke("llama3-405b"), train_microbatch=2)
    eng = Engine(cfg, make_host_mesh(data=1), device="cpu")
    params, state = eng.init_state(0)
    step = eng.build_train_step()
    g = torch.Generator().manual_seed(0)
    s = torch.randint(0, cfg.vocab, (3, SEQ + 1), generator=g)
    with pytest.raises(ValueError, match="do not split into 2"):
        step(params, state, {"tokens": s[:, :-1], "targets": s[:, 1:]}, 0)
    loss, _ = step.grads(params, {"tokens": s[:2, :-1],
                                  "targets": s[:2, 1:]}, 0)
    assert math.isfinite(float(loss))


def test_comm_plans_are_one_object_for_the_step_and_its_callers():
    from repro_torch.configs import get_smoke
    from repro_torch.launch.engine import Engine
    from repro_torch.launch.mesh import make_host_mesh
    comp = _port_comp(CASE["qsgd_layerwise"])
    eng = Engine(get_smoke("llama3-405b"), make_host_mesh(data=2),
                 comp=comp, device="cpu")
    rest, fsdp = eng.comm_plans()
    assert fsdp is None and rest is eng.comm_plans(comp)[0]
    step = eng.build_train_step(schedule=65536)
    assert step.schedule.plan is rest
    em = dataclasses.replace(comp, granularity=type(comp.granularity)(
        "entire_model"))
    assert eng.comm_plans(em)[0].num_units == 1
    assert eng.comm_plans(em)[0] is eng.comm_plans(em)[0]


def test_unported_paths_raise_with_their_queue_item(monkeypatch):
    """Nothing of the engine is left out now. The pod axis and the
    production mesh (item 9) build: a (pod, data, model) host mesh, the
    16 x 16 and 2 x 16 x 16 production meshes (shapes only without a
    process group) and an Engine on a pod mesh with the reference's dp
    axes ("pod", "data") and FSDP on "data" (they run in
    tests/test_torch_pod.py and the dry run's tests/test_torch_dryrun.py).
    The recorder and metrics (item 6) are ported:
    build_train_step(tracer=, metrics=) builds a step that carries the
    tracer, with the reference's build counter and static gauges from
    the engine's plan (engine.py:450-475), engine_controller threads both
    and counts its builds, and the CLI parses --trace-out / --metrics-out
    (tests/test_torch_obs.py runs them against the reference). A model
    axis and
    FSDP (item 4b) build: their meshes, engines and the CLI's --model
    engine are checked here, and they run in tests/test_torch_tp.py and
    test_torch_fsdp.py. Telemetry and the controller's flags (item 5) are
    ported: the engine builds its telemetry step and measurement plan,
    and the CLI takes --policy and its knobs (tests/test_torch_control.py
    runs them)."""
    from repro_torch.configs import get_smoke
    from repro_torch.launch import mesh as M
    from repro_torch.launch import train
    from repro_torch.launch.engine import Engine
    from repro_torch.models import InputShape
    assert M.axis_sizes(M.make_host_mesh(data=1, model=2)) == {
        "data": 1, "model": 2}
    pod = M.make_host_mesh(data=2, pod=2)
    assert M.axis_sizes(pod) == {"pod": 2, "data": 2, "model": 1}
    pe = Engine(dataclasses.replace(get_smoke("llama3-405b"), use_fsdp=True),
                pod, device="cpu")
    assert pe.dist.dp == ("pod", "data") and pe.dist.fsdp == "data"
    assert pe.dp_size == 4 and pe.memory_estimate(
        InputShape("train", 16, 8, "train"))["total"] > 0
    fs = Engine(dataclasses.replace(get_smoke("llama3-405b"), use_fsdp=True),
                M.make_host_mesh(data=2, model=2), device="cpu")
    assert fs.dist.fsdp == "data" and fs.dist.tp == "model" and fs.dist.sp
    mask = fs.model.fsdp_mask()
    assert mask["blocks"]["wq"] and not mask["final_norm_g"]
    assert M.axis_sizes(M.make_production_mesh()) == {"data": 16,
                                                      "model": 16}
    assert M.axis_sizes(M.make_production_mesh(multi_pod=True)) == {
        "pod": 2, "data": 16, "model": 16}
    eng = Engine(get_smoke("llama3-405b"), M.make_host_mesh(data=2),
                 device="cpu")
    step = eng.build_train_step(telemetry=True)
    assert step.telemetry and step.telemetry_entire_model
    step = eng.build_train_step(telemetry=True, telemetry_entire_model=False)
    assert step.telemetry and not step.telemetry_entire_model
    assert not eng.build_train_step(telemetry_entire_model=False).telemetry
    mplan = eng.measurement_plan()
    assert mplan is eng.measurement_plan()
    assert mplan.granularity.kind == "layerwise"
    assert mplan.unit_dims == eng.comm_plans()[0].unit_dims
    from repro_torch.control import StaticPolicy, engine_controller
    from repro_torch.control.telemetry import payload_bits_per_step
    from repro_torch.core import CompressionConfig, make_compressor
    from repro_torch.obs import MetricsRegistry, TraceRecorder
    rec, reg = TraceRecorder(), MetricsRegistry()
    comp = CompressionConfig(qw=make_compressor("qsgd", levels=16))
    assert eng.build_train_step(comp=comp, tracer=rec,
                                metrics=reg).tracer is rec
    plan = eng.comm_plans(comp)[0]
    assert reg.counters == {"engine/step_builds": 1.0}
    assert reg.gauges == {
        "engine/n_dispatches": plan.num_dispatches,
        "engine/n_units": plan.num_units,
        "engine/wire_bits_per_step": payload_bits_per_step(plan, comp.qw)}
    reg = MetricsRegistry()
    eng.build_train_step(comp=comp, schedule=0.0, metrics=reg)
    assert reg.gauges["engine/n_messages"] == plan.num_dispatches
    assert reg.gauges["engine/fusion_bytes"] == 0.0
    reg = MetricsRegistry()
    ctrl = engine_controller(eng, StaticPolicy(), metrics=reg, tracer=rec)
    assert ctrl.step_fn().tracer is rec
    assert reg.counters == {"controller/builds": 1.0,
                            "engine/step_builds": 1.0}
    base = ["--arch", "llama3-405b", "--smoke", "--device", "cpu"]
    args = train._parse(base + ["--trace-out", "t.json", "--metrics-out",
                                "m.jsonl"])
    assert (args.trace_out, args.metrics_out) == ("t.json", "m.jsonl")
    tp = train._engine(train._parse(base + ["--model", "2", "--data", "2"]),
                       "cpu")
    assert tp.sizes == {"data": 2, "model": 2} and tp.tp_size == 2
    # the controller's flags parse into a controller over the engine
    for extra, policy, knob in (
            (["--telemetry-out", "t.json"], "static", None),
            (["--policy", "variance_budget", "--variance-budget", "0.2",
              "--replan-every", "5"], "variance_budget", ("budget", 0.2)),
            (["--policy", "bit_budget", "--bit-budget", "1024"],
             "bit_budget", ("bits_per_step", 1024)),
            (["--policy", "fusion", "--alpha-us", "3"], "fusion",
             ("alpha_us", 3.0))):
        args = train._parse(base + extra)
        ctrl = train.build_controller(args, train._engine(args, "cpu"),
                                      None)
        assert args.policy == ctrl.policy.name == policy
        assert ctrl.replan_every == args.replan_every
        assert ctrl.collect == (policy != "static" or bool(
            args.telemetry_out))
        if knob:
            assert getattr(ctrl.policy, knob[0]) == knob[1]
    for extra in (["--wire"], ["--step-guard"]):
        with pytest.raises(SystemExit):
            train._parse(base + ["--policy", "static"] + extra)
    assert M.axis_sizes(M.make_host_mesh(data=4)) == {"data": 4, "model": 1}
    with pytest.raises(ValueError, match="differ in length"):
        M.make_mesh((2, 1), ("data",))
    with pytest.raises(ValueError, match="collective"):
        eng.build_train_step(collective="ring")
    # nccl with fewer cards than ranks names the gloo backend
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="--backend gloo"):
        M.run_ranks(rank_cases, 2, backend="nccl", device="cuda")


def test_train_cli_refuses_cuda_without_a_card():
    from repro_torch.launch import train
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.run(["--arch", "llama3-405b", "--smoke", "--data", "2"])


def test_full_width_memory_savers_are_bitwise(monkeypatch):
    """What lets two full-width ranks share the card keeps the bits: the
    decode writes its f32 values over its own int32 codes a slice at a
    time (wire._dequantize), and the worker mean divides its fresh sum in
    place (aggregation.worker_mean)."""
    from repro_torch.core import aggregation, wire
    rng = np.random.default_rng(9)
    codes = torch.from_numpy(rng.integers(0, 33, (5, 1001)).astype(np.int32))
    scale = torch.from_numpy(rng.random(5).astype(np.float32))
    want = (codes - 16).to(torch.float32) * scale[:, None]
    monkeypatch.setattr(wire, "DEQUANT_SPAN", 64)
    got = wire._dequantize([codes.clone()], 16, [scale])[0]
    assert got.numpy().tobytes() == want.numpy().tobytes()
    g = torch.from_numpy(rng.standard_normal((3, 7, 5)).astype(np.float32))
    mean = aggregation.worker_mean(g)
    assert mean.numpy().tobytes() == ((g[0] + g[1] + g[2]) / 3).numpy() \
        .tobytes()
    one = g[:1].clone()
    assert torch.equal(aggregation.worker_mean(one), one[0])
    assert torch.equal(one, g[:1])           # the input is left alone
