"""The dry run (launch/dryrun.py), its cost model (launch/hlo_cost.py) and
the roofline (launch/analysis.py) against the JAX package's, on the CPU.

The module's first test starts the reference in a subprocess with 4
virtual CPU devices (the jax-0.9 shim, threefry_partitionable(False),
one XLA thread). It never imports the reference's dryrun module, which
sets XLA_FLAGS when imported: it lowers and compiles on its own, as the
reference's dry run does, and writes one section a case as it goes (the
HLO text, the reference's parse_hlo / scan_scaled_costs of it, and for an
Engine step analyze_compiled's Roofline, memory_estimate and
model_flops): the two scans of tests/test_analysis.py, a shard_map psum
on 4 devices, and the smoke Engine steps on a (data 2, model 2) mesh
with the dry run's default compression (top-k(1%) layerwise, simulated):
llama3 train, prefill and decode, qwen3-moe (MoE) train and mamba2
(SSM) train. The port-only tests run first while it works; each
reference test waits for its own section.

Held:
  - the port's parse_hlo and scan_scaled_costs bitwise the reference's on
    every text;
  - StepCost exact on the toy scans written as Python loops on meta
    tensors, and the same on a real CPU step as on the dry run's meta one;
  - on the smoke steps, model_flops_global and Engine.memory_estimate
    exactly the reference's; the per-device dot FLOPs and collective
    bytes of each kind stated as ratios, their differences exactly the
    attributed ones (ROADMAP Queue 3 item 23): XLA merges the forward's
    loss-chunk head matmul into the checkpointed chunk's recomputation in
    llama3's and qwen3-moe's train step (not in mamba2's) and CSEs the
    rematerialized flash forward's score dot q·kᵀ with the flash
    backward's, where the port runs both (2·T·d·V_local and, a layer,
    2·B·H·S²·d_head more); jax's remat drops the checkpointed loss
    chunk's recomputed pmax (a stabilizer without gradient) as dead code,
    the port recomputes it (one (T,) f32 all-reduce more);
  - the kernels' meta path: shapes and dtypes of the plain versions, no
    launch, each launch's buffers' bytes handed to the counter;
  - a production-mesh row written by dryrun.main with the reference's
    Roofline keys.
"""
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF_TIMEOUT = 600.0
# the smoke Engine steps: name -> (arch, kind, seq, global batch)
STEPS = {"llama3-405b_train": ("llama3-405b", "train", 32, 8),
         "llama3-405b_prefill": ("llama3-405b", "prefill", 32, 4),
         "llama3-405b_decode": ("llama3-405b", "decode", 32, 4),
         "qwen3-moe-235b-a22b_train": ("qwen3-moe-235b-a22b", "train", 32,
                                       8),
         "mamba2-1.3b_train": ("mamba2-1.3b", "train", 32, 8)}
MESH = (2, 2)
TEXTS = ("scan", "nested_scan", "psum") + tuple(STEPS)


def _parsed(comps, trip, entry) -> dict:
    return {"comps": {n: [c.flops, c.bytes, c.coll,
                          [list(ch) for ch in c.children]]
                      for n, c in comps.items()},
            "trip": trip, "entry": entry}


# ---- the reference (subprocess) -----------------------------------------------

def reference_main(out_dir: str) -> None:
    import dataclasses
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from test_torch_ref import reference
    out = pathlib.Path(out_dir)
    mods = ("repro.launch.engine", "repro.launch.analysis",
            "repro.launch.hlo_cost", "repro.configs.registry",
            "repro.optim", "repro.models.config")
    with reference(*mods) as ref:
        E = sys.modules["repro.launch.engine"]
        A = sys.modules["repro.launch.analysis"]
        H = sys.modules["repro.launch.hlo_cost"]
        IS = sys.modules["repro.models.config"].InputShape

        def write(name, text, group, **more):
            (out / f"{name}.hlo.txt").write_text(text)
            rec = {"scan": H.scan_scaled_costs(text, group),
                   "parse": _parsed(*H.parse_hlo(text, group)),
                   "collective_bytes": A.collective_bytes(text), **more}
            (out / f"{name}.tmp").write_text(json.dumps(rec))
            os.replace(out / f"{name}.tmp", out / f"{name}.json")

        def scan(x, w):
            def body(c, wl):
                return jnp.tanh(c @ wl), None
            return jax.lax.scan(body, x, w)[0]

        def nested(x, w):
            def outer(c, wl):
                def inner(c2, _):
                    return jnp.tanh(c2 @ wl), None
                return jax.lax.scan(inner, c, jnp.arange(3))[0], None
            return jax.lax.scan(outer, x, w)[0]

        sds = jax.ShapeDtypeStruct
        for name, f, x, w in (
                ("scan", scan, (128, 128), (8, 128, 128)),
                ("nested_scan", nested, (64, 64), (5, 64, 64))):
            c = jax.jit(f).lower(sds(x, jnp.float32),
                                 sds(w, jnp.float32)).compile()
            write(name, c.as_text(), 1)
        from jax import shard_map
        mesh4 = jax.sharding.Mesh(np.array(jax.devices()[:4]), ("data",))
        c = jax.jit(shard_map(lambda x: jax.lax.psum(x, "data"),
                              mesh=mesh4, in_specs=(P("data"),),
                              out_specs=P(None), check_vma=False)).lower(
            sds((32,), jnp.float32)).compile()
        write("psum", c.as_text(), 4)

        mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(MESH),
                                 ("data", "model"))
        comp = ref.core.CompressionConfig(
            qw=ref.core.make_compressor("topk", ratio=0.01),
            qm=ref.core.make_compressor("identity"),
            granularity=ref.core.Granularity("layerwise", 65536),
            strategy="simulated")
        opt = ref.optim.OptConfig(name="sgd")
        for name, (arch, kind, seq, batch) in STEPS.items():
            shape = IS(kind, seq, batch, kind)
            cfg = ref.registry.get_smoke(arch)
            eng = E.Engine(cfg, mesh, comp=comp, opt=opt, remat=True)
            with (jax.sharding.use_mesh(mesh)
                  if hasattr(jax.sharding, "use_mesh") else mesh):
                if kind == "train":
                    lowered = eng.build_train_step().lower(
                        *eng.train_input_specs(shape)[0])
                else:
                    params = eng._sharded_sds(eng.model.param_shapes(),
                                              eng.model.param_pspecs())
                    args, _ = eng.input_specs(shape)
                    fn = (eng.build_prefill(shape) if kind == "prefill"
                          else eng.build_serve_step(shape))
                    lowered = fn.lower(params, *args)
                compiled = lowered.compile()
            roof = A.analyze_compiled(compiled, arch=arch, shape=shape,
                                      mesh_name="2x2", chips=4, cfg=cfg)
            est = {k: (bool(v) if isinstance(v, bool) else float(v))
                   for k, v in eng.memory_estimate(shape).items()}
            write(name, compiled.as_text(), 4, roof=roof.to_dict(),
                  est=est, model_flops=A.model_flops(cfg, shape),
                  fields=[f.name for f in dataclasses.fields(A.Roofline)])


class _Ref:
    def __init__(self, out, proc):
        self.out, self.proc = out, proc

    def section(self, name):
        path = self.out / f"{name}.json"
        deadline = time.monotonic() + REF_TIMEOUT
        while not path.exists():
            if self.proc.poll() not in (None, 0):
                log, _ = self.proc.communicate()
                raise AssertionError(log[-4000:])
            assert time.monotonic() < deadline, f"no {path}"
            time.sleep(0.05)
        return (json.loads(path.read_text()),
                (self.out / f"{name}.hlo.txt").read_text())


@pytest.fixture(scope="module", autouse=True)
def ref_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4 "
                         "--xla_cpu_multi_thread_eigen=false "
                         "intra_op_parallelism_threads=1",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           str(ROOT / "tests")]))
    proc = subprocess.Popen(
        [sys.executable, "-c", "import sys, test_torch_dryrun as t; "
         "t.reference_main(sys.argv[1])", str(out)], env=env,
        cwd=str(ROOT / "tests"), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    yield _Ref(out, proc)
    if proc.poll() is None:
        proc.kill()
    if not proc.stdout.closed:
        proc.communicate()


# ---- port-only: the parser's unit cases (tests/test_analysis.py) -------------

def test_shape_bytes_parsing():
    from repro_torch.launch.hlo_cost import _shape_bytes
    assert _shape_bytes("f32[16,4]{1,0}") == 256
    assert _shape_bytes("bf16[8]") == 16
    assert _shape_bytes("(s32[], f32[2,2]{1,0}, pred[3])") == 4 + 16 + 3
    assert _shape_bytes("s8[100]") == 100


def test_wire_model():
    from repro_torch.launch.hlo_cost import _wire_bytes
    assert _wire_bytes("all-reduce", 1000, 2) == 1000.0
    assert _wire_bytes("all-gather", 1600, 16) == 1600 * 15 / 16
    assert _wire_bytes("reduce-scatter", 100, 4) == 300.0
    assert _wire_bytes("all-reduce", 1000, 1) == 0.0


def test_model_flops_formulas():
    from repro_torch.configs import get_config
    from repro_torch.launch.analysis import model_flops
    from repro_torch.models.config import INPUT_SHAPES
    cfg = get_config("mamba2-1.3b")
    n = cfg.active_param_count()
    assert model_flops(cfg, INPUT_SHAPES["train_4k"]) == 6.0 * n * 256 * 4096
    assert model_flops(cfg, INPUT_SHAPES["decode_32k"]) == 2.0 * n * 128


def test_moe_active_params_much_smaller():
    from repro_torch.configs import get_config
    cfg = get_config("qwen3-moe-235b-a22b")
    assert cfg.param_count() > 2e11
    assert cfg.active_param_count() < 0.3e11
    l4 = get_config("llama4-maverick-400b-a17b")
    assert 3.5e11 < l4.param_count() < 4.5e11
    assert l4.active_param_count() < 0.25e11


def test_roofline_bottleneck_classification():
    """The reference's case at the H100's rates: 1 s of compute, 3 s of
    memory, 2 s of collectives."""
    from repro_torch.launch import analysis as A
    assert (A.PEAK_FLOPS, A.HBM_BW, A.ICI_BW) == (989e12, 3.35e12, 450e9)
    r = A.Roofline(arch="a", shape="s", mesh="m", chips=256,
                   hlo_flops_per_device=A.PEAK_FLOPS,
                   hlo_bytes_per_device=A.HBM_BW * 3,
                   collective_bytes_per_device=A.ICI_BW * 2,
                   collective_breakdown={},
                   model_flops_global=A.PEAK_FLOPS * 256,
                   memory_per_device={})
    assert r.bottleneck == "memory"
    assert r.t_compute == pytest.approx(1.0)
    assert r.t_collective == pytest.approx(2.0)
    assert r.useful_flops_ratio == pytest.approx(1.0)


# ---- port-only: the counter ---------------------------------------------------

def _meta(*shape):
    return torch.empty(shape, device="meta")


def test_counter_exact_on_toy_loops():
    """tests/test_analysis.py's scans as Python loops on meta tensors:
    exactly 8·2·128³ and 5·3·2·64³ FLOPs (nothing is scaled: the loops run
    unrolled)."""
    from repro_torch.launch.hlo_cost import StepCost

    def scan(x, w):
        for wl in w:
            x = torch.tanh(x @ wl)
        return x

    def nested(x, w):
        for wl in w:
            for _ in range(3):
                x = torch.tanh(x @ wl)
        return x
    for f, x, w, want in ((scan, (128, 128), (8, 128, 128),
                           8 * 2 * 128 ** 3),
                          (nested, (64, 64), (5, 64, 64),
                           5 * 3 * 2 * 64 ** 3)):
        cost = StepCost()
        with cost:
            out = f(_meta(*x), _meta(*w))
        assert out.is_meta and cost.flops == want
        assert cost.ops["aten.mm"] == want // (2 * x[0] ** 3)
        assert cost.collectives == {k: 0.0 for k in cost.collectives}


def test_counter_counts_every_dot_and_convolution():
    """2·M·N·K for mm / bmm / addmm / baddbmm / mv / dot, a convolution's
    output entries times the input features a filter sees, each gradient
    of its backward the same again; views count no bytes."""
    from repro_torch.launch.hlo_cost import StepCost
    a, b, c = _meta(3, 4), _meta(4, 5), _meta(3, 5)
    ba, bb = _meta(2, 3, 4), _meta(2, 4, 5)
    cost = StepCost()
    with cost:
        torch.mm(a, b)
        torch.addmm(c, a, b)
        torch.bmm(ba, bb)
        torch.baddbmm(_meta(2, 3, 5), ba, bb)
        torch.mv(a, _meta(4))
        torch.dot(_meta(7), _meta(7))
        a.t()
    assert cost.flops == 2 * (60 + 60 + 120 + 120 + 12 + 7)
    x = torch.zeros(2, 3, 8, 8, requires_grad=True)
    w = torch.zeros(4, 3, 3, 3, requires_grad=True)
    cost = StepCost()
    cost.arguments(x, w)                 # a step on the CPU
    with cost:
        y = torch.nn.functional.conv2d(x, w, padding=1)
        y.sum().backward()
    fwd = 2 * y.numel() * 3 * 3 * 3
    assert cost.flops == 3 * fwd


def _smoke_engine(arch, mesh_shape, device, comp=None):
    from repro_torch.configs import get_smoke
    from repro_torch.launch import dryrun
    from repro_torch.launch.engine import Engine
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import OptConfig
    comp = comp or dryrun.build_compression(dryrun.parser().parse_args([]))
    return Engine(get_smoke(arch), make_mesh(mesh_shape, ("data", "model")),
                  comp=comp, opt=OptConfig(name="sgd"), device=device)


def test_counter_on_a_cpu_step_equals_the_dry_run():
    """llama3 smoke's train step on (1, 1): the dry run's counts on meta
    tensors and the same counter over the real step on the CPU (a
    one-rank gloo group; the step's device is its arguments') give the
    same FLOPs, and the traced peaks agree within 1%."""
    import torch.distributed as dist
    from repro_torch import random as R
    from repro_torch.launch import dryrun
    from repro_torch.launch.hlo_cost import StepCost
    from repro_torch.models import InputShape
    from repro_torch.optim import init_opt_state
    shape = InputShape("train", 32, 4, "train")
    with dryrun.fake_group(1):
        eng = _smoke_engine("llama3-405b", (1, 1), "meta")
        dry = dryrun.count_step(*dryrun.step_inputs(eng, shape))
    dist.init_process_group("gloo", store=dist.HashStore(), world_size=1,
                            rank=0)
    try:
        eng = _smoke_engine("llama3-405b", (1, 1), "cpu")
        params = eng.model.init(R.key(0), device="cpu")
        state = init_opt_state(eng.opt, params)
        rng = np.random.default_rng(0)
        s = torch.from_numpy(rng.integers(0, 512, (4, 33), dtype=np.int32))
        batch = {"tokens": s[:, :-1].contiguous(),
                 "targets": s[:, 1:].contiguous()}
        real = StepCost()
        real.arguments(params, state, batch, 0)
        with real:
            out = eng.build_train_step()(params, state, batch, 0)
        real.outputs(out)
    finally:
        dist.destroy_process_group()
    assert real.flops == dry.flops > 0
    assert np.isfinite(float(out[2]["loss"]))
    peak = {c: c.argument_bytes + c.peak for c in (dry, real)}
    assert abs(peak[real] - peak[dry]) <= 0.01 * peak[dry], peak.values()


def _kernel_cases():
    """(wrapper, call(tensors on a device) -> outputs, CPU inputs)."""
    from repro_torch.kernels import pack as P
    from repro_torch.kernels import qsgd as Q
    import importlib
    # the package's own `rmsnorm` (kernels/ops.py) shadows the module
    RN = importlib.import_module("repro_torch.kernels.rmsnorm")
    from repro_torch.kernels import sign as S
    from repro_torch.kernels import terngrad as T
    from repro_torch.kernels import topk_mask as K
    from repro_torch.kernels.ref import words_per_unit
    rng = np.random.default_rng(3)
    n, d, w = 3, 70, 6

    def f32(*s):
        return torch.from_numpy(rng.standard_normal(s).astype(np.float32))

    def i32(hi, *s):
        return torch.from_numpy(rng.integers(0, hi, s).astype(np.int32))
    x, k0, k1 = f32(n, d), i32(2**31, n), i32(2**31, n)
    nrm = torch.linalg.vector_norm(x, dim=1) + 1e-12
    return (
        (Q.qsgd_pack, lambda t: Q.qsgd_pack_buckets(
            [t[0]], [t[1]], [t[2]], [t[3]], 16, w), (x, k0, k1, nrm)),
        (Q.qsgd_unpack, lambda t: Q.qsgd_unpack_buckets(
            [t[0]], [t[1]], [d], 16, w),
         (i32(2**31, n, words_per_unit(d, w)), nrm / 16)),
        (Q.qsgd_compress_rows, lambda t: Q.qsgd_compress_buckets(
            [t[0]], [t[1]], [t[2]], [t[3]], [2 * d], 16), (x, k0, k1, nrm)),
        (T.terngrad_pack, lambda t: T.terngrad_pack_buckets(
            [t[0]], [t[1]], [t[2]], [t[3]]), (x, k0, k1, nrm)),
        (T.terngrad_unpack, lambda t: T.terngrad_unpack_buckets(
            [t[0]], [t[1]], [d]), (i32(2**31, n, words_per_unit(d, 2)),
                                   nrm)),
        (T.terngrad_compress_rows, lambda t: T.terngrad_compress_buckets(
            [t[0]], [t[1]], [t[2]], [t[3]], [2 * d]), (x, k0, k1, nrm)),
        (S.sign_pack, lambda t: S.sign_pack_buckets([t[0]]), (x,)),
        (S.sign_unpack, lambda t: S.sign_unpack_buckets([t[0]], [d]),
         (i32(2**31, n, words_per_unit(d, 1)),)),
        (S.majority, lambda t: S.majority_buckets([t[0]]),
         (i32(2**31, 5, 9),)),
        (P.fields_pack, lambda t: P.fields_pack_buckets([t[0]], [9]),
         (i32(512, n, d),)),
        (P.fields_unpack, lambda t: P.fields_unpack_buckets(
            [t[0]], [d], [9]), (i32(2**31, n, words_per_unit(d, 9)),)),
        (P.bits_pack, lambda t: P.bits_pack_buckets([t[0]]),
         (i32(2, n, d),)),
        (P.bits_unpack, lambda t: P.bits_unpack_buckets([t[0]], [d]),
         (i32(2**31, n, words_per_unit(d, 1)),)),
        (K.topk_mask, lambda t: [K.topk_mask_flat(t[0], 5)], (f32(1000),)),
        (RN.rmsnorm, lambda t: [RN.rmsnorm(t[0], t[1])],
         (f32(4, 256), f32(256))),
    )


@pytest.mark.parametrize("case", range(15))
def test_kernels_meta_path_is_a_shape_function(case):
    """Every wrapper (PERF.md §6's rows 1-17) on meta tensors: the plain
    versions' output shapes and dtypes, no launch (`launches` unchanged),
    and one kernel call handed to the counter with the bytes of every
    buffer it reads or writes, each once."""
    from repro_torch.launch.hlo_cost import StepCost
    wrapper, call, cpu = _kernel_cases()[case]
    want = call(cpu)
    meta = tuple(t.to("meta") for t in cpu)
    before = wrapper.launches
    cost = StepCost()
    with cost:
        got = call(meta)
    assert wrapper.launches == before
    assert [(g.device.type, g.shape, g.dtype) for g in got] == \
        [("meta", w.shape, w.dtype) for w in want]
    nbytes = sum(t.numel() * t.element_size() for t in meta + tuple(got))
    assert dict(cost.kernels) == {wrapper.__name__: 1}
    assert dict(cost.kernel_bytes) == {wrapper.__name__: nbytes}
    assert cost.bytes >= nbytes


# ---- port-only: the dry run's CLI ---------------------------------------------

def test_port_collective_bytes_beside_the_reference_ops():
    """On 4 fake ranks, the port's all_reduce of an f32[8] is one
    all-reduce of the reference (a ring's 2 (g - 1) / g x 32 B = 48 B) and
    an all_gather that receives (g - 1) x 32 B = 96 B in port_collectives;
    a metric gather is the reference's all-reduce and no port bytes."""
    from repro_torch.core import collectives as C
    from repro_torch.launch import dryrun
    from repro_torch.launch.hlo_cost import StepCost
    with dryrun.fake_group(4):
        x = _meta(8)
        cost = StepCost()
        cost.arguments(x)
        with cost:
            C.all_reduce(x)
            C.gather_metrics(x[0])
    assert cost.collectives["all-reduce"] == 48 + 6
    assert cost.port_collectives == {"all_gather": 96, "reduce_scatter": 0,
                                     "ring_shift": 0}


def test_dryrun_writes_a_row_with_the_reference_keys(tmp_path, ref_run,
                                                     monkeypatch):
    """dryrun.main on one production-mesh row with --device cpu writes
    {tag}.json with the reference Roofline's fields and derived keys (the
    summary's row adds the reference's status keys and the card), the
    memory estimate's two keys and the data sheet's card; a pair
    config_for_shape skips prints [skip]; --device cuda without a card
    fails; a process holding a process group is refused."""
    import torch.distributed as dist
    from repro_torch.launch import dryrun
    out = tmp_path / "dry"
    argv = ["--device", "cpu", "--arch", "mamba2-1.3b", "--shape",
            "decode_32k", "--mesh", "both", "--out", str(out)]
    assert dryrun.main(argv) == 0
    rows = json.loads((out / "summary.json").read_text())
    assert [(r["mesh"], r["status"]) for r in rows] == [
        ("16x16", "ok"), ("2x16x16", "ok")]
    row = json.loads(
        (out / "mamba2-1.3b__decode_32k__16x16.json").read_text())
    assert row["chips"] == 256 and rows[1]["chips"] == 512
    mem = row["memory_per_device"]
    assert {"tpu_estimate_total", "tpu_estimate_fits_16g",
            "argument_size_in_bytes", "temp_size_in_bytes",
            "output_size_in_bytes", "card_total_bytes",
            "fits_card"} <= set(mem)
    assert mem["card_total_bytes"] == 80e9 and rows[0]["card_source"] \
        .startswith("data sheet")
    assert row["hlo_bytes_per_device"] > 0
    skip = dryrun.run_one("whisper-base", "long_500k", False, None, None,
                          str(out), device="cpu")
    assert skip["status"] == "skipped"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch sees none"):
        dryrun.main(["--arch", "mamba2-1.3b", "--shape", "decode_32k"])
    dist.init_process_group("gloo", store=dist.HashStore(), world_size=1,
                            rank=0)
    try:
        with pytest.raises(RuntimeError, match="already has one"):
            dryrun.run_one("mamba2-1.3b", "decode_32k", False, None, None,
                           str(out), device="cpu")
        assert dryrun.main(argv) == 1         # printed [FAIL], counted
    finally:
        dist.destroy_process_group()
    ref, _ = ref_run.section("llama3-405b_train")
    derived = {"t_compute", "t_memory", "t_collective", "bottleneck",
               "useful_flops_ratio"}
    assert set(ref["roof"]) == set(ref["fields"]) | derived
    assert set(row) == set(ref["roof"])
    assert set(rows[0]) == set(ref["roof"]) | {
        "status", "note", "lower_s", "compile_s", "card", "card_source",
        "port_collective_bytes_per_device", "port_collective_breakdown",
        "port_t_collective", "port_bottleneck"}
    # the port's all_gather-based all-reduce receives more than the ring's
    assert rows[0]["port_collective_bytes_per_device"] > \
        rows[0]["collective_bytes_per_device"] > 0


# ---- against the reference ----------------------------------------------------

@pytest.mark.parametrize("name", TEXTS)
def test_parser_bitwise_on_reference_hlo(ref_run, name):
    """parse_hlo, scan_scaled_costs and collective_bytes of the port on the
    reference's HLO texts: bitwise the reference's (the scans' flops are
    8·2·128³ and 5·3·2·64³; the psum is one all-reduce of each device's f32[8] on 4 devices)."""
    from repro_torch.launch import analysis as A
    from repro_torch.launch import hlo_cost as H
    ref, text = ref_run.section(name)
    group = 1 if "scan" in name else 4
    got = json.loads(json.dumps({
        "scan": H.scan_scaled_costs(text, group),
        "parse": _parsed(*H.parse_hlo(text, group)),
        "collective_bytes": A.collective_bytes(text)}))
    for k in ("scan", "parse", "collective_bytes"):
        assert got[k] == ref[k], (name, k)
    if name == "scan":
        assert got["scan"]["flops"] == 8 * 2 * 128 ** 3
    if name == "nested_scan":
        assert got["scan"]["flops"] == 5 * 3 * 2 * 64 ** 3
    if name == "psum":
        assert got["scan"]["collectives"]["all-reduce"] == \
            H._wire_bytes("all-reduce", 32, 4) > 0   # f32[8] a device


def _attributed(eng, kind, seq, batch):
    """The port's counts minus the reference's on a smoke step, as
    attributed: (dot FLOPs, all-reduce wire bytes) a device."""
    if kind != "train":
        return 0.0, 0.0
    cfg, tp = eng.cfg, eng.tp_size
    rows = batch // eng.dp_size
    tokens = rows * seq                       # one loss chunk (< 8192)
    v_local = eng.model.vocab_padded // tp
    pmax = 4.0 * tokens * 2 * (tp - 1) / tp   # _wire_bytes' all-reduce
    if cfg.arch_type == "ssm":
        return 0.0, pmax
    heads = cfg.n_heads // tp
    score = cfg.n_layers * 2.0 * rows * heads * seq * seq * cfg.d_head
    head = 2.0 * tokens * cfg.d_model * v_local
    return score + head, pmax


@pytest.mark.parametrize("name", tuple(STEPS))
def test_smoke_steps_against_reference(ref_run, name):
    """The port's dry run of a smoke Engine step on (data 2, model 2)
    against the reference's compiled step: model_flops_global and the
    memory estimate exactly; dot FLOPs and each collective kind's bytes
    as ratios, their differences exactly the attributed ones (module
    docstring); the HBM bytes (eager, unfused) printed beside."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.analysis import analyze_step
    from repro_torch.models import InputShape
    arch, kind, seq, batch = STEPS[name]
    shape = InputShape(kind, seq, batch, kind)
    with dryrun.fake_group(4):
        eng = _smoke_engine(arch, MESH, "meta")
        cost = dryrun.count_step(*dryrun.step_inputs(eng, shape))
    port = analyze_step(cost, arch=arch, shape=shape, mesh_name="2x2",
                        chips=4, cfg=eng.cfg).to_dict()
    ref, _ = ref_run.section(name)
    roof = ref["roof"]
    assert port["model_flops_global"] == roof["model_flops_global"] == \
        ref["model_flops"]
    est = {k: (bool(v) if isinstance(v, bool) else float(v))
           for k, v in eng.memory_estimate(shape).items()}
    assert est == ref["est"]
    flops, allreduce = _attributed(eng, kind, seq, batch)
    assert port["hlo_flops_per_device"] - roof["hlo_flops_per_device"] \
        == flops
    for k, v in roof["collective_breakdown"].items():
        extra = allreduce if k == "all-reduce" else 0.0
        assert port["collective_breakdown"][k] - v == extra, k
    ratio = {"flops": port["hlo_flops_per_device"]
             / roof["hlo_flops_per_device"],
             "hbm_bytes": port["hlo_bytes_per_device"]
             / roof["hlo_bytes_per_device"]}
    for k, v in roof["collective_breakdown"].items():
        if v:
            ratio[k] = port["collective_breakdown"][k] / v
    print(name, json.dumps(ratio))
