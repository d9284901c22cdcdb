"""The rest of Algorithm 1's single-process surface against the reference:
the package exports of `repro_torch.core`, the schedule's alpha-beta cost
model, the plan, bits, compressor and wire helpers, and
aggregate_simulated_workers' plan= / schedule= / alive= (the survivor mean
bitwise: XLA's CPU dot over the worker axis is a worker-order fma chain,
which the port computes with kernels/ref.fma_f32).
"""
import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_aggregation import (N_WORKERS, _bitwise, _configs,
                                    _flat_mean, _flatten, _norm_exact_flat,
                                    _normal_flat, _port_plan, _unflatten)
from test_torch_ref import jkey, reference
from test_torch_wire import (FUSIONS, RESNET9_SHAPES, _grads, _to_jax,
                             _to_torch)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _exported(path: pathlib.Path):
    """Names a package __init__ imports from its modules."""
    tree = ast.parse(path.read_text())
    return {a.asname or a.name for node in tree.body
            if isinstance(node, ast.ImportFrom) for a in node.names}


@pytest.mark.parametrize("pkg", ["core", "optim"])
def test_package_exports_match_reference(pkg):
    import importlib
    want = _exported(ROOT / "src" / "repro" / pkg / "__init__.py")
    got = _exported(ROOT / "src" / "repro_torch" / pkg / "__init__.py")
    assert got == want
    mod = importlib.import_module(f"repro_torch.{pkg}")
    assert all(hasattr(mod, name) for name in want)


def _schedules(fusion):
    """(port, reference) schedules of resnet9's layerwise plan."""
    from repro_torch.core import build_plan, build_schedule, stacked_mask
    from repro_torch.core import Granularity
    tg = _to_torch(_grads(RESNET9_SHAPES, seed=0, dyadic=False))
    sched = build_schedule(build_plan(tg, stacked_mask(tg),
                                      Granularity("layerwise")), fusion)
    with reference() as ref:
        jg = _to_jax(_grads(RESNET9_SHAPES, seed=0, dyadic=False))
        jsched = ref.core.build_schedule(ref.core.build_plan(
            jg, ref.core.stacked_mask(jg), ref.core.Granularity("layerwise")),
            fusion)
    return sched, jsched


@pytest.mark.parametrize("fusion", list(FUSIONS), ids=list(FUSIONS))
def test_simulate_schedule_matches_reference(fusion):
    """simulate_schedule and message_wire_bits: the reference's dicts key
    for key, rounded floats included, dense, analytic (QSGD(16), top-k)
    and measured per-bucket bits; the summary line and message counts."""
    from repro_torch.core import (FUSE_ALL, make_compressor,
                                  message_wire_bits, simulate_schedule,
                                  wire_codec)
    sched, jsched = _schedules(FUSIONS[fusion])
    assert (FUSIONS[fusion] == FUSE_ALL) == (fusion == "one_shot")
    with reference() as ref:
        from repro.core.schedule import message_wire_bits as jbits
        from repro.core.schedule import simulate_schedule as jsim
        assert sched.summary() == jsched.summary()
        assert [m.n_buckets for m in sched.messages] == \
            [m.n_buckets for m in jsched.messages]
        for comp in (None, "qsgd", "topk"):
            kw = {"levels": 16} if comp == "qsgd" else {}
            qw = make_compressor(comp, **kw) if comp else None
            jqw = ref.core.make_compressor(comp, **kw) if comp else None
            assert message_wire_bits(sched, qw) == jbits(jsched, jqw)
            assert simulate_schedule(sched, qw=qw) == jsim(jsched, qw=jqw)
            assert simulate_schedule(sched, qw=qw, alpha_us=5.0, gbps=100.0,
                                     backward_us=300.0) == jsim(
                jsched, qw=jqw, alpha_us=5.0, gbps=100.0, backward_us=300.0)
        bb = [b.n * wire_codec(make_compressor("natural")).wire_bits(b.dim)
              for b in sched.plan.buckets]
        assert simulate_schedule(sched, bucket_bits=bb) == jsim(
            jsched, bucket_bits=bb)
        with pytest.raises(ValueError, match="bucket_bits has"):
            message_wire_bits(sched, bucket_bits=bb[:-1])


@pytest.mark.parametrize("gran", [("layerwise", 0), ("entire_model", 0),
                                  ("blockwise", 1000)])
def test_plan_helpers_match_reference(gran):
    from repro_torch.core import Granularity, build_plan, plan_unit_dims, \
        stacked_mask
    kind, bs = gran
    tg = _to_torch(_grads(RESNET9_SHAPES, seed=0, dyadic=False))
    g = Granularity(kind, bs) if bs else Granularity(kind)
    plan = build_plan(tg, stacked_mask(tg), g)
    with reference() as ref:
        jg = _to_jax(_grads(RESNET9_SHAPES, seed=0, dyadic=False))
        jgr = (ref.core.Granularity(kind, bs) if bs
               else ref.core.Granularity(kind))
        jplan = ref.core.build_plan(jg, ref.core.stacked_mask(jg), jgr)
        assert plan_unit_dims(tg, stacked_mask(tg), g) == \
            ref.core.plan_unit_dims(jg, ref.core.stacked_mask(jg), jgr)
    assert (plan.num_leaves, plan.num_exec_units) == \
        (jplan.num_leaves, jplan.num_exec_units)
    assert [b.contiguous for b in plan.buckets] == \
        [b.contiguous for b in jplan.buckets]


def test_compressor_registry_and_no_compression_match_reference():
    from repro_torch.core import available_compressors, no_compression
    cfg = no_compression()
    with reference() as ref:
        assert available_compressors() == ref.core.available_compressors()
        jcfg = ref.core.no_compression()
        assert (cfg.strategy, cfg.qw.name, cfg.qm.name, cfg.wire_dtype,
                cfg.error_feedback, cfg.fusion_bytes, cfg.integrity) == (
            jcfg.strategy, jcfg.qw.name, jcfg.qm.name, jcfg.wire_dtype,
            jcfg.error_feedback, jcfg.fusion_bytes, jcfg.integrity)


@pytest.mark.parametrize("comp", ["qsgd", "signsgd", "topk"])
def test_wire_helpers_match_reference(comp):
    """measured_bits_from_payloads over a step's message buffers (a tuple,
    and nested in a dict), WireCodec.name and MessageLayout.payload_nbytes
    of resnet9's per-bucket layouts."""
    from repro_torch import random as R
    from repro_torch.core import make_compressor, measured_bits_from_payloads
    from repro_torch.core import message_layouts, wire_codec
    from repro_torch.core.wire import execute_schedule_wire
    sched, jsched = _schedules(0.0)
    kw = {"levels": 16} if comp == "qsgd" else {}
    codec = wire_codec(make_compressor(comp, **kw))
    tg = _to_torch(_grads(RESNET9_SHAPES, seed=0, dyadic=False))
    _, bufs = execute_schedule_wire(sched, codec, tg, R.key(2))
    with reference() as ref:
        from repro.core.wire import message_layouts as jlayouts
        jcodec = ref.core.wire_codec(ref.core.make_compressor(comp, **kw))
        jbufs = tuple(jnp.asarray(b.numpy()) for b in bufs)
        want = ref.core.measured_bits_from_payloads(jbufs)
        assert measured_bits_from_payloads(bufs) == want
        assert measured_bits_from_payloads({"a": bufs[:2], "b": [bufs[2:]]}) \
            == want
        assert codec.name == jcodec.name
        assert [lay.payload_nbytes for lay in message_layouts(sched, codec)] \
            == [lay.payload_nbytes for lay in jlayouts(jsched, jcodec)]


def test_bf16_casts_match_reference():
    """to_bf16 / to_f32 touch only f32 / bf16 leaves; the bf16 rounding is
    the reference's (nearest even)."""
    from repro_torch.core import to_bf16, to_f32
    rng = np.random.default_rng(4)
    x = rng.standard_normal(257).astype(np.float32)
    x[:4] = [0.0, -0.0, np.inf, np.float32(1 + 2 ** -8)]
    i = np.arange(5, dtype=np.int32)
    tree = {"a": torch.from_numpy(x), "b": {"c": torch.from_numpy(i)}}
    half = to_bf16(tree)
    assert half["a"].dtype == torch.bfloat16
    assert half["b"]["c"].dtype == torch.int32
    back = to_f32(half)
    assert back["a"].dtype == torch.float32
    with reference() as ref:
        jhalf = ref.wire.to_bf16({"a": jnp.asarray(x),
                                  "b": {"c": jnp.asarray(i)}})
        jback = ref.wire.to_f32(jhalf)
    _bitwise(back["a"].numpy(), np.asarray(jback["a"]))
    assert np.array_equal(back["b"]["c"].numpy(), np.asarray(jback["b"]["c"]))
    assert to_f32(torch.from_numpy(i)).dtype == torch.int32


ALIVE = (True, False, True, True)


@pytest.mark.parametrize("how", ["plan", "schedule", "fusion"])
@pytest.mark.parametrize("comp,ef,wire", [("qsgd", True, True),
                                          ("topk", True, False),
                                          ("signsgd", False, True),
                                          ("terngrad", False, False)])
def test_aggregate_simulated_workers_plan_schedule_alive(comp, ef, wire,
                                                         how):
    """plan= / schedule= (a schedule's plan wins over plan=) and alive=
    over 3 chained steps, bitwise against the reference's jitted call: the
    survivor mean, and a dead worker's frozen EF residual."""
    from repro_torch import random as R
    from repro_torch.core import aggregate_simulated_workers, build_schedule
    from repro_torch.core.granularity import stacked_mask
    plan = _port_plan("layerwise")
    decoy = _port_plan("entire_model")
    rng = np.random.default_rng(len(comp) + 3 * ef + 7 * wire + len(how))
    m_np = np.zeros((N_WORKERS, plan.total), np.float32)
    with reference() as ref:
        cfg, jcfg = _configs(ref, comp, "layerwise", ef,
                             fusion=256.0 if how == "fusion" else None)
        tmpl = _to_jax(_unflatten(plan, m_np[:1]))
        tmpl = jax.tree_util.tree_map(lambda a: a[0], tmpl)
        jplan = ref.core.build_plan(tmpl, ref.core.stacked_mask(tmpl),
                                    ref.core.Granularity("layerwise"))
        jsched = ref.core.build_schedule(jplan, 256.0)
        kw = {"plan": plan, "schedule": None}
        jkw = {"plan": jplan, "schedule": None}
        if how == "schedule":
            kw = {"plan": decoy, "schedule": build_schedule(plan, 256.0)}
            jkw = {"plan": None, "schedule": jsched}
        jagg = jax.jit(lambda g, m, k: ref.core.aggregate_simulated_workers(
            g, ref.core.stacked_mask(g), jcfg, k, ef_state=m, wire=wire,
            alive=ALIVE, **jkw))
        for step in range(3):
            if comp == "qsgd":
                x_np = _norm_exact_flat(plan, rng) - m_np
            else:
                x_np = _normal_flat(plan, rng)
            wg, wm = _unflatten(plan, x_np), _unflatten(plan, m_np)
            tg = _to_torch(wg)
            out, new_m = aggregate_simulated_workers(
                tg, stacked_mask(tg), cfg, R.fold_in(R.key(8), step),
                ef_state=_to_torch(wm) if ef else None, wire=wire,
                alive=ALIVE, **kw)
            jout, jnew_m = jagg(_to_jax(wg), _to_jax(wm) if ef else None,
                                jax.random.fold_in(jkey(8), step))
            _bitwise(_flat_mean(jout), _flat_mean(out))
            if ef:
                new_np = _flatten(plan, new_m)
                _bitwise(_flatten(plan, jnew_m), new_np)
                assert np.array_equal(new_np[1], m_np[1])   # frozen
                m_np = new_np


def test_aggregate_simulated_workers_hooks_name_the_queue():
    """faults= names its ROADMAP item (7); telemetry_plan= (item 5, ported)
    returns the aggregate unchanged and the step's TelemetryState
    increment, with the entire-model leg only when asked."""
    from repro_torch import random as R
    from repro_torch.control import TelemetryState, measurement_plan
    from repro_torch.core import (CompressionConfig,
                                  aggregate_simulated_workers, make_compressor)
    g = {"w": torch.arange(8.0).reshape(2, 4)}
    cfg = CompressionConfig(qw=make_compressor("topk", ratio=0.5))
    with pytest.raises(NotImplementedError, match=r"Queue 1, item 7 \("):
        aggregate_simulated_workers(g, {"w": False}, cfg, R.key(0),
                                    faults=object())
    mplan = measurement_plan({"w": g["w"][0]}, {"w": False})
    out, _ = aggregate_simulated_workers(g, {"w": False}, cfg, R.key(0))
    for em in (True, False):
        got, _, inc = aggregate_simulated_workers(
            g, {"w": False}, cfg, R.key(0), telemetry_plan=mplan,
            telemetry_entire_model=em)
        assert torch.equal(got["w"], out["w"])
        assert isinstance(inc, TelemetryState) and float(inc.steps) == 1.0
        # the workers' mean is (2, 3, 4, 5): sum 14, squares 54
        assert inc.grad_sum.tolist() == [14.0]
        assert inc.grad_sumsq.tolist() == [54.0]
        assert float(inc.em_sumsq) == (54.0 if em else 0.0)


@pytest.mark.parametrize("fusion", list(FUSIONS), ids=list(FUSIONS))
def test_stream_layouts_match_reference(fusion):
    """shard_message_layouts (n = 4 and 3) and layout_chunks (whole, 64 B
    and one region a chunk) of resnet9's schedule, field for field."""
    from repro_torch.core import make_compressor, message_layouts, wire_codec
    from repro_torch.core.wire import layout_chunks, shard_message_layouts
    sched, jsched = _schedules(FUSIONS[fusion])
    with reference() as ref:
        import repro.core.wire as W
        for comp in ("qsgd", "natural", "topk"):
            codec = wire_codec(make_compressor(comp))
            jcodec = ref.core.wire_codec(ref.core.make_compressor(comp))
            pairs = [(message_layouts(sched, codec),
                      W.message_layouts(jsched, jcodec))]
            pairs += [(shard_message_layouts(sched, codec, n),
                       W.shard_message_layouts(jsched, jcodec, n))
                      for n in (3, 4)]
            for mine, theirs in pairs:
                assert [(l.bucket_ids, l.offsets, l.unit_nbytes,
                         l.header_nbytes, l.total_nbytes) for l in mine] == \
                    [(l.bucket_ids, l.offsets, l.unit_nbytes,
                      l.header_nbytes, l.total_nbytes) for l in theirs]
                for chunk in (None, 64.0, 0.0):
                    assert [layout_chunks(l, chunk) for l in mine] == \
                        [W.layout_chunks(l, chunk) for l in theirs]


@pytest.mark.parametrize("comp", ["qsgd", "signsgd", "topk"])
def test_decode_accumulate_matches_reference(comp):
    """WireCodec.decode_accumulate(_ef): the decoded rows land in the
    source rank's slot of the (n, units, d) accumulator, the rest stays;
    the EF form's residual is e - xhat."""
    from repro_torch import random as R
    from repro_torch.core import make_compressor, wire_codec
    kw = {"levels": 16} if comp == "qsgd" else {}
    codec = wire_codec(make_compressor(comp, **kw))
    rng = np.random.default_rng(9)
    x = rng.standard_normal((3, 40)).astype(np.float32)
    e = rng.standard_normal((3, 40)).astype(np.float32)
    pay = codec.encode_batch(torch.from_numpy(x), R.fold_in(
        R.key(1)[None], torch.arange(3)))
    acc = torch.full((4, 3, 40), 7.0)
    got = codec.decode_accumulate(pay, acc.clone(), 2, 40)
    got_ef, m = codec.decode_accumulate_ef(pay, torch.from_numpy(e),
                                           acc.clone(), 1, 40)
    with reference() as ref:
        jcodec = ref.core.wire_codec(ref.core.make_compressor(comp, **kw))
        jpay = jnp.asarray(pay.numpy())
        jacc = jnp.full((4, 3, 40), 7.0, jnp.float32)
        want = jcodec.decode_accumulate(jpay, jacc, 2, 40)
        want_ef, jm = jcodec.decode_accumulate_ef(jpay, jnp.asarray(e), jacc,
                                                  1, 40)
    _bitwise(got.numpy(), np.asarray(want))
    _bitwise(got_ef.numpy(), np.asarray(want_ef))
    _bitwise(m.numpy(), np.asarray(jm))
