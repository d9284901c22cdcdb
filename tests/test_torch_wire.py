"""The port's wire codecs and fused message buffers against the reference
(core/wire.py, core/schedule.py): buffers byte-identical and decoded
trees bitwise equal for QSGD, TernGrad, signSGD, top-k and random-k x
{layerwise, entire_model} x fusion {per-bucket, 64 KiB, one message}
(natural compression to the tolerance stated in test_torch_codecs.py),
plus the deterministic resnet9 counts of BENCH_wire.json /
BENCH_schedule.json.

QSGD runs on dyadic gradients (entries in {0, ±0.25, ±0.5, ±1, ±2}): the
l2 norm is in the payload, and torch and jnp sum squares in different
orders, so only inputs whose sum of squares is exact in any order give
equal norms. TernGrad's statistic is max|x|, which does not depend on
order, so it runs on random normal gradients.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_ref import jkey, reference

FUSIONS = {"per_bucket": 0.0, "fused_64kib": float(1 << 16),
           "one_shot": math.inf}

RESNET9_SHAPES = {"conv0_b": (16,), "conv0_w": (3, 3, 3, 16),
                  "conv1_b": (32,), "conv1_w": (3, 3, 16, 32),
                  "conv2_b": (64,), "conv2_w": (3, 3, 32, 64),
                  "head_b": (10,), "head_w": (64, 10),
                  "res0a_w": (3, 3, 16, 16), "res0b_w": (3, 3, 16, 16),
                  "res1a_w": (3, 3, 32, 32), "res1b_w": (3, 3, 32, 32),
                  "res2a_w": (3, 3, 64, 64), "res2b_w": (3, 3, 64, 64)}
MIXED_SHAPES = {"blocks": {"w": (3, 16, 8), "b": (3, 8)}, "embed": (20, 4),
                "head": (4, 2), "scalar_gain": ()}


def _grads(shapes, seed, dyadic):
    """Same numpy gradients as a nested dict of arrays."""
    rng = np.random.default_rng(seed)

    def leaf(s):
        if dyadic:
            return rng.choice(np.float32([0, .25, -.25, .5, -.5, 1, -1, 2,
                                          -2]), s).astype(np.float32)
        return rng.standard_normal(s).astype(np.float32)
    return {k: (_grads(v, seed + 1, dyadic) if isinstance(v, dict)
                else leaf(v)) for k, v in shapes.items()}


def _to_torch(t):
    return {k: _to_torch(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in t.items()}


def _to_jax(t):
    return {k: _to_jax(v) if isinstance(v, dict) else jnp.asarray(v)
            for k, v in t.items()}


def _port_schedule(tree, gran, fusion):
    from repro_torch.core.granularity import Granularity, stacked_mask
    from repro_torch.core.plan import build_plan
    from repro_torch.core.schedule import build_schedule
    plan = build_plan(tree, stacked_mask(tree), Granularity(gran))
    return build_schedule(plan, fusion)


def _assert_trees_bitwise(jt, tt):
    jl = jax.tree_util.tree_leaves(jt)
    from repro_torch.convert import tree_leaves
    tl = tree_leaves(tt)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        a = np.asarray(a)
        assert a.shape == tuple(b.shape)
        assert np.array_equal(a.view(np.uint32), b.numpy().view(np.uint32))


@pytest.mark.parametrize("fusion", sorted(FUSIONS))
@pytest.mark.parametrize("gran", ["layerwise", "entire_model"])
@pytest.mark.parametrize("comp", ["qsgd", "terngrad", "signsgd", "topk",
                                  "randomk"])
@pytest.mark.parametrize("shapes", ["resnet9", "mixed"])
def test_message_buffers_byte_identical(shapes, comp, gran, fusion):
    from repro_torch import random as R
    from repro_torch.core.compressors import make_compressor
    from repro_torch.core.wire import execute_schedule_wire, wire_codec
    g = _grads(RESNET9_SHAPES if shapes == "resnet9" else MIXED_SHAPES,
               seed=len(gran) + len(comp), dyadic=comp == "qsgd")
    tg = _to_torch(g)
    sched = _port_schedule(tg, gran, FUSIONS[fusion])
    codec = wire_codec(make_compressor(comp))
    tree, bufs = execute_schedule_wire(sched, codec, tg, R.key(4))
    with reference() as ref:
        jg = _to_jax(g)
        jplan = ref.core.build_plan(jg, ref.core.stacked_mask(jg),
                                    ref.core.Granularity(gran))
        jsched = ref.core.build_schedule(jplan, FUSIONS[fusion])
        jcodec = ref.core.wire_codec(ref.core.make_compressor(comp))
        jtree, jbufs = jax.jit(lambda g, k: jsched.execute(
            None, g, k, wire=jcodec))(jg, jkey(4))
        assert len(jbufs) == len(bufs) == sched.num_messages
        for jb, tb in zip(jbufs, bufs):
            assert np.array_equal(np.asarray(jb), tb.numpy())
        _assert_trees_bitwise(jtree, tree)


SPARSE_COUNTS = {"per_bucket": (11, 7_272), "fused_64kib": (4, 7_244),
                 "one_shot": (1, 7_232)}


@pytest.mark.parametrize("comp,expect,bits", [
    ("qsgd", {"per_bucket": (11, 90_896), "fused_64kib": (4, 90_868),
              "one_shot": (1, 90_856)}, 726_464),
    ("terngrad", {"per_bucket": (11, 30_396), "fused_64kib": (4, 30_368),
                  "one_shot": (1, 30_356)}, 242_464),
    ("signsgd", {"per_bucket": (11, 15_220), "fused_64kib": (4, 15_192),
                 "one_shot": (1, 15_180)}, 121_056),
    ("natural", {"per_bucket": (11, 136_220), "fused_64kib": (4, 136_192),
                 "one_shot": (1, 136_180)}, 1_089_056),
    ("topk", SPARSE_COUNTS, 57_472),
    ("randomk", SPARSE_COUNTS, 57_472),
])
def test_resnet9_wire_counts(comp, expect, bits):
    """BENCH_wire.json's resnet9 layerwise numbers, measured on the port's
    real buffers."""
    from repro_torch import random as R
    from repro_torch.core.compressors import make_compressor
    from repro_torch.core.wire import (execute_schedule_wire,
                                       message_layouts, wire_codec)
    tg = _to_torch(_grads(RESNET9_SHAPES, seed=1, dyadic=False))
    codec = wire_codec(make_compressor(comp))
    measured = set()
    for name, fusion in FUSIONS.items():
        sched = _port_schedule(tg, "layerwise", fusion)
        assert sched.plan.num_units == 14 and sched.plan.num_dispatches == 11
        _, bufs = execute_schedule_wire(sched, codec, tg, R.key(0))
        total = sum(b.numel() for b in bufs)
        assert (len(bufs), total) == expect[name], name
        layouts = message_layouts(sched, codec)
        assert [l.total_nbytes for l in layouts] == [b.numel() for b in bufs]
        header = sum(l.header_nbytes for l in layouts)
        measured.add(8 * (total - header))
    assert measured == {bits}


def test_codec_accounting_matches_reference():
    from repro_torch.core.compressors import QSGD, TernGrad
    from repro_torch.core.wire import wire_codec
    with reference() as ref:
        for levels in (1, 4, 16, 64):
            c, jc = (wire_codec(QSGD(levels=levels)),
                     ref.core.wire_codec(ref.core.QSGD(levels=levels)))
            for d in (1, 31, 32, 700, 121002):
                assert c.nbytes(d) == jc.nbytes(d)
                assert c.payload_bits(d) == jc.payload_bits(d)
                assert c.padding_bits(d) == jc.padding_bits(d)
            assert c.comp.omega(100) == jc.comp.omega(100)
        c, jc = wire_codec(TernGrad()), ref.core.wire_codec(
            ref.core.TernGrad())
        for d in (1, 31, 32, 700, 121002):
            assert (c.nbytes(d), c.payload_bits(d)) == (jc.nbytes(d),
                                                        jc.payload_bits(d))


@pytest.mark.parametrize("gran", ["layerwise", "entire_model"])
def test_natural_message_buffers_within_tolerance(gran):
    """Natural compression's buffers: the same layout, headers and sizes
    as the reference, and every 9-bit code within the stated tolerance."""
    from repro_torch import random as R
    from repro_torch.core.compressors import make_compressor
    from repro_torch.core.wire import (execute_schedule_wire,
                                       message_layouts, wire_codec)
    from repro_torch.kernels import ops
    from test_torch_codecs import _natural_codes_close
    rng = np.random.default_rng(7)
    g = {k: (rng.standard_normal(s) * 10.0 ** rng.uniform(-8, 0, s))
         .astype(np.float32) for k, s in RESNET9_SHAPES.items()}
    tg = _to_torch(g)
    sched = _port_schedule(tg, gran, 0.0)
    codec = wire_codec(make_compressor("natural"))
    _, bufs = execute_schedule_wire(sched, codec, tg, R.key(4))
    with reference() as ref:
        jg = _to_jax(g)
        jplan = ref.core.build_plan(jg, ref.core.stacked_mask(jg),
                                    ref.core.Granularity(gran))
        jsched = ref.core.build_schedule(jplan, 0.0)
        jcodec = ref.core.wire_codec(ref.core.make_compressor("natural"))
        _, jbufs = jax.jit(lambda g, k: jsched.execute(
            None, g, k, wire=jcodec))(jg, jkey(4))
    for jb, tb, layout in zip(jbufs, bufs, message_layouts(sched, codec)):
        jb = np.asarray(jb)
        assert jb.shape == tuple(tb.shape)
        h = layout.header_nbytes
        assert np.array_equal(jb[:h], tb[:h].numpy())
        for j, bi in enumerate(layout.bucket_ids):
            b = sched.plan.buckets[bi]
            off, nb = layout.offsets[j], layout.unit_nbytes[j]
            rows = [torch.from_numpy(buf[off:off + b.n * nb].copy())
                    .view(torch.int32).reshape(b.n, -1)
                    for buf in (jb, tb.numpy())]
            jc, tc = (ops.fields_unpack_units(r, b.dim, 9).numpy() - 255
                      for r in rows)
            _natural_codes_close(jc, tc)


def test_unported_compressors_name_the_queue():
    """What the port leaves out names its queue: compressed_allreduce's
    fault hook; and a streaming strategy without wire=True raises the
    reference's ValueError (all checked before any collective runs, so no
    process group). The telemetry and recorder hooks, ported, get as far
    as the process group; the recorder on the wire path it threads to
    (execute_schedule_wire) gives the reference's structure: a message
    span a schedule message, each with compress, pack and decode stages
    attributed to the codec (tests/test_torch_obs.py holds the args
    against the reference's recorder)."""
    from repro_torch import random as R
    from repro_torch.core import build_plan, build_schedule, stacked_mask
    from repro_torch.core.aggregation import (CompressionConfig,
                                              compressed_allreduce)
    from repro_torch.core.compressors import make_compressor
    from repro_torch.core.wire import execute_schedule_wire, wire_codec
    from repro_torch.obs import TraceRecorder
    g = {"w": torch.zeros(4)}
    for strategy in ("ring", "rs_stream"):
        cfg = CompressionConfig(qw=make_compressor("qsgd"),
                                strategy=strategy)
        with pytest.raises(ValueError, match="pass wire=True"):
            compressed_allreduce(g, {"w": False}, cfg, None, R.key(0), 2)
    cfg = CompressionConfig(qw=make_compressor("qsgd"), strategy="allgather")
    for kw, queue in (({"faults": object()}, r"item 7 \("),):
        with pytest.raises(NotImplementedError, match=f"Queue 1, {queue}"):
            compressed_allreduce(g, {"w": False}, cfg, None, R.key(0), 2,
                                 wire=True, **kw)
    # telemetry_plan= (item 5) and recorder= (item 6) are ported: they
    # reach the collective, whose group check comes first
    # (tests/test_torch_control.py and test_torch_obs.py run them)
    from repro_torch.control import measurement_plan
    for kw in ({"telemetry_plan": measurement_plan(g, {"w": False})},
               {"recorder": TraceRecorder()}):
        with pytest.raises(ValueError, match="Default process group"):
            compressed_allreduce(g, {"w": False}, cfg, None, R.key(0), 2,
                                 wire=True, **kw)
    t = {"a": torch.ones(3, 5), "b": torch.ones(7)}
    sched = build_schedule(build_plan(t, stacked_mask(t), cfg.granularity),
                           0.0)
    codec = wire_codec(cfg.qw)
    rec = TraceRecorder()
    execute_schedule_wire(sched, codec, t, R.key(0), recorder=rec)
    assert rec.finalize_step(0)["n_message_spans"] == sched.num_messages
    for e in rec.message_spans(0):
        assert e["args"]["codec"] == codec.name
        assert {"compress", "pack", "decode"} <= set(e["args"]["stages"])


@pytest.mark.parametrize("gran", ["layerwise", "entire_model"])
def test_comm_report_matches_reference(gran):
    """core/bits.py: comm_report for every strategy the reference reports,
    analytic and measured, per-unit and fused messages, on resnet9."""
    from repro_torch.core.aggregation import CompressionConfig
    from repro_torch.core.bits import comm_report
    from repro_torch.core.compressors import make_compressor
    from repro_torch.core.granularity import Granularity
    tg = _to_torch(_grads(RESNET9_SHAPES, seed=0, dyadic=False))
    plan = _port_schedule(tg, gran, 0.0).plan
    with reference() as ref:
        import repro.core.bits as jbits
        jg = _to_jax(_grads(RESNET9_SHAPES, seed=0, dyadic=False))
        jplan = ref.core.build_plan(jg, ref.core.stacked_mask(jg),
                                    ref.core.Granularity(gran))
        for strategy, comp, kw in (
                ("dense", "identity", {}), ("simulated", "qsgd", {}),
                ("allgather", "qsgd", {}), ("allgather", "signsgd", {}),
                ("allgather", "topk", {}), ("allgather", "natural", {}),
                ("rs_compress_ag", "terngrad", {}),
                ("shared_random", "randomk", {"ratio": 0.05})):
            for wire_dtype in ("float32", "bfloat16"):
                for fusion in (None, 65536.0):
                    cfg = CompressionConfig(
                        qw=make_compressor(comp, **kw),
                        granularity=Granularity(gran), strategy=strategy,
                        wire_dtype=wire_dtype, fusion_bytes=fusion)
                    jcfg = ref.core.CompressionConfig(
                        qw=ref.core.make_compressor(comp, **kw),
                        granularity=ref.core.Granularity(gran),
                        strategy=strategy, wire_dtype=wire_dtype,
                        fusion_bytes=fusion)
                    for measured in (False, True):
                        mine = comm_report(cfg, plan, 4, measured=measured,
                                           alpha_bits_per_message=7)
                        theirs = jbits.comm_report(
                            jcfg, jplan, 4, measured=measured,
                            alpha_bits_per_message=7)
                        assert dataclasses.asdict(mine) == \
                            dataclasses.asdict(theirs), (strategy, comp)
                        assert mine.total_bits_with_latency() == \
                            theirs.total_bits_with_latency()
