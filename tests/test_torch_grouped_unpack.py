"""The grouped sign pack and QSGD unpack (csrc/sign.cu sign_pack_buckets,
csrc/qsgd.cu qsgd_unpack_buckets) and the codecs and schedule step that
call them, in what the CPU can hold. Every comparison is bitwise:

  - sign_table / unpack_table: block prefix sums, words and tiles per
    unit, at the 11 resnet9 layerwise buckets (one table) and at 33 and
    70 buckets (two and three tables);
  - a plain mirror of each kernel's work split writes every output word
    (sign: tiles of 64 chunks of 32 elements, one ballot a chunk, lane r
    of warp w storing word 8w + r) and every output element (unpack:
    tiles of 64 chunks of 32 codes staged as 64 * width words, 16-byte
    stores at d % 4 == 0) exactly once, reads nothing past its tile, and
    equals sign_pack_plain / qsgd_unpack_plain at d at the chunk and tile
    edges, at QSGD widths 2/4/6/8;
  - ops.sign_pack_units_buckets / qsgd_unpack_units_buckets equal the
    per-bucket calls and the reference's ops.sign_pack_units /
    qsgd_unpack_units (sign_pack_pallas_rows, and qsgd_unpack_pallas_rows
    at width 6, in interpret mode; the jnp fallback at the other QSGD
    widths), with -0.0, NaN and empty buckets, and route CPU tensors to
    the plain twins without a launch;
  - SignSGDCodec.encode_buckets and QSGDCodec.decode_buckets /
    decode_ef_buckets equal their per-bucket forms, fused and not;
  - one execute_schedule_wire(_with_state) step over six of resnet9's
    layers (5 buckets) through the QSGD and signSGD codecs at fusion
    {per-bucket, 64 KiB, one message}: buffers,
    trees and EF residuals equal the reference's. The reference runs
    eagerly on dyadic gradients: the unit norms are exact in any summation
    order, levels 16 makes nrm / 16 exact (jit's multiply by 1/16 is the
    same number), and the EF residual rounds twice as the port's does
    (tests/test_torch_grouped_pack.py states why the jitted EF run
    differs).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_grouped_fields import _words
from test_torch_grouped_pack import (WIDTH_LEVELS, _prefix,
                                     _resnet9_layerwise_shapes)
from test_torch_ref import jkey, np_bits, reference
from test_torch_wire import (FUSIONS, RESNET9_SHAPES, _assert_trees_bitwise,
                             _grads, _port_schedule, _to_jax, _to_torch)

# chunk edges (1, 2, 31-33) and tile edges (2,047-2,049, 4,097) of the
# 2,048-element tiles, and a unit of 33 tiles
EDGE_DIMS = (1, 2, 31, 32, 33, 2047, 2048, 2049, 4097, 65537)
# QSGD(16)'s width: the reference's Pallas unpack runs in interpret mode at
# it; the other widths take the reference's jnp fallback (the plain twins
# are held against the Pallas kernel at every width in
# tests/test_torch_kernels.py)
MAIN_WIDTH = 6
# six of resnet9's layers: 5 layerwise buckets (one of two stacked units),
# 5 / 2 / 1 messages at the three fusions; fewer bucket shapes than the
# whole model keep the reference's eager run cheap
SCHEDULE_SHAPES = {k: RESNET9_SHAPES[k] for k in (
    "conv0_w", "conv1_b", "conv1_w", "head_w", "res1a_w", "res1b_w")}


def _sign_inputs(n, d, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    x[:, ::5] = 0.0
    x[:, 2::7] = -0.0
    if n * d:
        x[0, -1] = np.nan
    return torch.from_numpy(x)


def _facs(n, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.random(n) + 0.1).astype(np.float32))


@pytest.mark.parametrize("kernel", ["sign_pack", "qsgd_unpack"])
@pytest.mark.parametrize("case", ["resnet9_layerwise", "33_buckets",
                                  "70_buckets"])
def test_tables(case, kernel):
    from repro_torch.kernels.qsgd import (BALLOT_TILE, MAX_BUCKETS,
                                          TILE_CODES, ballot_tiles,
                                          unpack_table, unpack_tiles)
    from repro_torch.kernels.ref import words_per_unit
    from repro_torch.kernels.sign import sign_table
    if case == "resnet9_layerwise":
        shapes = _resnet9_layerwise_shapes()
        assert len(shapes) == 11
        groups = [shapes]
    else:
        count = int(case.split("_")[0])
        shapes = [(1 + i % 5, 1 + 613 * i) for i in range(count)]
        groups = [shapes[i:i + MAX_BUCKETS]
                  for i in range(0, count, MAX_BUCKETS)]
    if kernel == "sign_pack":
        width, tile, tables = 1, BALLOT_TILE, sign_table(shapes)
        assert [ballot_tiles(d) for _, d in shapes] == [
            math.ceil(d / 2048) for _, d in shapes]
    else:
        width, tile, tables = 6, TILE_CODES, unpack_table(shapes, 6)
        assert [unpack_tiles(d) for _, d in shapes] == [
            math.ceil(d / 2048) for _, d in shapes]
    assert len(tables) == len(groups)
    for t, group in zip(tables, groups):
        assert t.n == tuple(n for n, _ in group)
        assert t.d == tuple(d for _, d in group)
        assert t.wpu == tuple(words_per_unit(d, width) for _, d in group)
        assert t.tiles == tuple(math.ceil(d / tile) for _, d in group)
        starts, blocks = _prefix([n * k for (n, _), k in zip(group,
                                                              t.tiles)])
        assert t.block_start == tuple(starts) and t.blocks == blocks
    if case == "resnet9_layerwise":             # 68 tiles a worker
        assert tables[0].blocks == 272


def _mirror_sign_pack(x):
    """csrc/sign.cu sign_pack_kernel, block by block -> (words as
    sign_pack_plain gives them, writes per word)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.qsgd import BALLOT_TILE, ballot_tiles
    n, d = x.shape
    wpu = ref.words_per_unit(d, 1)
    chunks, warps = BALLOT_TILE // 32, 8
    per_warp = chunks // warps
    out = torch.zeros((n, wpu), dtype=torch.int64)
    writes = torch.zeros((n, wpu), dtype=torch.int64)
    lanes = torch.arange(32)
    c = torch.arange(chunks)
    warp, lane = c // per_warp, c % per_warp    # who stores chunk c's word
    assert bool((warp < warps).all() and (lane < 32).all())
    for unit in range(n):
        for tile in range(ballot_tiles(d)):
            e0 = tile * BALLOT_TILE
            ne = min(BALLOT_TILE, d - e0)
            if d % 4 == 0:                      # 16-byte loads: none past d
                assert ne % 4 == 0
            staged = torch.full((BALLOT_TILE,), float("nan"))  # never read
            staged[:ne] = x[unit, e0:e0 + ne]
            i = c[:, None] * 32 + lanes[None, :]
            bits = (i < ne) & (staged[i] >= 0.0)     # one ballot a chunk
            words = (bits.to(torch.int64) << lanes).sum(dim=1)
            store = 32 * c < ne                      # words past wpu: none
            idx = tile * chunks + c[store]
            out[unit, idx] = words[store]
            writes[unit].index_add_(0, idx, torch.ones_like(idx))
    return ref.words_to_i32(out), writes


def _mirror_qsgd_unpack(words, fac, d, levels, width):
    """csrc/qsgd.cu qsgd_unpack_kernel, block by block -> (values, writes
    per element)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.qsgd import TILE_CODES, unpack_tiles
    n, wpu = words.shape
    chunks = TILE_CODES // 32
    out = torch.zeros((n, d), dtype=torch.float32)
    writes = torch.zeros((n, d), dtype=torch.int64)
    w64 = ref.words_from_i32(words)
    for unit in range(n):
        for tile in range(unpack_tiles(d)):
            w0 = tile * chunks * width
            nw = min(chunks * width, wpu - w0)
            staged = w64[unit, w0:w0 + nw]
            f0 = tile * TILE_CODES
            nf = min(TILE_CODES, d - f0)
            p = torch.arange(nf)
            b = p * width
            wi, s = b >> 5, b & 31
            span = s + width > 32
            assert int(torch.where(span, wi + 1, wi).max()) < nw
            lo = staged[wi] >> s
            hi = (staged[(wi + 1).clamp(max=nw - 1)] << (32 - s)) & 0xFFFFFFFF
            code = torch.where(span, lo | hi, lo) & ((1 << width) - 1)
            out[unit, f0:f0 + nf] = (code - levels).to(torch.float32) \
                * fac[unit]
            if d % 4 == 0:                 # 16-byte stores of 4 elements
                assert nf % 4 == 0
                for v in range(4):
                    writes[unit, f0 + v:f0 + nf:4] += 1
            else:
                writes[unit, f0:f0 + nf] += 1
    return out, writes


@pytest.mark.parametrize("d", EDGE_DIMS)
def test_sign_pack_split_writes_each_word_once(d):
    from repro_torch.kernels.sign import sign_pack_plain
    x = _sign_inputs(2, d, seed=d)
    got, writes = _mirror_sign_pack(x)
    assert bool((writes == 1).all())
    assert torch.equal(got, sign_pack_plain(x))


@pytest.mark.parametrize("width,levels", WIDTH_LEVELS)
@pytest.mark.parametrize("d", EDGE_DIMS)
def test_qsgd_unpack_split_writes_each_element_once(d, width, levels):
    from repro_torch.kernels.qsgd import qsgd_unpack_plain
    from repro_torch.kernels.ref import words_per_unit
    words = _words(2, words_per_unit(d, width), seed=d + width)
    fac = _facs(2, seed=d)
    got, writes = _mirror_qsgd_unpack(words, fac, d, levels, width)
    assert bool((writes == 1).all())
    want = qsgd_unpack_plain(words, fac, d, levels, width)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


GROUP_DIMS = [1, 2, 31, 33, 700, 2049, 4608]


def test_sign_pack_units_buckets_match_per_bucket_and_reference():
    from repro_torch.kernels import ops
    xs = [_sign_inputs(1 + i % 3, d, seed=10 + i)
          for i, d in enumerate(GROUP_DIMS)]
    got = ops.sign_pack_units_buckets(xs)
    assert len(got) == len(xs)
    with reference() as ref:
        for g, x in zip(got, xs):
            assert torch.equal(g, ops.sign_pack_units(x))
            jw = ref.ops.sign_pack_units(jnp.asarray(x.numpy()))
            assert np.array_equal(np.asarray(jw), np_bits(g))


@pytest.mark.parametrize("width,levels", WIDTH_LEVELS)
def test_qsgd_unpack_units_buckets_match_per_bucket_and_reference(width,
                                                                  levels):
    from repro_torch.kernels import ops
    words = [_words(1 + i % 3, ops.words_per_unit(d, width), seed=20 + i)
             for i, d in enumerate(GROUP_DIMS)]
    nrms = [_facs(w.shape[0], seed=30 + i) * 7 for i, w in enumerate(words)]
    got = ops.qsgd_unpack_units_buckets(words, nrms, GROUP_DIMS, levels,
                                        width)
    assert len(got) == len(words)
    with reference() as ref:
        for g, w, nrm, d in zip(got, words, nrms, GROUP_DIMS):
            one = ops.qsgd_unpack_units(w, nrm, d, levels, width)
            assert torch.equal(g.view(torch.int32), one.view(torch.int32))
            jx = ref.ops.qsgd_unpack_units(
                jnp.asarray(w.numpy().view(np.uint32)),
                jnp.asarray(nrm.numpy()), d, levels, width,
                use_pallas=width == MAIN_WIDTH)
            assert np.array_equal(np.asarray(jx).view(np.uint32),
                                  g.numpy().view(np.uint32))


def test_grouped_sign_unpack_route_cpu_and_keep_empty_buckets():
    from repro_torch import kernels
    from repro_torch.kernels import ops
    from repro_torch.kernels import qsgd as Q
    from repro_torch.kernels import sign as S
    kernels.reset_launch_counts()
    xs = [_sign_inputs(2, 5, seed=1), torch.zeros((0, 7)),
          torch.ones((3, 0))]
    outs = S.sign_pack_buckets(xs)
    assert [tuple(o.shape) for o in outs] == [(2, 1), (0, 1), (3, 0)]
    assert torch.equal(outs[0], S.sign_pack_plain(xs[0]))
    assert S.sign_pack_buckets([]) == []
    words = [_words(2, 1, seed=2), torch.zeros((0, 2), dtype=torch.int32),
             torch.zeros((3, 0), dtype=torch.int32)]
    facs = [torch.ones(2), torch.ones(0), torch.ones(3)]
    dec = Q.qsgd_unpack_buckets(words, facs, [5, 7, 0], 16, 6)
    assert [tuple(o.shape) for o in dec] == [(2, 5), (0, 7), (3, 0)]
    assert torch.equal(dec[0], Q.qsgd_unpack_plain(words[0], facs[0], 5, 16,
                                                   6))
    assert Q.qsgd_unpack_buckets([], [], [], 16, 6) == []
    assert ops.qsgd_unpack_units_buckets([], [], [], 16, 6) == []
    assert ops.sign_pack_units_buckets([]) == []
    counts = kernels.launch_counts()
    assert counts["sign_pack"] == counts["qsgd_unpack"] == 0


def test_codecs_grouped_equal_per_bucket_forms():
    """SignSGDCodec.encode_buckets and QSGDCodec.decode_buckets /
    decode_ef_buckets equal the per-bucket calls and the forms built from
    the plain twins, fused and not."""
    from repro_torch import random as R
    from repro_torch.core.compressors import QSGD, SignSGD
    from repro_torch.core.wire import _split, wire_codec
    from repro_torch.kernels.qsgd import qsgd_unpack_plain
    from repro_torch.kernels.sign import sign_pack_plain
    xs = [_sign_inputs(1 + i % 3, d, seed=40 + i)
          for i, d in enumerate(GROUP_DIMS)]
    xs = [x.nan_to_num() for x in xs]
    ks = [R.fold_in(R.key(3)[None], torch.arange(x.shape[0]) + 10 * i)
          for i, x in enumerate(xs)]
    es = [_sign_inputs(x.shape[0], x.shape[1], seed=60 + i).nan_to_num()
          for i, x in enumerate(xs)]
    for fused in (True, False):
        sign = wire_codec(SignSGD(), fused=fused)
        for p, x, k in zip(sign.encode_buckets(xs, ks), xs, ks):
            assert torch.equal(p, sign.encode_batch(x, k))
            assert torch.equal(p, sign_pack_plain(x).view(torch.uint8))
        q = wire_codec(QSGD(levels=16), fused=fused)
        pays = q.encode_buckets(xs, ks)
        dec = q.decode_buckets(pays, GROUP_DIMS)
        ef = q.decode_ef_buckets(pays, es, GROUP_DIMS)
        for p, d, e, xhat, (xe, m) in zip(pays, GROUP_DIMS, es, dec, ef):
            nrm, w = _split(p)
            want = qsgd_unpack_plain(w, nrm / 16, d, 16, q.entry_bits)
            assert torch.equal(xhat.view(torch.int32), want.view(torch.int32))
            assert torch.equal(xhat, q.decode_batch(p, d))
            wx, wm = q.decode_ef_batch(p, e, d)
            assert torch.equal(xe, wx) and torch.equal(m, wm)
            assert torch.equal(xe.view(torch.int32), xhat.view(torch.int32))
            assert torch.equal(m.view(torch.int32),
                               (e - xhat).view(torch.int32))


@pytest.mark.parametrize("ef", [False, True], ids=["plain", "ef"])
@pytest.mark.parametrize("fusion", sorted(FUSIONS))
@pytest.mark.parametrize("name", ["qsgd", "signsgd"])
def test_schedule_step_through_grouped_kernels(name, fusion, ef):
    from repro_torch import random as R
    from repro_torch.core.compressors import QSGD, SignSGD
    from repro_torch.core.wire import (execute_schedule_wire,
                                       execute_schedule_wire_with_state,
                                       wire_codec)
    g = _grads(SCHEDULE_SHAPES, seed=17 + len(fusion), dyadic=True)
    m = _grads(SCHEDULE_SHAPES, seed=19, dyadic=True)
    tg = _to_torch(g)
    sched = _port_schedule(tg, "layerwise", FUSIONS[fusion])
    comp = QSGD(levels=16) if name == "qsgd" else SignSGD()
    codec = wire_codec(comp)
    if ef:
        tree, mtree, bufs = execute_schedule_wire_with_state(
            sched, codec, tg, _to_torch(m), R.key(4))
    else:
        tree, bufs = execute_schedule_wire(sched, codec, tg, R.key(4))
    with reference() as ref:
        jg, jm = _to_jax(g), _to_jax(m)
        jplan = ref.core.build_plan(jg, ref.core.stacked_mask(jg),
                                    ref.core.Granularity("layerwise"))
        jsched = ref.core.build_schedule(jplan, FUSIONS[fusion])
        jcomp = (ref.core.QSGD(levels=16) if name == "qsgd"
                 else ref.core.SignSGD())
        jcodec = ref.core.wire_codec(jcomp)
        if ef:
            jtree, jmtree, jbufs = jsched.execute_with_state(
                None, jg, jm, jkey(4), wire=jcodec)
            _assert_trees_bitwise(jmtree, mtree)
        else:
            jtree, jbufs = jsched.execute(None, jg, jkey(4), wire=jcodec)
        assert len(jbufs) == len(bufs) == sched.num_messages
        for jb, tb in zip(jbufs, bufs):
            assert np.array_equal(np.asarray(jb), tb.numpy())
        _assert_trees_bitwise(jtree, tree)

