"""The grouped, hash-once TernGrad pack (csrc/terngrad.cu
terngrad_pack_buckets, the tile walk of csrc/hash_pack.cuh it shares with
the QSGD pack) and the codec and schedule step that call it, in what the
CPU can hold. Every comparison is bitwise:

  - a plain mirror of the shared tile walk at width 2 (tiles of 480 pairs
    and a halo chunk, lower / upper / mixed 32-position chunks) writes
    every output word exactly once and equals terngrad_pack_plain, at d =
    1, 2, 3, odd d, h = ceil(d / 2) = 32k +- 1 and the tile edges, inputs
    with -0.0 and NaN;
  - bucket_table at width 2: the 11 resnet9 layerwise buckets in one table,
    40 buckets in two;
  - terngrad_pack_buckets equals terngrad_pack_plain per bucket and the
    reference's terngrad_pack_pallas_rows in interpret mode (on the same
    scales), at the edge dimensions, on the 11 layerwise buckets and on 40
    buckets;
  - ops.terngrad_pack_units_buckets equals per-bucket ops.terngrad_pack_units
    and the reference's ops.terngrad_pack_units (scale max|x| is exact in
    any order);
  - TernGradCodec(fused=True).encode_buckets equals per-bucket encode_batch
    and the reference codec's bytes; execute_schedule_wire(_with_state)
    TernGrad buffers, trees and EF residuals equal the reference's at
    fusion {per-bucket, 64 KiB, one message} (EF against the reference's
    eager run: tests/test_torch_grouped_pack.py states why).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_grouped_pack import (_key_words, _mirror_pack, _prefix,
                                     _resnet9_layerwise_shapes)
from test_torch_kernels import _pallas_pack
from test_torch_ref import jkey, np_bits, reference, tkeys
from test_torch_wire import (FUSIONS, RESNET9_SHAPES, _assert_trees_bitwise,
                             _grads, _port_schedule, _to_jax, _to_torch)

# chunk edges (1-3, 31-33), h = ceil(d / 2) = 32k +- 1 (61-66, 127, 129)
# and tile edges (h = 240, 480, 481, 960, 961 pairs, TILE_PAIRS = 480)
MIRROR_DIMS = [1, 2, 3, 31, 32, 33, 61, 62, 63, 65, 66, 127, 129, 479, 480,
               481, 957, 959, 960, 961, 962, 1919, 1921, 2049]
# the edge dimensions held against the reference's Pallas pack
EDGE_DIMS = [1, 2, 3, 31, 32, 33, 61, 63, 65, 479, 480, 481, 961, 2049]


def _inputs(n, d, seed, specials=True):
    """Seeded (n, d) f32 units (every 7th entry 0, some -0.0 and one NaN
    under `specials`), their scales max|x| + 1e-12 over the finite entries
    and (n, 2) uint32 keys."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    x[:, ::7] = 0.0
    scale = np.abs(x).max(axis=1) + np.float32(1e-12)
    if specials:
        x[:, 3::11] = -0.0
        x[0, min(5, d - 1)] = np.nan
    keys = rng.integers(0, 2**32, (n, 2), dtype=np.uint64).astype(np.uint32)
    return torch.from_numpy(x), torch.from_numpy(scale), keys


@pytest.mark.parametrize("d", MIRROR_DIMS)
def test_terngrad_pack_split_writes_each_word_once(d):
    from repro_torch.kernels.ref import terngrad_codes_ref
    from repro_torch.kernels.terngrad import TERN_WIDTH, terngrad_pack_plain
    x, scale, keys = _inputs(2, d, seed=d)
    k0, k1 = _key_words(keys)
    got, writes = _mirror_pack(x, k0, k1, TERN_WIDTH, lambda unit, xv, u:
                               terngrad_codes_ref(xv, u, scale[unit]))
    assert bool((writes == 1).all())
    assert torch.equal(got, terngrad_pack_plain(x, k0, k1, scale))


def _shapes(case):
    if case == "resnet9_layerwise":
        return _resnet9_layerwise_shapes()
    return [(1 + i % 3, 17 + 61 * i) for i in range(40)]


@pytest.mark.parametrize("case", ["resnet9_layerwise", "40_buckets"])
def test_bucket_table_at_width_2(case):
    from repro_torch.kernels.qsgd import (MAX_BUCKETS, TILE_PAIRS,
                                          bucket_table)
    from repro_torch.kernels.ref import words_per_unit
    shapes = _shapes(case)
    tables = bucket_table(shapes, 2)
    assert len(tables) == math.ceil(len(shapes) / MAX_BUCKETS)
    for g, t in enumerate(tables):
        group = shapes[g * MAX_BUCKETS:(g + 1) * MAX_BUCKETS]
        assert t.wpu == tuple(math.ceil(d / 16) for _, d in group)
        assert t.wpu == tuple(words_per_unit(d, 2) for _, d in group)
        assert t.tiles == tuple(math.ceil(math.ceil(d / 2) / TILE_PAIRS)
                                for _, d in group)
        starts, blocks = _prefix([n * k for (n, _), k in zip(group,
                                                              t.tiles)])
        assert t.block_start == tuple(starts) and t.blocks == blocks


def _check_grouped(shapes, seed, against_pallas):
    """terngrad_pack_buckets over `shapes` in one call against the plain
    twin per bucket and, for the buckets `against_pallas` picks, the
    reference's Pallas pack in interpret mode on the same scales."""
    from repro_torch.kernels.terngrad import (terngrad_pack_buckets,
                                              terngrad_pack_plain)
    ins = [_inputs(n, d, seed + i) for i, (n, d) in enumerate(shapes)]
    kws = [_key_words(keys) for _, _, keys in ins]
    got = terngrad_pack_buckets([x for x, _, _ in ins],
                                [k0 for k0, _ in kws], [k1 for _, k1 in kws],
                                [s for _, s, _ in ins])
    assert len(got) == len(shapes)
    for g, (x, s, _), (k0, k1) in zip(got, ins, kws):
        assert torch.equal(g, terngrad_pack_plain(x, k0, k1, s))
    with reference() as ref:
        for i in against_pallas:
            x, s, keys = ins[i]
            want = _pallas_pack(ref, "terngrad", x.numpy(), keys, s.numpy())
            assert np.array_equal(want, np_bits(got[i]))


@pytest.mark.parametrize("d", EDGE_DIMS)
def test_terngrad_pack_buckets_match_plain_and_pallas_at_edges(d):
    _check_grouped([(2, d), (3, 33), (1, 2 * d + 1)], seed=10 * d,
                   against_pallas=(0, 2))


@pytest.mark.parametrize("case", ["resnet9_layerwise", "40_buckets"])
def test_terngrad_pack_buckets_match_plain_and_pallas(case):
    shapes = _shapes(case)
    if case == "resnet9_layerwise":   # one worker's units: n / 4 a bucket
        shapes = [(n // 4, d) for n, d in shapes]
    _check_grouped(shapes, seed=len(shapes),
                   against_pallas=range(0, len(shapes), 3))


def test_terngrad_pack_units_buckets_match_per_bucket_and_reference():
    from repro_torch.kernels import ops
    dims = [1, 2, 3, 31, 65, 513, 1025, 4608]
    ins = [_inputs(2 + i % 3, d, seed=d, specials=False)
           for i, d in enumerate(dims)]
    got = ops.terngrad_pack_units_buckets([x for x, _, _ in ins],
                                          [tkeys(k) for _, _, k in ins])
    assert len(got) == len(dims)
    with reference() as ref:
        for (w, s), (x, _, k) in zip(got, ins):
            ww, ws = ops.terngrad_pack_units(x, tkeys(k))
            assert torch.equal(w, ww) and torch.equal(s, ws)
            jw, js = ref.ops.terngrad_pack_units(jnp.asarray(x.numpy()),
                                                 jnp.asarray(k))
            assert np.array_equal(np.asarray(js), s.numpy())
            assert np.array_equal(np.asarray(jw), np_bits(w))


def test_grouped_terngrad_pack_routes_cpu_and_keeps_empty_buckets():
    from repro_torch import kernels
    from repro_torch.kernels import ops
    from repro_torch.kernels import terngrad as T
    kernels.reset_launch_counts()
    xs = [torch.ones((2, 5)), torch.zeros((0, 7)), torch.ones((3, 0))]
    ks = [torch.zeros((x.shape[0],), dtype=torch.int32) for x in xs]
    scs = [torch.ones((x.shape[0],)) for x in xs]
    outs = T.terngrad_pack_buckets(xs, ks, ks, scs)
    assert [tuple(o.shape) for o in outs] == [(2, 1), (0, 1), (3, 0)]
    assert torch.equal(outs[0], T.terngrad_pack_plain(xs[0], ks[0], ks[0],
                                                      scs[0]))
    assert T.terngrad_pack_buckets([], [], [], []) == []
    assert ops.terngrad_pack_units_buckets([], []) == []
    assert kernels.launch_counts()["terngrad_pack"] == 0


def test_terngrad_codec_encode_buckets_match_per_bucket_and_reference():
    from repro_torch import random as R
    from repro_torch.core.compressors import TernGrad
    from repro_torch.core.wire import wire_codec
    dims = [1, 33, 481, 2049]
    xs = [_inputs(1 + i % 3, d, seed=40 + i, specials=False)[0]
          for i, d in enumerate(dims)]
    ks = [R.fold_in(R.key(3)[None], torch.arange(x.shape[0]) + 10 * i)
          for i, x in enumerate(xs)]
    codec = wire_codec(TernGrad())
    assert codec.fused
    got = codec.encode_buckets(xs, ks)
    with reference() as ref:
        jcodec = ref.core.wire_codec(ref.core.TernGrad())
        for g, x, k in zip(got, xs, ks):
            assert torch.equal(g, codec.encode_batch(x, k))
            assert torch.equal(g, wire_codec(TernGrad(), fused=False)
                               .encode_batch(x, k))
            jb = jcodec.encode_batch(jnp.asarray(x.numpy()),
                                     jnp.asarray(k.numpy().astype(np.uint32)))
            assert np.array_equal(np.asarray(jb), g.numpy())


@pytest.mark.parametrize("ef", [False, True], ids=["plain", "ef"])
@pytest.mark.parametrize("fusion", sorted(FUSIONS))
def test_terngrad_schedule_step_through_grouped_pack(fusion, ef):
    from repro_torch import random as R
    from repro_torch.core.compressors import TernGrad
    from repro_torch.core.wire import (execute_schedule_wire,
                                       execute_schedule_wire_with_state,
                                       wire_codec)
    g = _grads(RESNET9_SHAPES, seed=23 + len(fusion), dyadic=False)
    m = _grads(RESNET9_SHAPES, seed=29, dyadic=False)
    tg = _to_torch(g)
    sched = _port_schedule(tg, "layerwise", FUSIONS[fusion])
    codec = wire_codec(TernGrad())
    wk = lambda k: R.fold_in(k, 2)  # noqa: E731
    if ef:
        tree, mtree, bufs = execute_schedule_wire_with_state(
            sched, codec, tg, _to_torch(m), R.key(6), wire_key=wk)
    else:
        tree, bufs = execute_schedule_wire(sched, codec, tg, R.key(6),
                                           wire_key=wk)
    with reference() as ref:
        jg, jm = _to_jax(g), _to_jax(m)
        jplan = ref.core.build_plan(jg, ref.core.stacked_mask(jg),
                                    ref.core.Granularity("layerwise"))
        jsched = ref.core.build_schedule(jplan, FUSIONS[fusion])
        jcodec = ref.core.wire_codec(ref.core.TernGrad())
        jwk = lambda k: jax.random.fold_in(k, 2)  # noqa: E731
        if ef:
            jtree, jmtree, jbufs = jsched.execute_with_state(
                None, jg, jm, jkey(6), wire=jcodec, wire_key=jwk)
            _assert_trees_bitwise(jmtree, mtree)
        else:
            jtree, jbufs = jax.jit(lambda g, k: jsched.execute(
                None, g, k, wire=jcodec, wire_key=jwk))(jg, jkey(6))
        assert len(jbufs) == len(bufs) == sched.num_messages
        for jb, tb in zip(jbufs, bufs):
            assert np.array_equal(np.asarray(jb), tb.numpy())
        _assert_trees_bitwise(jtree, tree)
