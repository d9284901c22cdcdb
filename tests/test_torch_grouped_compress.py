"""The grouped compress-only QSGD / TernGrad kernels (csrc/compress.cu
qsgd_compress_buckets / terngrad_compress_buckets: one pair walk, the
uniforms drawn in the kernel over each unit's draw length), in what the
CPU can hold:

  - a plain mirror of the pair walk (blocks of 256 threads taking 1 or 4
    counter pairs each; pair j gives position j and, where j + h < d,
    position j + h; at 4 a thread, 16-byte vectors where d % 4 == 0 and
    the rows are aligned, else 4-byte accesses) writes every position
    below d exactly once and equals the plain twins bitwise at the edge
    dimensions, at both draw granules (a UnitPlan unit's 512 and a whole
    input's 131,072), on inputs holding +-0.0, a NaN and a unit whose
    statistic is 0; the walk a call takes (1 a thread while its pairs fit
    in one wave of the card's resident threads, else 4);
  - the grouped table for the 11 resnet9 layerwise buckets (one launch)
    and for 40 buckets (two), with each bucket's draw length as the C
    entry point's last row of sizes;
  - qsgd_compress_buckets / terngrad_compress_buckets on the CPU equal
    the plain twin per bucket and the one-bucket calls, and, through
    ops.qsgd_compress_units / terngrad_compress_units, the reference's
    interpret-mode qsgd_pallas_rows / terngrad_pallas_rows bitwise
    (QSGD on dyadic inputs, whose norms are exact in any summation order;
    on random inputs QSGD holds tests/test_torch_compress.py's stated
    tolerance);
  - the whole-input route (one unit of d elements, one key, a (1,)
    statistic) bitwise equal to the reference's ops.qsgd_compress /
    terngrad_compress, and plan_compress on resnet9's gradient shapes
    bitwise equal to the reference's;
  - the card-side input checks, and empty buckets.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_compress import DYADIC, assert_bitwise, assert_qsgd_close
from test_torch_grouped_pack import (_key_words, _prefix,
                                     _resnet9_layerwise_shapes)
from test_torch_ref import jkey, key_data, reference, tkeys

UNIT_GRANULE, WHOLE_GRANULE = 512, 131072
# min(d, h) on both sides of the 256- and 1,024-pair tiles and of h = N /
# 2, with d % 4 != 0 beside d % 4 == 0
EDGE_DIMS = [1, 2, 3, 255, 256, 257, 511, 512, 513, 1023, 1024, 1025, 2047,
             2048, 2049, 2303, 65537]
LEVELS = 16


def _draw(d, granule):
    return granule * -(-d // granule)


def _inputs(n, d, seed, dyadic=False, specials=False):
    """Seeded (n, d) f32 units (every 7th entry 0), uint32 keys (n, 2) and
    the key words. Under `specials`: -0.0 entries, one NaN, and the last
    unit all zeros (statistic 0) when n > 1."""
    rng = np.random.default_rng(seed)
    x = (rng.choice(DYADIC, (n, d)) if dyadic
         else rng.standard_normal((n, d))).astype(np.float32)
    x[:, ::7] = 0.0
    if specials:
        x[:, 3::11] = -0.0
        x[0, min(5, d - 1)] = np.nan
        if n > 1:
            x[-1] = 0.0
    keys = rng.integers(0, 2**32, (n, 2), dtype=np.uint64).astype(np.uint32)
    return torch.from_numpy(x), keys


def _stats(x, kind):
    """Each unit's statistic over its finite entries (a NaN entry leaves it
    finite): l2 norm for QSGD, max|x| for TernGrad."""
    f = torch.nan_to_num(x, nan=0.0)
    if kind == "qsgd":
        return torch.linalg.vector_norm(f, dim=1)
    return f.abs().amax(dim=1)


def _quant(kind):
    """The kernel's arithmetic on gathered entries of one unit."""
    from repro_torch.kernels import ref
    if kind == "qsgd":
        return lambda xv, u, s: ref.qsgd_ref(xv, u, s, LEVELS)
    return ref.terngrad_ref


def _plain(kind, xs, k0s, k1s, stats, draws):
    from repro_torch.kernels import qsgd as Q
    from repro_torch.kernels import terngrad as T
    if kind == "qsgd":
        return Q.qsgd_compress_buckets_plain(xs, k0s, k1s, stats, draws,
                                             LEVELS)
    return T.terngrad_compress_buckets_plain(xs, k0s, k1s, stats, draws)


def _grouped(kind, xs, k0s, k1s, stats, draws):
    from repro_torch.kernels import qsgd as Q
    from repro_torch.kernels import terngrad as T
    if kind == "qsgd":
        return Q.qsgd_compress_buckets(xs, k0s, k1s, stats, draws, LEVELS)
    return T.terngrad_compress_buckets(xs, k0s, k1s, stats, draws)


def _one(kind, x, k0, k1, stat, draw):
    from repro_torch.kernels import qsgd as Q
    from repro_torch.kernels import terngrad as T
    if kind == "qsgd":
        return Q.qsgd_compress_rows(x, k0, k1, stat, draw, LEVELS)
    return T.terngrad_compress_rows(x, k0, k1, stat, draw)


def _same(a, b):
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def _mirror_compress(x, k0, k1, stat, draw, quant, per_thread, aligned):
    """csrc/compress.cu's pair walk, block by block: each tile of 256 *
    per_thread pairs, each of its 256 threads taking per_thread pairs
    (consecutive on the 16-byte path, 256 apart otherwise), hashed once
    each; position j from u0, position j + h from u1 where j + h < d.
    Returns the output and how often each position was written."""
    from repro_torch.kernels import prng, ref
    from repro_torch.kernels.qsgd import COMPRESS_THREADS, compress_tiles
    n, d = x.shape
    h = draw // 2
    pairs = min(d, h)
    vec = per_thread == 4 and d % 4 == 0 and h % 4 == 0 and aligned
    out = torch.zeros_like(x)
    writes = torch.zeros((n, d), dtype=torch.int64)
    kw0, kw1 = ref.words_from_i32(k0), ref.words_from_i32(k1)
    tid = torch.arange(COMPRESS_THREADS)[:, None]
    r = torch.arange(per_thread)[None, :]
    for unit in range(n):
        for tile in range(compress_tiles(d, draw, per_thread)):
            j0 = tile * COMPRESS_THREADS * per_thread
            j = j0 + (4 * tid + r if vec else tid + 256 * r)
            u0, u1 = prng.uniform_pairs(kw0[unit], kw1[unit], j, draw)
            lo = j < pairs
            hi = lo & (j + h < d)
            if vec:   # a thread's 4 positions: 16-byte aligned, all or none
                assert bool((j[:, 0] % 4 == 0).all())
                assert bool((lo.all(1) | ~lo.any(1)).all())
                assert bool((hi.all(1) | ~hi.any(1)).all())
            for mask, pos, u in ((lo, j, u0), (hi, j + h, u1)):
                p = pos[mask]
                out[unit, p] = quant(x[unit, p], u[mask], stat[unit])
                writes[unit].index_add_(0, p, torch.ones_like(p))
    return out, writes


@pytest.mark.parametrize("granule", [UNIT_GRANULE, WHOLE_GRANULE],
                         ids=["unit", "whole"])
@pytest.mark.parametrize("d", EDGE_DIMS)
def test_pair_walk_writes_each_position_once(d, granule):
    draw = _draw(d, granule)
    x, keys = _inputs(3, d, seed=d + granule, specials=True)
    k0, k1 = _key_words(keys)
    walks = [(1, True), (4, True)] + ([(4, False)] if d % 4 == 0 else [])
    for kind in ("qsgd", "terngrad"):
        stat = _stats(x, kind)
        want = _plain(kind, [x], [k0], [k1], [stat], [draw])[0]
        for per_thread, aligned in walks:
            got, writes = _mirror_compress(x, k0, k1, stat, draw,
                                           _quant(kind), per_thread, aligned)
            assert bool((writes == 1).all()), (kind, per_thread, aligned)
            assert _same(got, want), (kind, per_thread, aligned)


def test_walk_by_pairs_a_call(monkeypatch):
    """1 pair a thread while a call's pairs fit in the card's resident
    threads, 4 beyond; the tiles follow."""
    from repro_torch.kernels import qsgd as Q
    monkeypatch.setattr(Q, "_resident_threads", lambda device: 132 * 2048)
    assert Q.compress_walk(132 * 2048, "cuda") == 1
    assert Q.compress_walk(132 * 2048 + 1, "cuda") == 4
    assert Q.compress_walk(0, "cuda") == 1
    # resnet9: layerwise 61,050 pairs; a whole input of 2^20, 524,288
    assert Q.compress_walk(61050, "cuda") == 1
    assert Q.compress_walk(524288, "cuda") == 4
    assert Q.compress_tiles(121002, 121344, 1) == 237
    assert Q.compress_tiles(121002, 121344, 4) == 60
    assert Q.compress_tiles(1, 131072, 4) == 1


def test_plain_draw_is_the_reference_draw():
    """compress_noise row i is jax.random.uniform(key_i, (N,))[:d]."""
    from repro_torch.kernels.qsgd import compress_noise
    _, keys = _inputs(3, 1, seed=4)
    k0, k1 = _key_words(keys)
    for d, draw in ((1, 512), (513, 1024), (700, 131072)):
        got = compress_noise(k0, k1, d, draw).numpy()
        with reference():
            want = np.stack([np.asarray(jax.random.uniform(
                jax.random.wrap_key_data(jnp.asarray(k)), (draw,)))[:d]
                for k in keys])
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def _shapes(case):
    if case == "resnet9_layerwise":   # one worker's units: n / 4 a bucket
        return [(n // 4, d) for n, d in _resnet9_layerwise_shapes()]
    return [(1 + i % 3, 17 + 61 * i) for i in range(40)]


@pytest.mark.parametrize("per_thread", [1, 4])
@pytest.mark.parametrize("granule", [UNIT_GRANULE, WHOLE_GRANULE],
                         ids=["unit", "whole"])
@pytest.mark.parametrize("case", ["resnet9_layerwise", "40_buckets"])
def test_compress_table(case, granule, per_thread):
    from repro_torch.kernels.qsgd import (MAX_BUCKETS, _launches,
                                          compress_tiles, grouped_table)
    shapes = _shapes(case)
    if case == "resnet9_layerwise":
        assert len(shapes) == 11
    full = [(n, d, _draw(d, granule), per_thread) for n, d in shapes]
    tables = grouped_table(full, 32, compress_tiles)
    assert len(tables) == math.ceil(len(shapes) / MAX_BUCKETS)
    draws = tuple(s[2] for s in full)
    sizes = _launches(tuple(full), 32, compress_tiles, draws)
    for g, (t, (tt, arr)) in enumerate(zip(tables, sizes)):
        group = full[g * MAX_BUCKETS:(g + 1) * MAX_BUCKETS]
        assert t == tt
        assert t.n == tuple(n for n, _, _, _ in group)
        assert t.d == tuple(d for _, d, _, _ in group)
        assert t.tiles == tuple(
            math.ceil(min(d, N // 2) / (256 * per_thread))
            for _, d, N, _ in group)
        starts, blocks = _prefix([s[0] * k for s, k in zip(group,
                                                           t.tiles)])
        assert t.block_start == tuple(starts) and t.blocks == blocks
        # the C entry point's rows: n, d, wpu, tiles, first block, draw
        c = len(group)
        assert list(arr) == [*t.n, *t.d, *t.wpu, *t.tiles, *t.block_start,
                             *(s[2] for s in group)]
        assert len(arr) == 6 * c


@pytest.mark.parametrize("kind", ["qsgd", "terngrad"])
@pytest.mark.parametrize("case", ["resnet9_layerwise", "40_buckets"])
def test_compress_buckets_match_plain_and_one_bucket_calls(case, kind):
    shapes = _shapes(case)
    ins = [_inputs(n, d, seed=7 * i + d, specials=i % 5 == 0)
           for i, (n, d) in enumerate(shapes)]
    xs = [x for x, _ in ins]
    kws = [_key_words(k) for _, k in ins]
    k0s, k1s = [k[0] for k in kws], [k[1] for k in kws]
    stats = [_stats(x, kind) for x in xs]
    draws = [_draw(d, UNIT_GRANULE) for _, d in shapes]
    got = _grouped(kind, xs, k0s, k1s, stats, draws)
    want = _plain(kind, xs, k0s, k1s, stats, draws)
    assert len(got) == len(shapes)
    for i, (g, w) in enumerate(zip(got, want)):
        assert _same(g, w)
        if i % 7 == 0:
            assert _same(_one(kind, xs[i], k0s[i], k1s[i], stats[i],
                              draws[i]), w)


UNITS_DIMS = [1, 2, 3, 255, 257, 511, 513, 1025, 2049, 2303]


@pytest.mark.parametrize("kind", ["qsgd", "terngrad"])
@pytest.mark.parametrize("d", UNITS_DIMS)
def test_units_match_reference_pallas_rows(d, kind):
    """ops.*_compress_units (the one-bucket grouped call, the uniforms over
    512 * ceil(d / 512)) against the reference's interpret-mode
    qsgd_pallas_rows / terngrad_pallas_rows, bitwise: QSGD on dyadic
    inputs, TernGrad on random inputs with -0.0."""
    from repro_torch.kernels import ops
    n = 1 + d % 3
    x, _ = _inputs(n, d, seed=d, dyadic=kind == "qsgd",
                   specials=kind == "terngrad")
    if kind == "terngrad":
        x = torch.nan_to_num(x, nan=0.0)
    keys = jax.random.split(jkey(d), n)
    tk = tkeys(key_data(keys))
    with reference() as ref:
        if kind == "qsgd":
            want = ref.ops.qsgd_compress_units(jnp.asarray(x.numpy()), keys,
                                               LEVELS, use_pallas=True)
            got = ops.qsgd_compress_units(x, tk, LEVELS)
        else:
            want = ref.ops.terngrad_compress_units(jnp.asarray(x.numpy()),
                                                   keys, use_pallas=True)
            got = ops.terngrad_compress_units(x, tk)
    assert_bitwise(want, got)


def test_units_random_inputs_within_tolerance():
    from repro_torch.kernels import ops
    x, _ = _inputs(3, 2303, seed=11)
    keys = jax.random.split(jkey(11), 3)
    with reference() as ref:
        want = ref.ops.qsgd_compress_units(jnp.asarray(x.numpy()), keys,
                                           LEVELS, use_pallas=True)
    got = ops.qsgd_compress_units(x, tkeys(key_data(keys)), LEVELS)
    assert_qsgd_close(want, got, x.numpy(), LEVELS, axis=1)


@pytest.mark.parametrize("kind", ["qsgd", "terngrad"])
@pytest.mark.parametrize("d", [1, 511, 513, 131071, 131073])
def test_whole_input_is_one_unit(d, kind):
    """ops.qsgd_compress / terngrad_compress as one unit of d elements with
    one key and a (1,) statistic, the uniforms over 131,072 * ceil(d /
    131,072), bitwise equal to the reference's whole-input calls."""
    from repro_torch.kernels import ops
    x, _ = _inputs(1, d, seed=d, dyadic=kind == "qsgd")
    x = x.reshape(-1)
    k = jkey(d + 1)
    with reference() as ref:
        if kind == "qsgd":
            want = ref.ops.qsgd_compress(jnp.asarray(x.numpy()), k, LEVELS,
                                         use_pallas=True)
            got = ops.qsgd_compress(x, tkeys(key_data(k)), LEVELS)
        else:
            want = ref.ops.terngrad_compress(jnp.asarray(x.numpy()), k,
                                             use_pallas=True)
            got = ops.terngrad_compress(x, tkeys(key_data(k)))
    assert got.shape == x.shape
    assert_bitwise(want, got)


@pytest.mark.parametrize("kind", ["qsgd", "terngrad"])
@pytest.mark.parametrize("gran", ["layerwise", "entire_model"])
def test_plan_compress_on_resnet9_shapes(gran, kind):
    """plan_compress over resnet9's gradient shapes (every bucket in one
    grouped call) against the reference's plan_compress (its plain path,
    bitwise equal to its interpret-mode Pallas kernels), bitwise; QSGD on
    dyadic gradients."""
    from repro_torch import random as R
    from repro_torch.convert import tree_leaves, tree_map
    from repro_torch.core.granularity import Granularity, stacked_mask
    from repro_torch.core.plan import build_plan
    from repro_torch.kernels import ops
    from test_torch_wire import RESNET9_SHAPES
    rng = np.random.default_rng(21)
    t = {k: (rng.choice(DYADIC, s) if kind == "qsgd"
             else rng.standard_normal(s)).astype(np.float32)
         for k, s in RESNET9_SHAPES.items()}
    tt = tree_map(torch.from_numpy, t)
    with reference() as ref:
        jt = jax.tree_util.tree_map(jnp.asarray, t)
        jplan = ref.core.build_plan(jt, ref.core.stacked_mask(jt),
                                    ref.core.Granularity(gran))
        want = ref.ops.plan_compress(jplan, jt, jkey(3), kind=kind,
                                     levels=LEVELS, use_pallas=False)
    plan = build_plan(tt, stacked_mask(tt), Granularity(gran))
    got = ops.plan_compress(plan, tt, R.key(3), kind=kind, levels=LEVELS)
    for w, g in zip(jax.tree_util.tree_leaves(want), tree_leaves(got)):
        assert tuple(w.shape) == tuple(g.shape)
        assert_bitwise(w, g)


def test_compress_outputs_check_inputs_and_draws():
    from repro_torch.kernels.qsgd import compress_outputs
    x = torch.zeros((2, 5))
    k = torch.zeros((2,), dtype=torch.int32)
    s = torch.zeros((2,))
    assert compress_outputs([x], [k], [k], [s], [6])[0].shape == (2, 5)
    for draw in (5, 4, 2**31):
        with pytest.raises(ValueError, match="draw"):
            compress_outputs([x], [k], [k], [s], [draw])
    with pytest.raises(ValueError, match="k0"):
        compress_outputs([x], [k.long()], [k], [s], [6])
    with pytest.raises(ValueError, match="stat"):
        compress_outputs([x], [k], [k], [s[:1]], [6])
    with pytest.raises(ValueError, match="contiguous"):
        compress_outputs([torch.zeros((5, 2)).t()], [k], [k], [s], [6])


@pytest.mark.parametrize("kind", ["qsgd", "terngrad"])
def test_compress_buckets_route_cpu_and_keep_empty_buckets(kind):
    from repro_torch import kernels
    kernels.reset_launch_counts()
    xs = [torch.ones((2, 5)), torch.zeros((0, 7)), torch.ones((3, 0))]
    ks = [torch.zeros((x.shape[0],), dtype=torch.int32) for x in xs]
    stats = [torch.ones((x.shape[0],)) for x in xs]
    outs = _grouped(kind, xs, ks, ks, stats, [512, 512, 0])
    assert [tuple(o.shape) for o in outs] == [(2, 5), (0, 7), (3, 0)]
    assert _grouped(kind, [], [], [], [], []) == []
    assert kernels.launch_counts()[f"{kind}_compress_rows"] == 0
