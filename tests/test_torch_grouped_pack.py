"""The grouped, hash-once QSGD pack (csrc/qsgd.cu qsgd_pack_buckets) and the
16-byte RMSNorm launch (csrc/rmsnorm.cu), in what the CPU can hold:

  - prng.uniform_pairs (one hash per counter pair, both outputs) equals
    prng.uniform_at at every position;
  - a plain mirror of the pack kernel's work split (csrc/hash_pack.cuh:
    tiles of 480 pairs and a halo chunk, lower / upper / mixed 32-position
    chunks) writes every output word exactly once and equals
    qsgd_pack_plain bit for bit,
    including d = 1, 2, 3, odd d, h = 32k +- 1 and tile edges;
  - bucket_table's block prefix sums and words per unit, one table per
    MAX_BUCKETS buckets;
  - ops.qsgd_pack_units_buckets equals per-bucket ops.qsgd_pack_units and
    the reference's ops.qsgd_pack_units(use_pallas=False) bitwise on
    dyadic inputs (norm-exact: see test_torch_kernels.py);
  - execute_schedule_wire(_with_state) QSGD buffers, trees and EF
    residuals, through WireCodec.encode_buckets, equal the reference's at
    fusion {per-bucket, 64 KiB, one message}, with and without a wire key;
  - RMSNorm's launch plan and its alignment check.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_ref import jkey, np_bits, reference, tkeys
from test_torch_wire import (FUSIONS, RESNET9_SHAPES, _assert_trees_bitwise,
                             _grads, _port_schedule, _to_jax, _to_torch)

PAIR_DIMS = [1, 2, 3, 31, 32, 33, 63, 64, 65, 511, 513, 1025, 65537]
# beside PAIR_DIMS: h = ceil(d/2) = 32k - 1 (61, 62) and tile edges
# (h = 479, 480, 481, 960, 961 pairs; kernels/qsgd.py TILE_PAIRS = 480)
MIRROR_DIMS = PAIR_DIMS[:-1] + [61, 62, 957, 959, 960, 961, 962, 1919,
                                1921]
WIDTH_LEVELS = [(2, 1), (4, 4), (6, 16), (8, 64)]


def _inputs(n, d, seed, dyadic=False):
    rng = np.random.default_rng(seed)
    if dyadic:
        x = rng.choice(np.float32([0, .25, -.25, .5, -.5, 1, -1, 2, -2]),
                       (n, d))
    else:
        x = rng.standard_normal((n, d))
        x[:, ::7] = 0.0
    keys = rng.integers(0, 2**32, (n, 2), dtype=np.uint64).astype(np.uint32)
    return torch.from_numpy(x.astype(np.float32)), keys


def _key_words(keys):
    kw = torch.from_numpy(np.ascontiguousarray(keys).view(np.int32))
    return kw[:, 0].contiguous(), kw[:, 1].contiguous()


@pytest.mark.parametrize("d", PAIR_DIMS)
def test_uniform_pairs_equal_uniform_at(d):
    from repro_torch.kernels import prng
    _, keys = _inputs(3, 1, seed=d)
    k = tkeys(keys)
    k0, k1 = k[:, :1], k[:, 1:]
    h = -(-d // 2)
    j = torch.arange(h)[None, :]
    u0, u1 = prng.uniform_pairs(k0, k1, j, d)
    pos = torch.arange(d)[None, :]
    want = prng.uniform_at(k0, k1, pos, d)
    assert torch.equal(u0.view(torch.int32), want[:, :h].view(torch.int32))
    assert torch.equal(u1[:, :d - h].view(torch.int32),
                       want[:, h:].view(torch.int32))


def _mirror_pack(x, k0, k1, width, code):
    """csrc/hash_pack.cuh's tile walk (the QSGD and TernGrad packs), block
    by block: each tile hashes pairs [480 t, 480 t + 512) once, then writes
    its lower chunks, the mixed chunk (hashed per position) and its upper
    chunks; code(unit, x, u) gives the codes of `width` bits. Returns the
    words (as the pack's plain twin) and how often each word was
    written."""
    from repro_torch.kernels import prng, ref
    from repro_torch.kernels.qsgd import TILE_PAIRS, pack_tiles
    n, d = x.shape
    h = -(-d // 2)
    wpu = ref.words_per_unit(d, width)
    out = torch.zeros((n, wpu), dtype=torch.int64)
    writes = torch.zeros((n, wpu), dtype=torch.int64)
    kw0, kw1 = ref.words_from_i32(k0), ref.words_from_i32(k1)

    def codes(unit, pos, u):
        xv = x[unit, pos.clamp(max=d - 1)]
        return torch.where(pos < d, code(unit, xv, u), 0)

    def store(unit, q, chunk):
        words = ref.pack_fields_tile(chunk[None], width)[0]
        for t in range(width):
            if q * width + t < wpu:
                out[unit, q * width + t] = words[t]
                writes[unit, q * width + t] += 1

    for unit in range(n):
        for tile in range(pack_tiles(d)):
            j0 = tile * TILE_PAIRS
            j = torch.arange(j0, j0 + TILE_PAIRS + 32)
            u0, u1 = prng.uniform_pairs(kw0[unit], kw1[unit], j, d)
            lo = torch.where(j < h, codes(unit, j, u0), 0)
            hi = torch.where(j < h, codes(unit, j + h, u1), 0)
            for c in range(TILE_PAIRS // 32):
                q = tile * TILE_PAIRS // 32 + c
                if 32 * q + 32 <= h:
                    store(unit, q, lo[32 * c:32 * c + 32])
                elif 32 * q < h:
                    p = torch.arange(32 * q, 32 * q + 32)
                    u = prng.uniform_at(kw0[unit], kw1[unit], p, d)
                    store(unit, q, codes(unit, p, u))
            q0 = -(-(j0 + h) // 32)
            for c in range(TILE_PAIRS // 32):
                q = q0 + c
                if 32 * q < d:
                    o = 32 * q - h - j0
                    store(unit, q, hi[o:o + 32])
    return ref.words_to_i32(out), writes


@pytest.mark.parametrize("width,levels", WIDTH_LEVELS)
@pytest.mark.parametrize("d", MIRROR_DIMS)
def test_pack_work_split_writes_each_word_once(d, width, levels):
    from repro_torch.kernels.qsgd import qsgd_pack_plain
    x, keys = _inputs(2, d, seed=d + width)
    k0, k1 = _key_words(keys)
    nrm = torch.linalg.vector_norm(x, dim=1) + 1e-12
    from repro_torch.kernels.ref import qsgd_codes_ref
    got, writes = _mirror_pack(x, k0, k1, width, lambda unit, xv, u:
                               qsgd_codes_ref(xv, u, nrm[unit], levels))
    assert bool((writes == 1).all())
    assert torch.equal(got, qsgd_pack_plain(x, k0, k1, nrm, levels, width))


def _resnet9_layerwise_shapes():
    from repro_torch.core.granularity import Granularity, stacked_mask
    from repro_torch.core.plan import build_plan
    tree = {k: torch.zeros(s) for k, s in RESNET9_SHAPES.items()}
    plan = build_plan(tree, stacked_mask(tree), Granularity("layerwise"))
    return [(4 * b.n, b.dim) for b in plan.buckets]


def _prefix(values):
    out, acc = [], 0
    for v in values:
        out.append(acc)
        acc += v
    return out, acc


@pytest.mark.parametrize("case", ["resnet9_layerwise", "over_max_buckets"])
def test_bucket_table(case):
    from repro_torch.kernels.qsgd import (MAX_BUCKETS, TILE_PAIRS,
                                          bucket_table, pack_tiles)
    from repro_torch.kernels.ref import words_per_unit
    if case == "resnet9_layerwise":
        shapes = _resnet9_layerwise_shapes()
        assert len(shapes) == 11
        groups = [shapes]
    else:
        shapes = [(1 + i % 5, 1 + 37 * i) for i in range(2 * MAX_BUCKETS
                                                         + 6)]
        groups = [shapes[:MAX_BUCKETS], shapes[MAX_BUCKETS:2 * MAX_BUCKETS],
                  shapes[2 * MAX_BUCKETS:]]
    width = 6
    tables = bucket_table(shapes, width)
    assert len(tables) == len(groups)
    for t, group in zip(tables, groups):
        assert t.n == tuple(n for n, _ in group)
        assert t.d == tuple(d for _, d in group)
        assert t.wpu == tuple(words_per_unit(d, width) for _, d in group)
        assert t.tiles == tuple(math.ceil(math.ceil(d / 2) / TILE_PAIRS)
                                for _, d in group)
        assert t.tiles == tuple(pack_tiles(d) for _, d in group)
        starts, blocks = _prefix([n * k for (n, _), k in zip(group,
                                                              t.tiles)])
        assert t.block_start == tuple(starts) and t.blocks == blocks


@pytest.mark.parametrize("width,levels", WIDTH_LEVELS)
def test_pack_units_buckets_match_per_bucket_and_reference(width, levels):
    from repro_torch.kernels import ops
    dims = [1, 2, 3, 31, 65, 513, 1025, 4608]
    xs, keys = zip(*[_inputs(2 + i % 3, d, seed=d * 7 + width, dyadic=True)
                     for i, d in enumerate(dims)])
    got = ops.qsgd_pack_units_buckets(list(xs), [tkeys(k) for k in keys],
                                      levels, width)
    assert len(got) == len(dims)
    with reference() as ref:
        for (w, nrm), x, k in zip(got, xs, keys):
            ww, wn = ops.qsgd_pack_units(x, tkeys(k), levels, width)
            assert torch.equal(w, ww) and torch.equal(nrm, wn)
            jw, jn = ref.ops.qsgd_pack_units(jnp.asarray(x.numpy()),
                                             jnp.asarray(k), levels, width,
                                             use_pallas=False)
            assert np.array_equal(np.asarray(jn), nrm.numpy())
            assert np.array_equal(np.asarray(jw), np_bits(w))


def test_grouped_pack_routes_cpu_and_keeps_empty_buckets():
    from repro_torch import kernels
    from repro_torch.kernels import qsgd as Q
    kernels.reset_launch_counts()
    xs = [torch.ones((2, 5)), torch.zeros((0, 7)), torch.ones((3, 0))]
    ks = [torch.zeros((x.shape[0],), dtype=torch.int32) for x in xs]
    nrms = [torch.ones((x.shape[0],)) for x in xs]
    outs = Q.qsgd_pack_buckets(xs, ks, ks, nrms, 16, 6)
    assert [tuple(o.shape) for o in outs] == [(2, 1), (0, 2), (3, 0)]
    assert Q.qsgd_pack_buckets([], [], [], [], 16, 6) == []
    assert kernels.launch_counts()["qsgd_pack"] == 0


@pytest.mark.parametrize("ef", [False, True], ids=["plain", "ef"])
@pytest.mark.parametrize("keyed", [False, True], ids=["key", "wire_key"])
@pytest.mark.parametrize("fusion", sorted(FUSIONS))
def test_qsgd_schedule_buffers_through_encode_buckets(fusion, keyed, ef):
    from repro_torch import random as R
    from repro_torch.core.compressors import QSGD
    from repro_torch.core.wire import (execute_schedule_wire,
                                       execute_schedule_wire_with_state,
                                       wire_codec)
    g = _grads(RESNET9_SHAPES, seed=5 + len(fusion), dyadic=True)
    m = _grads(RESNET9_SHAPES, seed=9, dyadic=True)
    tg = _to_torch(g)
    sched = _port_schedule(tg, "layerwise", FUSIONS[fusion])
    codec = wire_codec(QSGD(levels=16))
    wk = (lambda k: R.fold_in(k, 3)) if keyed else None
    if ef:
        tree, mtree, bufs = execute_schedule_wire_with_state(
            sched, codec, tg, _to_torch(m), R.key(4), wire_key=wk)
    else:
        tree, bufs = execute_schedule_wire(sched, codec, tg, R.key(4),
                                           wire_key=wk)
    with reference() as ref:
        jg, jm = _to_jax(g), _to_jax(m)
        jplan = ref.core.build_plan(jg, ref.core.stacked_mask(jg),
                                    ref.core.Granularity("layerwise"))
        jsched = ref.core.build_schedule(jplan, FUSIONS[fusion])
        jcodec = ref.core.wire_codec(ref.core.QSGD(levels=16))
        jwk = (lambda k: jax.random.fold_in(k, 3)) if keyed else None
        if ef:
            # eagerly: under jit XLA's CPU backend contracts the residual
            # e - (code - s) * fac into an fma (the reference's
            # ops.qsgd_unpack_ef_units says so), eagerly it rounds twice
            # as the port does
            jtree, jmtree, jbufs = jsched.execute_with_state(
                None, jg, jm, jkey(4), wire=jcodec, wire_key=jwk)
            _assert_trees_bitwise(jmtree, mtree)
        else:
            jtree, jbufs = jax.jit(lambda g, k: jsched.execute(
                None, g, k, wire=jcodec, wire_key=jwk))(jg, jkey(4))
        assert len(jbufs) == len(bufs) == sched.num_messages
        for jb, tb in zip(jbufs, bufs):
            assert np.array_equal(np.asarray(jb), tb.numpy())
        _assert_trees_bitwise(jtree, tree)


def test_encode_buckets_defaults_to_encode_batch():
    from repro_torch import random as R
    from repro_torch.core.compressors import QSGD, TernGrad
    from repro_torch.core.wire import wire_codec
    xs = [torch.randn((3, 40), generator=torch.Generator().manual_seed(i))
          for i in range(3)]
    ks = [R.fold_in(R.key(1)[None], torch.arange(3) + 10 * i)
          for i in range(3)]
    for codec in (wire_codec(QSGD(levels=16)),
                  wire_codec(QSGD(levels=16), fused=False),
                  wire_codec(TernGrad())):
        got = codec.encode_buckets(xs, ks)
        for g, x, k in zip(got, xs, ks):
            assert torch.equal(g, codec.encode_batch(x, k))


@pytest.mark.parametrize("D,elt,want", [
    (3072, 2, ("registers", 128, 3)), (3072, 4, ("registers", 128, 6)),
    (128, 2, ("registers", 32, 1)), (128, 4, ("registers", 32, 1)),
    (8192, 4, ("registers", 256, 8)), (32768, 2, ("registers", 512, 8)),
    (65536, 2, ("looped", 512, 0)), (16384, 4, ("registers", 512, 8)),
    (16512, 4, ("looped", 512, 0))])
def test_rmsnorm_launch_plan(D, elt, want):
    from repro_torch.kernels.rmsnorm import launch_plan
    variant, threads, vpt = launch_plan(D, elt)
    assert (variant, threads, vpt) == want
    nvec = D * elt // 16
    if vpt:
        assert threads % 32 == 0 and threads * vpt >= nvec


def test_rmsnorm_alignment_check_raises_on_a_misaligned_view():
    from repro_torch.kernels.rmsnorm import check_aligned
    base = torch.zeros(3 * 128 + 8, dtype=torch.bfloat16)
    check_aligned(base[:384].view(3, 128), "x")
    check_aligned(base[8:].view(3, 128), "x")         # 16 bytes in
    with pytest.raises(ValueError, match="16-byte aligned"):
        check_aligned(base[1:385].view(3, 128), "x")  # 2 bytes in
    g = torch.zeros(130)
    with pytest.raises(ValueError, match="storage offset 1"):
        check_aligned(g[1:129], "gamma")
