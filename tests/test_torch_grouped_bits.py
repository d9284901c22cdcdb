"""The grouped bit unpack (csrc/bits.cu bits_unpack_buckets), the per-unit
decode of every bucket of a step in one call (WireCodec.decode_rows_buckets)
and the allgather receive leg that calls it, in what the CPU can hold.
Every comparison is bitwise:

  - the bit unpack's tables (kernels/qsgd.py grouped_table over
    bits_tiles): block prefix sums, words and tiles per unit, at the 11
    resnet9 layerwise buckets (one table) and at 40 buckets (two);
  - a plain mirror of the kernel's work split (tiles of 64 words, 2,048
    bits, staged with a zero word past the tile; 16-byte stores of four
    bits from the tile's first 16-byte boundary on, 4-byte stores for the
    up to 3 bits on either side) writes every output bit exactly once,
    stores every vector on a 16-byte boundary, reads nothing past its
    staged words and equals bits_unpack_plain, at d at the chunk and tile
    edges and at every alignment of the output row;
  - bits_unpack_buckets / ops.unpack_words_buckets equal bits_unpack_plain
    per bucket and the reference's unpack_words (unpack_bits_pallas in
    interpret mode, or its jnp oracle), at the edge dimensions, on the 11
    layerwise buckets, on 40 buckets and on views 4 bytes past a 16-byte
    boundary; CPU tensors take the plain twin without a launch;
  - decode_rows_buckets of every codec equals its per-bucket decode_rows,
    and the fused=False decode_buckets / decode_ef_buckets go through it;
  - compressed_allreduce's allgather wire on 2 gloo ranks: the bucket-list
    post gathers every bucket in order, decodes them in ONE
    decode_rows_buckets call, and gives the same trees, collective calls
    and bytes as the per-bucket post.

This module imports no jax at module level (the spawned ranks import it):
the reference comes in inside the tests that need it.
"""
import functools
import itertools
import math

import numpy as np
import pytest
import torch

# chunk edges (1, 31-33), tile edges (2,047-2,049, 4,097) of the
# 2,048-bit tiles, and a unit of 33 tiles
EDGE_DIMS = (1, 31, 32, 33, 2047, 2048, 2049, 4097, 65537)


def _words(n, w, seed):
    """Seeded (n, w) int32 words with every bit pattern possible."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 2**32, (n, w), dtype=np.uint64).astype(np.uint32)
    return torch.from_numpy(a.view(np.int32))


def _shapes(case):
    """The 11 resnet9 layerwise buckets stacked over 4 workers, or 40
    buckets."""
    if case == "resnet9_layerwise":
        from repro_torch.configs.resnet9_cifar import RESNET9
        from repro_torch.core.granularity import Granularity, stacked_mask
        from repro_torch.core.plan import build_plan
        from repro_torch.models.cnn import init_cnn
        from repro_torch.random import key
        p = init_cnn(RESNET9, key(0), device="cpu")
        plan = build_plan(p, stacked_mask(p), Granularity("layerwise"))
        return [(4 * b.n, b.dim) for b in plan.buckets]
    return [(1 + i % 3, 17 + 61 * i) for i in range(40)]


@pytest.mark.parametrize("case", ["resnet9_layerwise", "40_buckets"])
def test_bits_table(case):
    from repro_torch.kernels.pack import TILE_BITS, bits_tiles
    from repro_torch.kernels.qsgd import MAX_BUCKETS, grouped_table
    shapes = _shapes(case)
    tables = grouped_table(shapes, 1, bits_tiles)
    assert len(tables) == math.ceil(len(shapes) / MAX_BUCKETS)
    assert TILE_BITS == 2048
    for g, t in enumerate(tables):
        group = shapes[g * MAX_BUCKETS:(g + 1) * MAX_BUCKETS]
        assert t.n == tuple(n for n, _ in group)
        assert t.wpu == tuple(math.ceil(d / 32) for _, d in group)
        assert t.tiles == tuple(math.ceil(d / 2048) for _, d in group)
        assert t.tiles == tuple(bits_tiles(d) for _, d in group)
        starts = list(itertools.accumulate(
            [n * k for (n, _), k in zip(group, t.tiles)], initial=0))
        assert t.block_start == tuple(starts[:-1])
        assert t.blocks == starts[-1]
    if case == "resnet9_layerwise":             # 68 tiles a worker
        assert len(shapes) == 11
        assert tables[0].blocks == 272


def _mirror_bits_unpack(words, d, base):
    """csrc/bits.cu bits_unpack_kernel, block by block, its output row of
    unit 0 starting `base` int32s past a 16-byte boundary -> (bits as
    bits_unpack_plain gives them, writes per bit)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.pack import TILE_BITS, bits_tiles
    n, wpu = words.shape
    tile_words = TILE_BITS // 32
    out = torch.zeros((n, d), dtype=torch.int64)
    writes = torch.zeros((n, d), dtype=torch.int64)
    w64 = ref.words_from_i32(words)
    for unit in range(n):
        for tile in range(bits_tiles(d)):
            w0 = tile * tile_words
            nw = min(tile_words, wpu - w0)
            staged = torch.zeros(tile_words + 1, dtype=torch.int64)
            staged[:nw] = w64[unit, w0:w0 + nw]
            f0 = tile * TILE_BITS
            nf = min(TILE_BITS, d - f0)
            g = base + unit * d + f0     # int32s past a 16-byte boundary
            head = min(nf, (-g) % 4)
            nv = (nf - head) // 4
            p = head + 4 * torch.arange(nv)
            assert bool(((g + p) % 4 == 0).all())      # aligned vectors
            assert bool(((p >> 5) + 1 <= tile_words).all())
            pair = (staged[(p >> 5) + 1] << 32) | staged[p >> 5]
            q = (pair >> (p & 31)) & 0xF               # the funnel shift
            for j in range(4):
                out[unit, f0 + p + j] = (q >> j) & 1
                writes[unit, f0 + p + j] += 1
            tail = head + 4 * nv
            assert nf - tail <= 3
            for s in list(range(head)) + list(range(tail, nf)):
                out[unit, f0 + s] = (staged[s >> 5] >> (s & 31)) & 1
                writes[unit, f0 + s] += 1
    return out.to(torch.int32), writes


@pytest.mark.parametrize("base", [0, 1, 2, 3])
@pytest.mark.parametrize("d", EDGE_DIMS)
def test_bits_unpack_split_writes_each_bit_once(d, base):
    from repro_torch.kernels.pack import bits_unpack_plain
    from repro_torch.kernels.ref import words_per_unit
    words = _words(3 if d < 4097 else 2, words_per_unit(d, 1), seed=d + base)
    got, writes = _mirror_bits_unpack(words, d, base)
    assert bool((writes == 1).all())
    assert torch.equal(got, bits_unpack_plain(words, d))


def _check_grouped(words_list, dims, pallas_rows):
    """bits_unpack_buckets (and ops.unpack_words_buckets) in one call
    against the plain twin per bucket and the reference's unpack_words per
    row: its Pallas kernel in interpret mode for the `pallas_rows` (bucket,
    row) pairs, its jnp oracle for every row."""
    import jax.numpy as jnp
    from test_torch_ref import reference
    from repro_torch.kernels import ops
    from repro_torch.kernels.pack import bits_unpack_buckets, bits_unpack_plain
    got = bits_unpack_buckets(words_list, dims)
    assert len(got) == len(dims)
    for g, w, d, o in zip(got, words_list, dims,
                          ops.unpack_words_buckets(words_list, dims)):
        assert g.dtype == torch.int32 and tuple(g.shape) == (w.shape[0], d)
        assert torch.equal(g, bits_unpack_plain(w, d))
        assert torch.equal(o, g)
    with reference() as ref:
        for i, (g, w, d) in enumerate(zip(got, words_list, dims)):
            u = w.contiguous().numpy().view(np.uint32)
            for r in range(w.shape[0]):
                want = ref.ops.unpack_words(jnp.asarray(u[r]), d,
                                            use_pallas=(i, r) in pallas_rows)
                assert np.array_equal(np.asarray(want), g[r].numpy())


@pytest.mark.parametrize("d", EDGE_DIMS)
def test_bits_unpack_buckets_match_plain_and_reference_at_edges(d):
    from repro_torch.kernels.ref import words_per_unit
    dims = [d, 33, 2 * d + 1]
    words = [_words(2, words_per_unit(k, 1), seed=d + i)
             for i, k in enumerate(dims)]
    _check_grouped(words, dims, pallas_rows={(0, 0), (0, 1), (2, 0)})


@pytest.mark.parametrize("case", ["resnet9_layerwise", "40_buckets"])
def test_bits_unpack_buckets_match_plain_and_reference(case):
    from repro_torch.kernels.ref import words_per_unit
    shapes = _shapes(case)
    words = [_words(n, words_per_unit(d, 1), seed=i)
             for i, (n, d) in enumerate(shapes)]
    _check_grouped(words, [d for _, d in shapes],
                   pallas_rows={(i, 0) for i in range(0, len(shapes), 4)})


def test_bits_unpack_buckets_on_views_past_a_16_byte_boundary():
    from repro_torch.kernels.ref import words_per_unit
    dims = [1024, 4608, 100, 2049]
    words = []
    for i, d in enumerate(dims):
        w = words_per_unit(d, 1)
        flat = _words(1, 3 * w + 1, seed=90 + i).reshape(-1)
        v = flat[1:].view(3, w)                  # 4 bytes past the base
        assert v.data_ptr() % 16 == (flat.data_ptr() + 4) % 16
        words.append(v)
    _check_grouped(words, dims, pallas_rows={(1, 2)})


def test_grouped_bits_route_cpu_and_keep_empty_buckets():
    from repro_torch import kernels
    from repro_torch.kernels import ops
    from repro_torch.kernels import pack as P
    kernels.reset_launch_counts()
    words = [_words(2, 1, seed=2), torch.zeros((0, 1), dtype=torch.int32),
             torch.zeros((3, 0), dtype=torch.int32)]
    dec = P.bits_unpack_buckets(words, [5, 7, 0])
    assert [tuple(o.shape) for o in dec] == [(2, 5), (0, 7), (3, 0)]
    assert torch.equal(dec[0], P.bits_unpack_plain(words[0], 5))
    assert torch.equal(P.bits_unpack(words[0], 5), dec[0])
    assert P.bits_unpack_buckets([], []) == []
    assert ops.unpack_words_buckets([], []) == []
    assert kernels.launch_counts()["bits_unpack"] == 0


CODECS = ["qsgd", "terngrad", "signsgd", "natural", "topk", "randomk",
          "threshold_v", "identity"]
DIMS = [1, 31, 33, 700, 2049]


def _codec_inputs(name, seed):
    from repro_torch import random as R
    g = torch.Generator().manual_seed(seed)
    xs = [torch.randn((1 + i % 3, d), generator=g)
          for i, d in enumerate(DIMS)]
    ks = [R.fold_in(R.key(seed)[None], torch.arange(x.shape[0]) + 10 * i)
          for i, x in enumerate(xs)]
    es = [torch.randn(x.shape, generator=g) for x in xs]
    return xs, ks, es


def _bitwise(a, b):
    return a.dtype == b.dtype and torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "per_unit"])
@pytest.mark.parametrize("name", CODECS)
def test_decode_rows_buckets_equal_per_bucket_decode_rows(name, fused):
    from repro_torch.core.compressors import make_compressor
    from repro_torch.core.wire import wire_codec
    codec = wire_codec(make_compressor(name), fused=fused)
    xs, ks, es = _codec_inputs(name, seed=len(name))
    pays = codec.encode_buckets(xs, ks)
    rows = codec.decode_rows_buckets(pays, DIMS)
    assert len(rows) == len(DIMS)
    for r, p, d in zip(rows, pays, DIMS):
        assert _bitwise(r, codec.decode_rows(p, d))
        assert _bitwise(r, codec.decode_batch(p, d))
    dec = codec.decode_buckets(pays, DIMS)
    ef = codec.decode_ef_buckets(pays, es, DIMS)
    for r, x, (xe, m), e in zip(rows, dec, ef, es):
        assert _bitwise(x, r) and _bitwise(xe, r)
        assert _bitwise(m, e - r)


# ---- the allgather receive leg on 2 gloo ranks ------------------------------

POST_CODECS = ("qsgd", "terngrad", "signsgd")


def _post_rank(rank, n, dev):
    """Per codec: compressed_allreduce's allgather wire post over a
    layerwise schedule of several buckets, through its bucket-list form and through the
    per-bucket form -> {codec: ([(flat tree as numpy, collective counts)
    of each run], decode_rows_buckets calls, buckets)}."""
    torch.set_num_threads(1)
    from repro_torch import random as R
    from repro_torch.convert import tree_leaves
    from repro_torch.core import collectives, wire
    from repro_torch.core.aggregation import CompressionConfig, _wire_post
    from repro_torch.core.compressors import make_compressor
    from repro_torch.core.granularity import Granularity, stacked_mask
    from repro_torch.core.plan import build_plan
    from repro_torch.core.schedule import build_schedule
    g = torch.Generator().manual_seed(11 + rank)
    tree = {"a": torch.randn((3, 33), generator=g),
            "b": torch.randn((5, 13), generator=g),
            "c": torch.randn((2049,), generator=g)}
    plan = build_plan(tree, stacked_mask(tree), Granularity("layerwise"))
    sched = build_schedule(plan, 0.0)
    out = {}
    for name in POST_CODECS:
        cfg = CompressionConfig(qw=make_compressor(name),
                                strategy="allgather")
        codec = wire.wire_codec(cfg.qw)
        calls = []
        cls = type(codec)
        orig = cls.decode_rows_buckets

        def counted(self, payloads_list, dims, orig=orig, calls=calls):
            calls.append(len(dims))
            return orig(self, payloads_list, dims)
        cls.decode_rows_buckets = counted
        try:
            post = _wire_post(cfg, None, codec)
            assert hasattr(post, "buckets")
            runs = []
            for p in (post, lambda *a: post(*a)):   # bucket-list, per bucket
                collectives.reset_counts()
                t, _ = wire.execute_schedule_wire(
                    sched, codec, tree, R.key(5), p,
                    lambda k: R.fold_in(k, rank), decode_local=False)
                c = collectives.counts()
                runs.append((torch.cat([x.reshape(-1)
                                        for x in tree_leaves(t)]).numpy(),
                             {k: c[k] for k in ("calls", "sent_bytes",
                                                "recv_bytes")}))
        finally:
            cls.decode_rows_buckets = orig
        out[name] = (runs, list(calls), len(plan.buckets))
    return out


@functools.lru_cache(maxsize=None)
def _post_results():
    from repro_torch.launch.mesh import run_ranks
    return run_ranks(_post_rank, 2, backend="gloo", device="cpu",
                     timeout=240)


@pytest.mark.timeout(300)
@pytest.mark.parametrize("name", POST_CODECS)
def test_allgather_post_decodes_a_step_in_one_call(name):
    for res in _post_results():
        (grouped, g_counts), (per_bucket, p_counts) = res[name][0]
        calls, n_buckets = res[name][1], res[name][2]
        assert n_buckets >= 3
        # the bucket-list post: one decode of all five buckets; the
        # per-bucket post: one decode of one bucket each
        assert calls == [n_buckets] + [1] * n_buckets
        assert np.array_equal(grouped.view(np.uint32),
                              per_bucket.view(np.uint32))
        assert g_counts == p_counts and g_counts["calls"] == n_buckets
    a, b = (r[name][0][0][0] for r in _post_results())
    assert np.array_equal(a.view(np.uint32), b.view(np.uint32))
