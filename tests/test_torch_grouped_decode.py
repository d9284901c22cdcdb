"""The grouped TernGrad and signSGD decodes (csrc/terngrad.cu
terngrad_unpack_buckets, csrc/sign.cu sign_unpack_buckets: the unpack tile
walk of csrc/unpack_tile.cuh they share with the QSGD and bit unpacks) and
the fused codecs that call them, in what the CPU can hold. Every
comparison is bitwise:

  - the unpack tables at width 2 (kernels/qsgd.py unpack_table) and width
    1 (grouped_table over kernels/pack.py bits_tiles): block prefix sums,
    words and tiles per unit, at the 11 resnet9 layerwise buckets (one
    table, 272 blocks) and at 40 buckets (two tables);
  - a plain mirror of the shared walk (tiles of 64 chunks of 32 codes,
    64 x width words staged with a zero word past them; 16-byte stores of
    four codes from the tile's first 16-byte output boundary on, four
    codes a funnel shift at width <= 8, extracted one by one above; 4-byte
    stores for the up to 3 codes on either side) writes every output
    element exactly once, stores every vector on a 16-byte boundary, reads
    no staged word past the zero word and equals the plain twins, at the
    TernGrad, signSGD and QSGD widths 2 / 1 / 6 and at width 12, at d at
    the chunk and tile edges and at every alignment of the output row;
  - terngrad_unpack_buckets / sign_unpack_buckets (and ops'
    *_unpack_units_buckets) in one call equal the plain twins per bucket
    and the reference's terngrad_unpack_pallas_rows /
    sign_unpack_pallas_rows in interpret mode, at the edge dimensions, on
    the 11 layerwise buckets, on 40 buckets and on views 4 bytes past a
    16-byte boundary; CPU tensors take the plain twins without a launch,
    and empty buckets are kept;
  - TernGradCodec / SignSGDCodec decode_buckets and decode_ef_buckets,
    fused, equal the per-bucket decode_batch / decode_ef_batch and the
    reference codec's decode_ef_batch (values and EF residuals);
    fused=False routes through decode_rows_buckets and never reaches the
    fused unpack.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_grouped_fields import _words
from test_torch_grouped_pack import _prefix, _resnet9_layerwise_shapes
from test_torch_ref import reference

# chunk edges (1, 2, 31-33) and tile edges (2,047-2,049, 4,097) of the
# 2,048-code tiles, and a unit of 33 tiles (chip_smoke.py GROUPED_EDGE_DIMS)
EDGE_DIMS = (1, 2, 31, 32, 33, 2047, 2048, 2049, 4097, 65537)
# the mirror's codecs: (name, width); width 12 takes the one-by-one
# extraction of codes wider than 8 bits
MIRROR = (("terngrad", 2), ("sign", 1), ("qsgd", 6), ("qsgd", 12))
QSGD_LEVELS = {6: 16, 12: 1024}


def _shapes(case):
    if case == "resnet9_layerwise":
        return _resnet9_layerwise_shapes()
    return [(1 + i % 3, 17 + 61 * i) for i in range(40)]


def _scales(n, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.random(n) * 3 + 0.1).astype(np.float32))


def _bitwise(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


@pytest.mark.parametrize("kernel", ["terngrad_unpack", "sign_unpack"])
@pytest.mark.parametrize("case", ["resnet9_layerwise", "40_buckets"])
def test_tables(case, kernel):
    from repro_torch.kernels.pack import bits_tiles
    from repro_torch.kernels.qsgd import (MAX_BUCKETS, TILE_CODES,
                                          grouped_table, unpack_table,
                                          unpack_tiles)
    from repro_torch.kernels.ref import words_per_unit
    shapes = _shapes(case)
    if kernel == "terngrad_unpack":
        width, tables = 2, unpack_table(shapes, 2)
    else:
        width, tables = 1, grouped_table(shapes, 1, bits_tiles)
    assert TILE_CODES == 2048
    assert len(tables) == math.ceil(len(shapes) / MAX_BUCKETS)
    for g, t in enumerate(tables):
        group = shapes[g * MAX_BUCKETS:(g + 1) * MAX_BUCKETS]
        assert t.n == tuple(n for n, _ in group)
        assert t.d == tuple(d for _, d in group)
        assert t.wpu == tuple(math.ceil(d * width / 32) for _, d in group)
        assert t.wpu == tuple(words_per_unit(d, width) for _, d in group)
        assert t.tiles == tuple(math.ceil(d / 2048) for _, d in group)
        assert t.tiles == tuple(unpack_tiles(d) for _, d in group)
        assert t.tiles == tuple(bits_tiles(d) for _, d in group)
        starts, blocks = _prefix([n * k for (n, _), k in zip(group,
                                                              t.tiles)])
        assert t.block_start == tuple(starts) and t.blocks == blocks
    if case == "resnet9_layerwise":             # 68 tiles a worker
        assert len(shapes) == 11 and tables[0].blocks == 272
    else:
        assert len(tables) == 2


def _emit(name, width, fac):
    """The emit of each instantiation, on int64 codes and a unit's
    factor."""
    if name == "sign":
        return lambda code: torch.where(code == 1, 1.0, -1.0)
    offset = 1 if name == "terngrad" else QSGD_LEVELS[width]
    return lambda code: (code - offset).to(torch.float32) * fac


def _mirror_unpack(words, facs, d, width, base, name):
    """csrc/unpack_tile.cuh unpack_tile, block by block, the output row of
    unit 0 starting `base` 4-byte values past a 16-byte boundary -> (values
    as the plain twin gives them, writes per element)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.qsgd import TILE_CODES, unpack_tiles
    n, wpu = words.shape
    tw = TILE_CODES // 32 * width               # words a whole tile holds
    out = torch.zeros((n, d), dtype=torch.float32)
    writes = torch.zeros((n, d), dtype=torch.int64)
    w64 = ref.words_from_i32(words)
    mask = (1 << width) - 1
    for unit in range(n):
        emit = _emit(name, width, facs[unit])
        for tile in range(unpack_tiles(d)):
            w0 = tile * tw
            nw = min(tw, wpu - w0)
            staged = torch.zeros(tw + 1, dtype=torch.int64)  # + a zero word
            staged[:nw] = w64[unit, w0:w0 + nw]

            def field(p):                       # fields.cuh extract_field
                b = p * width
                assert bool((((b + width - 1) >> 5) <= tw).all())
                lo = staged[b >> 5] >> (b & 31)
                hi = staged[((b >> 5) + 1).clamp(max=tw)] << (32 - (b & 31))
                return torch.where((b & 31) + width > 32, lo | hi, lo) & mask

            f0 = tile * TILE_CODES
            nf = min(TILE_CODES, d - f0)
            g = base + unit * d + f0            # values past a boundary
            head = min(nf, (-g) % 4)
            nv = (nf - head) // 4
            p = head + 4 * torch.arange(nv)
            assert bool(((g + p) % 4 == 0).all())         # aligned vectors
            if width <= 8:                      # one funnel shift
                b = p * width
                assert bool(((b >> 5) + 1 <= tw).all())
                pair = (staged[(b >> 5) + 1] << 32) | staged[b >> 5]
                q = (pair >> (b & 31)) & 0xFFFFFFFF
                codes = [(q >> (j * width)) & mask for j in range(4)]
            else:
                codes = [field(p + j) for j in range(4)]
            for j in range(4):
                out[unit, f0 + p + j] = emit(codes[j])
                writes[unit, f0 + p + j] += 1
            tail = head + 4 * nv
            assert nf - tail <= 3
            s = torch.tensor(list(range(head)) + list(range(tail, nf)),
                             dtype=torch.int64)
            if len(s):
                out[unit, f0 + s] = emit(field(s))
                writes[unit, f0 + s] += 1
    return out, writes


def _plain(name, words, facs, d, width):
    from repro_torch.kernels.qsgd import qsgd_unpack_plain
    from repro_torch.kernels.sign import sign_unpack_plain
    from repro_torch.kernels.terngrad import terngrad_unpack_plain
    if name == "sign":
        return sign_unpack_plain(words, d)
    if name == "terngrad":
        return terngrad_unpack_plain(words, facs, d)
    return qsgd_unpack_plain(words, facs, d, QSGD_LEVELS[width], width)


@pytest.mark.parametrize("base", [0, 1, 2, 3])
@pytest.mark.parametrize("d", EDGE_DIMS)
@pytest.mark.parametrize("name,width", MIRROR,
                         ids=[f"{n}_w{w}" for n, w in MIRROR])
def test_unpack_split_writes_each_element_once(name, width, d, base):
    from repro_torch.kernels.ref import words_per_unit
    n = 3 if d < 4097 else 2
    words = _words(n, words_per_unit(d, width), seed=d + 7 * base + width)
    facs = _scales(n, seed=d)
    got, writes = _mirror_unpack(words, facs, d, width, base, name)
    assert bool((writes == 1).all())
    assert _bitwise(got, _plain(name, words, facs, d, width))


def _check_grouped(words_list, scales, dims, pallas):
    """terngrad_unpack_buckets over (words_list, scales, dims) and
    sign_unpack_buckets over the first ceil(d / 32) words of each row, each
    in one call (and through ops' *_unpack_units_buckets), against the
    plain twins per bucket and, for the buckets `pallas` picks, the
    reference's Pallas unpacks in interpret mode."""
    from repro_torch import kernels
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import words_per_unit
    from repro_torch.kernels.sign import sign_unpack_buckets, sign_unpack_plain
    from repro_torch.kernels.terngrad import (terngrad_unpack_buckets,
                                              terngrad_unpack_plain)
    signs = [w[:, :words_per_unit(d, 1)] for w, d in zip(words_list, dims)]
    kernels.reset_launch_counts()
    tern = terngrad_unpack_buckets(words_list, scales, dims)
    sign = sign_unpack_buckets(signs, dims)
    assert len(tern) == len(sign) == len(dims)
    for t, s, w, sw, sc, d, ot, os_ in zip(
            tern, sign, words_list, signs, scales, dims,
            ops.terngrad_unpack_units_buckets(words_list, scales, dims),
            ops.sign_unpack_units_buckets(signs, dims)):
        assert tuple(t.shape) == tuple(s.shape) == (w.shape[0], d)
        assert _bitwise(t, terngrad_unpack_plain(w, sc, d))
        assert _bitwise(s, sign_unpack_plain(sw, d))
        assert _bitwise(ot, t) and _bitwise(os_, s)
    counts = kernels.launch_counts()              # CPU: no launch
    assert counts["terngrad_unpack"] == counts["sign_unpack"] == 0
    with reference() as ref:
        for i in pallas:
            w = words_list[i].contiguous().numpy().view(np.uint32)
            jt = ref.ops.terngrad_unpack_units(
                jnp.asarray(w), jnp.asarray(scales[i].numpy()), dims[i],
                use_pallas=True)
            assert np.array_equal(np.asarray(jt).view(np.uint32),
                                  tern[i].numpy().view(np.uint32))
            sw = signs[i].contiguous().numpy().view(np.uint32)
            js = ref.ops.sign_unpack_units(jnp.asarray(sw), dims[i],
                                           use_pallas=True)
            assert np.array_equal(np.asarray(js).view(np.uint32),
                                  sign[i].numpy().view(np.uint32))


def _bucket_words(shapes, seed):
    from repro_torch.kernels.ref import words_per_unit
    words = [_words(n, words_per_unit(d, 2), seed=seed + i)
             for i, (n, d) in enumerate(shapes)]
    scales = [_scales(n, seed=seed + 100 + i)
              for i, (n, _) in enumerate(shapes)]
    return words, scales


def test_grouped_decodes_at_edge_dims():
    shapes = [(2, d) for d in EDGE_DIMS]
    words, scales = _bucket_words(shapes, seed=10)
    _check_grouped(words, scales, list(EDGE_DIMS),
                   pallas=range(len(shapes)))


@pytest.mark.parametrize("case", ["resnet9_layerwise", "40_buckets"])
def test_grouped_decodes_on_step_buckets(case):
    shapes = _shapes(case)
    words, scales = _bucket_words(shapes, seed=40 if case == "40_buckets"
                                  else 20)
    _check_grouped(words, scales, [d for _, d in shapes],
                   pallas=range(0, len(shapes), 2 if len(shapes) < 32
                                else 13))


def test_grouped_decodes_on_views_past_a_16_byte_boundary():
    from repro_torch.kernels.ref import words_per_unit
    dims = [1024, 4608, 100, 2049]
    words = []
    for i, d in enumerate(dims):
        w = words_per_unit(d, 2)
        flat = _words(1, 3 * w + 1, seed=90 + i).reshape(-1)
        v = flat[1:].view(3, w)                  # 4 bytes past the base
        assert v.data_ptr() % 16 == (flat.data_ptr() + 4) % 16
        words.append(v)
    scales = [_scales(3, seed=95 + i) for i in range(len(dims))]
    _check_grouped(words, scales, dims, pallas=[1])


def test_grouped_decodes_keep_empty_buckets():
    from repro_torch import kernels
    from repro_torch.kernels import ops
    from repro_torch.kernels import sign as S
    from repro_torch.kernels import terngrad as T
    kernels.reset_launch_counts()
    words = [_words(2, 1, seed=2), torch.zeros((0, 1), dtype=torch.int32),
             torch.zeros((3, 0), dtype=torch.int32)]
    scales = [_scales(2, seed=3), torch.ones(0), torch.ones(3)]
    tern = T.terngrad_unpack_buckets(words, scales, [5, 7, 0])
    sign = S.sign_unpack_buckets(words, [5, 7, 0])
    for dec in (tern, sign):
        assert [tuple(o.shape) for o in dec] == [(2, 5), (0, 7), (3, 0)]
        assert all(o.dtype == torch.float32 for o in dec)
    assert _bitwise(tern[0], T.terngrad_unpack_plain(words[0], scales[0], 5))
    assert _bitwise(T.terngrad_unpack(words[0], scales[0], 5), tern[0])
    assert _bitwise(sign[0], S.sign_unpack_plain(words[0], 5))
    assert _bitwise(S.sign_unpack(words[0], 5), sign[0])
    assert T.terngrad_unpack_buckets([], [], []) == []
    assert S.sign_unpack_buckets([], []) == []
    assert ops.terngrad_unpack_units_buckets([], [], []) == []
    assert ops.sign_unpack_units_buckets([], []) == []
    counts = kernels.launch_counts()
    assert counts["terngrad_unpack"] == counts["sign_unpack"] == 0


CODEC_DIMS = [1, 31, 33, 700, 2049]


def _codec_inputs(seed):
    from repro_torch import random as R
    g = torch.Generator().manual_seed(seed)
    xs = [torch.randn((1 + i % 3, d), generator=g)
          for i, d in enumerate(CODEC_DIMS)]
    ks = [R.fold_in(R.key(seed)[None], torch.arange(x.shape[0]) + 10 * i)
          for i, x in enumerate(xs)]
    es = [torch.randn(x.shape, generator=g) for x in xs]
    return xs, ks, es


@pytest.mark.parametrize("name", ["terngrad", "signsgd"])
def test_fused_codec_decode_buckets(name):
    """Fused decode_buckets / decode_ef_buckets (one unpack call for the
    step) equal the per-bucket decode_batch / decode_ef_batch and the
    reference codec's decode_ef_batch on the same bytes."""
    from repro_torch.core.compressors import make_compressor
    from repro_torch.core.wire import wire_codec
    codec = wire_codec(make_compressor(name))
    assert codec.fused
    xs, ks, es = _codec_inputs(seed=len(name))
    pays = codec.encode_buckets(xs, ks)
    dec = codec.decode_buckets(pays, CODEC_DIMS)
    ef = codec.decode_ef_buckets(pays, es, CODEC_DIMS)
    assert len(dec) == len(ef) == len(CODEC_DIMS)
    with reference() as ref:
        jcodec = ref.core.wire_codec(ref.core.TernGrad() if name == "terngrad"
                                     else ref.core.SignSGD())
        for p, d, e, xhat, (xe, m) in zip(pays, CODEC_DIMS, es, dec, ef):
            assert _bitwise(xhat, codec.decode_batch(p, d))
            bx, bm = codec.decode_ef_batch(p, e, d)
            assert _bitwise(xe, bx) and _bitwise(m, bm)
            assert _bitwise(xe, xhat) and _bitwise(m, e - xhat)
            jx, jm = jcodec.decode_ef_batch(jnp.asarray(p.numpy()),
                                            jnp.asarray(e.numpy()), d)
            assert np.array_equal(np.asarray(jx).view(np.uint32),
                                  xhat.numpy().view(np.uint32))
            assert np.array_equal(np.asarray(jm).view(np.uint32),
                                  m.numpy().view(np.uint32))


@pytest.mark.parametrize("name", ["terngrad", "signsgd"])
def test_unfused_codec_decodes_per_unit(name, monkeypatch):
    """fused=False: decode_buckets / decode_ef_buckets go through one
    decode_rows_buckets call each and never reach the fused unpack; the
    values equal the fused decode's (the formats are one)."""
    from repro_torch.core.compressors import make_compressor
    from repro_torch.core.wire import wire_codec
    from repro_torch.kernels import ops
    fused = wire_codec(make_compressor(name))
    unit = wire_codec(make_compressor(name), fused=False)
    xs, ks, es = _codec_inputs(seed=3 + len(name))
    pays = fused.encode_buckets(xs, ks)
    want = fused.decode_buckets(pays, CODEC_DIMS)
    calls = []
    orig = type(unit).decode_rows_buckets

    def counted(self, payloads_list, dims):
        calls.append(len(dims))
        return orig(self, payloads_list, dims)

    def refused(*a, **k):
        raise AssertionError("fused=False reached the fused unpack")
    monkeypatch.setattr(type(unit), "decode_rows_buckets", counted)
    for fn in ("terngrad_unpack_units_buckets", "sign_unpack_units_buckets"):
        monkeypatch.setattr(ops, fn, refused)
    got = unit.decode_buckets(pays, CODEC_DIMS)
    ef = unit.decode_ef_buckets(pays, es, CODEC_DIMS)
    assert calls == [len(CODEC_DIMS)] * 2
    for g, w, (xe, m), e in zip(got, want, ef, es):
        assert _bitwise(g, w) and _bitwise(xe, w) and _bitwise(m, e - w)
