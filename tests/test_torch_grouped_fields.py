"""The grouped field pack / unpack (csrc/pack.cu fields_pack_buckets /
fields_unpack_buckets) and the codecs and schedule step that call them,
in what the CPU can hold. Every comparison is bitwise unless it says
otherwise:

  - a plain mirror of the kernels' tiling (tiles of 64 chunks of 32
    fields; pack stages a tile's fields and every thread writes words of
    it, unpack stages a tile's words and extracts its fields) writes every
    output word / field exactly once, reads nothing past its tile, and
    equals fields_pack_plain / fields_unpack_plain at every width of
    chip_smoke.py's FIELD_WIDTHS and k at the chunk and tile edges and
    with k % 4 != 0;
  - field_table's block prefix sums, per-bucket widths and words per unit,
    one table per MAX_BUCKETS buckets (33 buckets: two tables);
  - ops.fields_pack_units_buckets / fields_unpack_units_buckets with mixed
    widths in one call equal the per-bucket calls and the reference's
    ops.fields_pack_units / fields_unpack_units (fields_pack_pallas /
    fields_unpack_pallas in interpret mode);
  - NaturalCodec / SparseCodec encode_buckets, decode_buckets and
    decode_ef_buckets equal their per-bucket forms built from the plain
    field twins;
  - execute_schedule_wire(_with_state) through the grouped decode step:
    buffers, trees and EF residuals of top-k, random-k and the threshold
    codecs equal the reference's at fusion {per-bucket, 64 KiB, one
    message}, with and without a wire key; natural's buffers hold the
    tolerance tests/test_torch_wire.py states (codes within one exponent
    step at no more than max(1, 1e-5 n) entries) and its trees and EF
    residuals equal the port's own sim path, which its codec matches bit
    for bit.
"""
import math

import jax
import numpy as np
import pytest
import torch

from test_torch_codecs import _natural_codes_close, _natural_inputs
from test_torch_ref import jkey, np_bits, reference, tkeys
from test_torch_wire import (FUSIONS, RESNET9_SHAPES, _assert_trees_bitwise,
                             _port_schedule, _to_jax, _to_torch)

FIELD_WIDTHS = (1, 4, 9, 13, 16, 17, 24, 31)     # chip_smoke.py's
# chunk edges (1, 31, 32, 33), tile edges (2047-2049, 4095-4097) and
# k % 4 != 0 beside them
EDGE_KS = (1, 2, 31, 32, 33, 100, 1025, 2047, 2048, 2049, 4095, 4096,
           4097)


def _fields(n, k, width, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 2**width, (n, k))
                            .astype(np.int32))


def _words(n, wpu, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(-2**31, 2**31, (n, wpu))
                            .astype(np.int32))


def _assemble_words(codes, width, w):
    """fields.cuh assemble_word for the tile words w (a tensor) over a
    staged tile of codes (int64): word w is word t = w - c * width of
    chunk c = w // width. -> (words, the largest staged index read)."""
    c = w // width
    lo_bit = 32 * (w - c * width)
    j0, j1 = lo_bit // width, (lo_bit + 31) // width
    out = torch.zeros_like(w)
    last = torch.zeros_like(w)
    for o in range(32 // width + 2):
        j = j0 + o
        use = j <= j1
        f = codes[(32 * c + j).clamp(max=codes.numel() - 1)]
        s = j * width - lo_bit
        part = torch.where(s >= 0, f << s.clamp(min=0),
                           f >> (-s).clamp(min=0))
        out |= torch.where(use, part & 0xFFFFFFFF, 0)
        last = torch.where(use, torch.maximum(last, 32 * c + j), last)
    assert bool((j1 <= 31).all())                    # inside its chunk
    return out, int(last.max()) if w.numel() else -1


def _mirror_pack(f, width):
    """csrc/pack.cu fields_pack_kernel, block by block -> (words as
    fields_pack_plain gives them, writes per word)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.pack import TILE_FIELDS, field_tiles
    n, k = f.shape
    wpu = ref.words_per_unit(k, width)
    out = torch.zeros((n, wpu), dtype=torch.int64)
    writes = torch.zeros((n, wpu), dtype=torch.int64)
    tile_words = TILE_FIELDS // 32 * width
    for unit in range(n):
        for tile in range(field_tiles(k)):
            f0 = tile * TILE_FIELDS
            nf = min(TILE_FIELDS, k - f0)
            codes = torch.zeros(TILE_FIELDS, dtype=torch.int64)
            codes[:nf] = ref.words_from_i32(f[unit, f0:f0 + nf])
            w0 = tile * tile_words
            nw = min(tile_words, wpu - w0)
            w = torch.arange(nw)
            words, last = _assemble_words(codes, width, w)
            assert last < TILE_FIELDS
            out[unit, w0:w0 + nw] = words
            writes[unit, w0:w0 + nw] += 1
    return ref.words_to_i32(out), writes


def _mirror_unpack(words, k, width):
    """csrc/pack.cu fields_unpack_kernel, block by block -> (fields,
    writes per field)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.pack import TILE_FIELDS, field_tiles
    n, wpu = words.shape
    out = torch.zeros((n, k), dtype=torch.int64)
    writes = torch.zeros((n, k), dtype=torch.int64)
    tile_words = TILE_FIELDS // 32 * width
    w64 = ref.words_from_i32(words)
    for unit in range(n):
        for tile in range(field_tiles(k)):
            w0 = tile * tile_words
            nw = min(tile_words, wpu - w0)
            staged = w64[unit, w0:w0 + nw]
            f0 = tile * TILE_FIELDS
            nf = min(TILE_FIELDS, k - f0)
            p = torch.arange(nf)
            b = p * width
            wi, s = b >> 5, b & 31
            span = s + width > 32
            assert int(torch.where(span, wi + 1, wi).max()) < nw
            lo = staged[wi] >> s
            hi = (staged[(wi + 1).clamp(max=nw - 1)] << (32 - s)) & 0xFFFFFFFF
            v = torch.where(span, lo | hi, lo) & ((1 << width) - 1)
            out[unit, f0:f0 + nf] = v
            writes[unit, f0:f0 + nf] += 1
    return out.to(torch.int32), writes


@pytest.mark.parametrize("k", EDGE_KS)
@pytest.mark.parametrize("width", FIELD_WIDTHS)
def test_tiling_writes_each_word_and_field_once(width, k):
    from repro_torch.kernels.pack import fields_pack_plain, fields_unpack_plain
    from repro_torch.kernels.ref import words_per_unit
    f = _fields(2, k, width, seed=31 * width + k)
    got, writes = _mirror_pack(f, width)
    assert bool((writes == 1).all())
    assert torch.equal(got, fields_pack_plain(f, width))
    words = _words(2, words_per_unit(k, width), seed=7 * width + k)
    dec, writes = _mirror_unpack(words, k, width)
    assert bool((writes == 1).all())
    assert torch.equal(dec, fields_unpack_plain(words, k, width))
    assert torch.equal(_mirror_unpack(got, k, width)[0], f)


def _prefix(values):
    out, acc = [], 0
    for v in values:
        out.append(acc)
        acc += v
    return out, acc


def _resnet9_legs():
    """(n, k, width) of a layerwise resnet9 step over 4 workers: natural's
    9-bit code legs, then the top-k(1%) index legs."""
    from repro_torch.core.compressors import _k_of, index_bits
    from repro_torch.core.granularity import Granularity, stacked_mask
    from repro_torch.core.plan import build_plan
    tree = {k: torch.zeros(s) for k, s in RESNET9_SHAPES.items()}
    plan = build_plan(tree, stacked_mask(tree), Granularity("layerwise"))
    return ([(4 * b.n, b.dim, 9) for b in plan.buckets]
            + [(4 * b.n, _k_of(0.01, b.dim), index_bits(b.dim))
               for b in plan.buckets])


@pytest.mark.parametrize("case", ["resnet9_legs", "33_buckets"])
def test_field_table(case):
    from repro_torch.kernels.pack import (MAX_BUCKETS, TILE_FIELDS,
                                          field_table, field_tiles)
    from repro_torch.kernels.ref import words_per_unit
    if case == "resnet9_legs":
        buckets = _resnet9_legs()
        assert len(buckets) == 22
        assert sum(n * field_tiles(k) for n, k, w in buckets[:11]) == 272
        groups = [buckets]
    else:
        buckets = [(1 + i % 4, 1 + 97 * i, FIELD_WIDTHS[i % 8])
                   for i in range(MAX_BUCKETS + 1)]
        groups = [buckets[:MAX_BUCKETS], buckets[MAX_BUCKETS:]]
    tables = field_table(buckets)
    assert len(tables) == len(groups)
    for t, group in zip(tables, groups):
        assert t.n == tuple(n for n, _, _ in group)
        assert t.k == tuple(k for _, k, _ in group)
        assert t.width == tuple(w for _, _, w in group)
        assert t.wpu == tuple(words_per_unit(k, w) for _, k, w in group)
        assert t.tiles == tuple(math.ceil(k / TILE_FIELDS)
                                for _, k, _ in group)
        starts, blocks = _prefix([n * tiles for (n, _, _), tiles
                                  in zip(group, t.tiles)])
        assert t.block_start == tuple(starts) and t.blocks == blocks


MIXED = [(3, 1, 1), (2, 31, 9), (3, 33, 13), (2, 100, 31), (1, 700, 9),
         (2, 1025, 17), (3, 46, 13), (1, 2049, 4), (2, 37, 24), (1, 64, 16)]


def test_grouped_units_match_per_bucket_and_reference():
    from repro_torch.kernels import ops
    fs = [_fields(n, k, w, seed=i) for i, (n, k, w) in enumerate(MIXED)]
    widths = [w for _, _, w in MIXED]
    words = ops.fields_pack_units_buckets(fs, widths)
    rand = [_words(n, ops.words_per_unit(k, w), seed=50 + i)
            for i, (n, k, w) in enumerate(MIXED)]
    ks = [k for _, k, _ in MIXED]
    dec = ops.fields_unpack_units_buckets(rand, ks, widths)
    back = ops.fields_unpack_units_buckets(words, ks, widths)
    with reference() as ref:
        for i, (f, w, k) in enumerate(zip(fs, widths, ks)):
            assert torch.equal(words[i], ops.fields_pack_units(f, w))
            assert torch.equal(dec[i], ops.fields_unpack_units(rand[i], k, w))
            assert torch.equal(back[i], f)
            jw = ref.ops.fields_pack_units(jax.numpy.asarray(f.numpy()), w)
            assert np.array_equal(np.asarray(jw), np_bits(words[i]))
            jd = ref.ops.fields_unpack_units(
                jax.numpy.asarray(rand[i].numpy().view(np.uint32)), k, w)
            assert np.array_equal(np.asarray(jd), dec[i].numpy())


def test_grouped_fields_route_cpu_and_keep_empty_buckets():
    from repro_torch import kernels
    from repro_torch.kernels import pack as P
    kernels.reset_launch_counts()
    fs = [torch.ones((2, 5), dtype=torch.int32),
          torch.zeros((0, 7), dtype=torch.int32),
          torch.ones((3, 0), dtype=torch.int32)]
    outs = P.fields_pack_buckets(fs, [9, 4, 31])
    assert [tuple(o.shape) for o in outs] == [(2, 2), (0, 1), (3, 0)]
    dec = P.fields_unpack_buckets(outs, [5, 7, 0], [9, 4, 31])
    assert [tuple(d.shape) for d in dec] == [(2, 5), (0, 7), (3, 0)]
    assert torch.equal(dec[0], fs[0])
    assert P.fields_pack_buckets([], []) == []
    assert P.fields_unpack_buckets([], [], []) == []
    counts = kernels.launch_counts()
    assert counts["fields_pack"] == counts["fields_unpack"] == 0
    for bad in (0, 32):
        with pytest.raises(ValueError, match="out of range"):
            P.fields_pack_buckets(fs[:1], [bad])
        with pytest.raises(ValueError, match="out of range"):
            P.fields_unpack_buckets(outs[:1], [5], [bad])


def _sparse_inputs(n, d, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    x[:, 2::11] = 0.0
    keys = rng.integers(0, 2**32, (n, 2), dtype=np.uint64).astype(np.uint32)
    return x, keys


CODEC_CASES = [("natural", {}, "float32"), ("topk", {}, "float32"),
               ("topk", {"ratio": 0.1}, "bfloat16"),
               ("randomk", {}, "float32"),
               ("randomk", {"ratio": 0.1, "scale": True}, "float32"),
               ("threshold_v", {}, "float32"),
               ("adaptive_threshold", {"alpha": 0.3, "cap_ratio": 0.05},
                "bfloat16")]


@pytest.mark.parametrize("name,kw,wire_dtype", CODEC_CASES)
def test_codec_buckets_equal_per_bucket_forms(name, kw, wire_dtype):
    """encode_buckets / decode_buckets / decode_ef_buckets over buckets of
    several dims equal each bucket built alone from the plain field twins:
    the codes or records of the compressor, fields_pack_plain of the
    packed leg, and the decode of fields_unpack_plain's fields."""
    from repro_torch.core.compressors import index_bits, make_compressor, pow2
    from repro_torch.core.wire import (_u8_rows_to_vals, _val_rows_to_u8,
                                       wire_codec)
    from repro_torch.kernels.pack import fields_pack_plain, fields_unpack_plain
    comp = make_compressor(name, **kw)
    codec = wire_codec(comp, wire_dtype=wire_dtype)
    dims = [1, 2, 33, 700, 1025, 4608]
    ins = [(_natural_inputs if name == "natural" else _sparse_inputs)(
        1 + i % 3, d, seed=d) for i, d in enumerate(dims)]
    xs = [torch.from_numpy(x) for x, _ in ins]
    ks = [tkeys(k) for _, k in ins]
    es = [torch.from_numpy(np.random.default_rng(d).standard_normal(
        x.shape).astype(np.float32)) for d, x in zip(dims, xs)]
    pays = codec.encode_buckets(xs, ks)
    dec = codec.decode_buckets(pays, dims)
    ef = codec.decode_ef_buckets(pays, es, dims)
    for x, k, d, e, pay, xhat, (xe, m) in zip(xs, ks, dims, es, pays, dec,
                                              ef):
        if name == "natural":
            ex, sgn, zero = comp._exponents(x, k)
            code = torch.where(zero, 0, sgn.to(torch.int32) * (ex + 128))
            want = fields_pack_plain(code + 255, 9).view(torch.uint8)
            c = fields_unpack_plain(pay.view(torch.int32), d, 9) - 255
            want_x = torch.where(c == 0, 0.0, torch.sign(c).to(torch.float32)
                                 * pow2(c.abs() - (comp._BIAS + 1)))
        else:
            rec = comp.encode(x, k)
            vb, kk = codec._vb(d), codec._k(d)
            idx = fields_pack_plain(rec["idx"].to(torch.int32),
                                    index_bits(d)).view(torch.uint8)
            want = torch.cat([_val_rows_to_u8(rec["val"], wire_dtype), idx],
                             dim=1)
            ii = fields_unpack_plain(pay[:, vb:].contiguous().view(
                torch.int32), kk, index_bits(d)).to(torch.int64)
            vals = _u8_rows_to_vals(pay[:, :vb], kk, wire_dtype)
            want_x = torch.zeros((x.shape[0], d)).scatter_(1, ii, vals)
        assert torch.equal(pay, want)
        assert torch.equal(pay, codec.encode_batch(x, k))
        assert torch.equal(xhat.view(torch.int32), want_x.view(torch.int32))
        assert torch.equal(xe.view(torch.int32), xhat.view(torch.int32))
        assert torch.equal(m.view(torch.int32), (e - xhat).view(torch.int32))
        if codec.exact_sim:
            assert torch.equal(xhat.view(torch.int32),
                               comp.sim(x, k).view(torch.int32))


def test_decode_buckets_defaults_to_decode_batch():
    from repro_torch import random as R
    from repro_torch.core.compressors import QSGD, SignSGD, TernGrad
    from repro_torch.core.wire import wire_codec
    xs = [torch.randn((3, 40 + 7 * i),
                      generator=torch.Generator().manual_seed(i))
          for i in range(3)]
    ks = [R.fold_in(R.key(1)[None], torch.arange(3) + 10 * i)
          for i in range(3)]
    dims = [x.shape[1] for x in xs]
    for codec in (wire_codec(QSGD(levels=16)),
                  wire_codec(QSGD(levels=16), fused=False),
                  wire_codec(TernGrad()), wire_codec(SignSGD())):
        pays = codec.encode_buckets(xs, ks)
        for got, p, d in zip(codec.decode_buckets(pays, dims), pays, dims):
            assert torch.equal(got, codec.decode_batch(p, d))
        for (x, m), p, e, d in zip(codec.decode_ef_buckets(pays, xs, dims),
                                   pays, xs, dims):
            wx, wm = codec.decode_ef_batch(p, e, d)
            assert torch.equal(x, wx) and torch.equal(m, wm)


def _grads(seed, natural):
    rng = np.random.default_rng(seed)
    if natural:
        return {k: (rng.standard_normal(s) * 10.0 ** rng.uniform(-8, 0, s))
                .astype(np.float32) for k, s in RESNET9_SHAPES.items()}
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in RESNET9_SHAPES.items()}


def _port_sim(sched, comp, tg, tm, wk):
    """The port's sim path over the schedule's plan (what natural's exact
    codec must give): (tree, EF tree or None)."""
    from repro_torch import random as R
    key = R.key(4)
    sim = ((lambda x, k: comp.sim(x, wk(k))) if wk is not None
           else comp.sim)
    if tm is None:
        return sched.plan.execute(sim, tg, key), None

    def fn(x, m, k):
        e = x + m
        q = sim(e, k)
        return q, e - q
    return sched.plan.execute_with_state(fn, tg, tm, key)


def _numpy(tree):
    return {k: _numpy(v) if isinstance(v, dict) else v.numpy()
            for k, v in tree.items()}


def _natural_buffers_close(jbufs, bufs, sched, codec):
    """tests/test_torch_wire.py's natural tolerance: the same headers and
    sizes, and every 9-bit code within one exponent step."""
    from repro_torch.core.wire import message_layouts
    from repro_torch.kernels import ops
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


@pytest.mark.parametrize("ef", [False, True], ids=["plain", "ef"])
@pytest.mark.parametrize("keyed", [False, True], ids=["key", "wire_key"])
@pytest.mark.parametrize("fusion", sorted(FUSIONS))
@pytest.mark.parametrize("name", ["natural", "topk", "randomk",
                                  "threshold_v", "adaptive_threshold"])
def test_schedule_buffers_through_grouped_decode(name, fusion, keyed, ef):
    from repro_torch import random as R
    from repro_torch.core.compressors import make_compressor
    from repro_torch.core.wire import (execute_schedule_wire,
                                       execute_schedule_wire_with_state,
                                       wire_codec)
    natural = name == "natural"
    g = _grads(5 + len(fusion) + len(name), natural)
    m = _grads(9, natural)
    tg, tm = _to_torch(g), _to_torch(m)
    sched = _port_schedule(tg, "layerwise", FUSIONS[fusion])
    comp = make_compressor(name)
    codec = wire_codec(comp)
    wk = (lambda k: R.fold_in(k, 3)) if keyed else None
    if ef:
        tree, mtree, bufs = execute_schedule_wire_with_state(
            sched, codec, tg, tm, R.key(4), wire_key=wk)
    else:
        tree, bufs = execute_schedule_wire(sched, codec, tg, R.key(4),
                                           wire_key=wk)
    if natural:
        want, want_m = _port_sim(sched, comp, tg, tm if ef else None, wk)
        _assert_trees_bitwise(_numpy(want), tree)
        if ef:
            _assert_trees_bitwise(_numpy(want_m), mtree)
    with reference() as ref:
        jg, jm = _to_jax(g), _to_jax(m)
        jplan = ref.core.build_plan(jg, ref.core.stacked_mask(jg),
                                    ref.core.Granularity("layerwise"))
        jsched = ref.core.build_schedule(jplan, FUSIONS[fusion])
        jcodec = ref.core.wire_codec(ref.core.make_compressor(name))
        jwk = (lambda k: jax.random.fold_in(k, 3)) if keyed else None
        # eagerly: the port rounds the EF residual e - xhat as the eager
        # run does (see test_torch_grouped_pack.py), and after the first
        # case each eager op is compiled already, while every jit of a
        # schedule compiles anew
        if ef:
            jtree, jmtree, jbufs = jsched.execute_with_state(
                None, jg, jm, jkey(4), wire=jcodec, wire_key=jwk)
            if not natural:
                _assert_trees_bitwise(jmtree, mtree)
        else:
            jtree, jbufs = jsched.execute(None, jg, jkey(4), wire=jcodec,
                                          wire_key=jwk)
        assert len(jbufs) == len(bufs) == sched.num_messages
        if natural:
            _natural_buffers_close(jbufs, bufs, sched, codec)
            return
        for jb, tb in zip(jbufs, bufs):
            assert np.array_equal(np.asarray(jb), tb.numpy())
        _assert_trees_bitwise(jtree, tree)
