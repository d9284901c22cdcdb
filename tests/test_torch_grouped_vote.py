"""The grouped bit pack (csrc/bits.cu bits_pack_buckets, the staged-tile
ballot walk of csrc/ballot_pack.cuh it shares with the sign pack), the
grouped majority vote (csrc/sign.cu majority_buckets), and the codec entry
points that call them, in what the CPU can hold. Every comparison is
bitwise:

  - the tables: the bit pack's (kernels/qsgd.py grouped_table over
    kernels/sign.py ballot_tiles) and the vote's (kernels/sign.py
    vote_table), block prefix sums, words and tiles, at the 11 resnet9
    layerwise buckets (one table) and at 40 buckets (two);
  - a plain mirror of each kernel's work split. The bit pack: 2,048-bit
    tiles staged with 16-byte loads only where d % 4 == 0 and the row
    base is aligned, one ballot a 32-bit chunk, lanes 0-7 of a warp
    storing its 8 words. The vote: 128 columns a block, one a thread
    (a warp's 32 columns one coalesced run), workers in groups of 8 (the
    first group on planes known to be zero). Each writes every
    output word exactly once, reads nothing past d or W and equals the
    plain twin, at the edge dimensions and at every row alignment;
  - bits_pack_buckets / ops.pack_words_buckets against bits_pack_plain
    per bucket and the reference's ops.pack_words (pack_bits_pallas in
    interpret mode, or its jnp oracle);
  - majority_buckets / ops.majority_words_buckets against majority_plain
    and the reference's ops.majority_words (majority_pallas in interpret
    mode, or ref.majority_words_ref) for n 1..8 and 255 workers, exact
    ties and zero columns;
  - SignSGDCodec(fused=False).encode_buckets, the per-unit QSGD and
    TernGrad encode_buckets (one field pack for every bucket) and
    majority_vote_buckets, fused and not, against their per-bucket calls
    and the reference's per-unit codecs;
  - CPU routing, with empty buckets kept.

This module imports no jax at module level: the reference comes in inside
the tests that need it.
"""
import itertools
import math

import numpy as np
import pytest
import torch

# chunk edges (1, 31-33), tile edges (2,047-2,049, 4,097) of the
# 2,048-element tiles, and a unit of 33 tiles
EDGE_DIMS = (1, 31, 32, 33, 2047, 2048, 2049, 4097, 65537)
# word columns at the vote's 32-column warp and 128-column tile edges,
# every W % 4
EDGE_COLS = (1, 2, 3, 4, 5, 6, 7, 127, 128, 129, 130, 255, 256, 1025, 4096)
VOTERS = (1, 2, 3, 4, 5, 6, 7, 8, 255)


def _words(n, w, seed):
    """Seeded (n, w) int32 words with every bit pattern possible."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 2**32, (n, w), dtype=np.uint64).astype(np.uint32)
    return torch.from_numpy(a.view(np.int32))


def _bits(n, d, seed):
    """Seeded (n, d) int32 {0, 1} bits."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 2, (n, d)).astype(np.int32))


def _votes(n, W, seed):
    """Seeded (n, W) words of n workers with the last column zero (padding
    votes 0) and, at even n, an exact tie in every bit of column 0."""
    w = _words(n, W, seed)
    w[:, -1] = 0
    if n % 2 == 0:
        w[: n // 2, 0] = -1
        w[n // 2:, 0] = 0
    return w


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


def _vote_shapes(case):
    """Each bucket's vote: 4 workers of (units / 4) x words per unit
    columns, or 40 buckets of 1 to 9 workers."""
    from repro_torch.kernels.ref import words_per_unit
    if case == "resnet9_layerwise":
        return [(4, n // 4 * words_per_unit(d, 1))
                for n, d in _shapes(case)]
    return [(1 + i % 9, 1 + 53 * i) for i in range(40)]


@pytest.mark.parametrize("case", ["resnet9_layerwise", "40_buckets"])
def test_bits_pack_and_vote_tables(case):
    from repro_torch.kernels.qsgd import MAX_BUCKETS, grouped_table
    from repro_torch.kernels.qsgd import BALLOT_TILE, ballot_tiles
    from repro_torch.kernels.sign import VOTE_COLS, vote_table, vote_tiles
    assert BALLOT_TILE == 2048 and VOTE_COLS == 128
    shapes = _shapes(case)
    tables = grouped_table(shapes, 1, ballot_tiles)
    assert len(tables) == math.ceil(len(shapes) / MAX_BUCKETS)
    for g, t in enumerate(tables):
        group = shapes[g * MAX_BUCKETS:(g + 1) * MAX_BUCKETS]
        assert t.n == tuple(n for n, _ in group)
        assert t.wpu == tuple(math.ceil(d / 32) for _, d in group)
        assert t.tiles == tuple(math.ceil(d / 2048) for _, d in group)
        starts = list(itertools.accumulate(
            [n * k for (n, _), k in zip(group, t.tiles)], initial=0))
        assert t.block_start == tuple(starts[:-1])
        assert t.blocks == starts[-1]
    votes = _vote_shapes(case)
    vtables = vote_table(votes)
    assert len(vtables) == len(tables)
    for g, t in enumerate(vtables):
        group = votes[g * MAX_BUCKETS:(g + 1) * MAX_BUCKETS]
        assert t.n == (1,) * len(group)           # one output row each
        assert t.d == tuple(W for _, W in group)
        assert t.tiles == tuple(math.ceil(W / 128) for _, W in group)
        assert t.tiles == tuple(vote_tiles(W) for _, W in group)
        starts = list(itertools.accumulate(t.tiles, initial=0))
        assert t.block_start == tuple(starts[:-1])
        assert t.blocks == starts[-1]
    if case == "resnet9_layerwise":             # 68 tiles a worker
        assert len(shapes) == 11
        assert tables[0].blocks == 272
        assert sum(W for _, W in votes) == 3783


@pytest.mark.parametrize("case", ["resnet9_layerwise", "40_buckets"])
def test_vote_launch_sizes_carry_the_voters(case):
    """The int array majority_buckets hands csrc/sign.cu: vote_table's
    rows (1, W, wpu, tiles, first block) then each bucket's voters, one
    array per table (kernels/qsgd.py launch_grouped with `extra`)."""
    from repro_torch.kernels.qsgd import MAX_BUCKETS, _launches
    from repro_torch.kernels.sign import vote_table, vote_tiles
    votes = _vote_shapes(case)
    launches = _launches(tuple((1, W) for _, W in votes), 1, vote_tiles,
                         tuple(n for n, _ in votes))
    assert [t for t, _ in launches] == vote_table(votes)
    for g, (t, sizes) in enumerate(launches):
        group = votes[g * MAX_BUCKETS:(g + 1) * MAX_BUCKETS]
        assert list(sizes) == [*t.n, *t.d, *t.wpu, *t.tiles,
                               *t.block_start, *(n for n, _ in group)]


# ---- plain mirrors of the work splits ---------------------------------------

def _mirror_bits_pack(bits, base):
    """csrc/ballot_pack.cuh ballot_pack_tile with bit != 0, block by block,
    the input row of unit 0 starting `base` int32s past a 16-byte boundary
    -> (words as bits_pack_plain gives them, writes per word)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.qsgd import BALLOT_TILE, ballot_tiles
    n, d = bits.shape
    wpu = -(-d // 32)
    out = torch.zeros((n, wpu), dtype=torch.int64)
    writes = torch.zeros((n, wpu), dtype=torch.int64)
    vectors = d % 4 == 0 and base % 4 == 0
    lane = torch.arange(32)
    for unit in range(n):
        for tile in range(ballot_tiles(d)):
            e0 = tile * BALLOT_TILE
            ne = min(BALLOT_TILE, d - e0)
            staged = torch.full((BALLOT_TILE,), -1, dtype=torch.int64)
            loaded = torch.zeros(BALLOT_TILE, dtype=torch.int64)
            for t in range(256):
                if vectors:                    # two 16-byte loads a thread
                    assert ne % 4 == 0
                    for r in range(2):
                        i = t + 256 * r
                        if 4 * i < ne:
                            g = base + unit * d + e0 + 4 * i
                            assert g % 4 == 0 and e0 + 4 * i + 4 <= d
                            staged[4 * i:4 * i + 4] = bits[unit,
                                                           e0 + 4 * i:
                                                           e0 + 4 * i + 4]
                            loaded[4 * i:4 * i + 4] += 1
                else:                          # eight 4-byte loads
                    for r in range(8):
                        i = t + 256 * r
                        if i < ne:
                            staged[i] = bits[unit, e0 + i]
                            loaded[i] += 1
            assert bool((loaded[:ne] == 1).all())
            assert bool((loaded[ne:] == 0).all())
            for warp in range(8):
                mine = torch.zeros(32, dtype=torch.int64)
                for r in range(8):
                    i = (8 * warp + r) * 32 + lane
                    on = (i < ne) & (staged[i.clamp(max=BALLOT_TILE - 1)] != 0)
                    mine[r] = int((on.to(torch.int64) << lane).sum())
                for ln in range(8):
                    c = 8 * warp + ln
                    if 32 * c < ne:
                        out[unit, 64 * tile + c] = mine[ln]
                        writes[unit, 64 * tile + c] += 1
    return ref.words_to_i32(out), writes


@pytest.mark.parametrize("base", [0, 1, 2, 3])
@pytest.mark.parametrize("d", EDGE_DIMS[:-1])
def test_bits_pack_split_writes_each_word_once(d, base):
    from repro_torch.kernels.pack import bits_pack_plain
    bits = _bits(2, d, seed=d + base)
    got, writes = _mirror_bits_pack(bits, base)
    assert bool((writes == 1).all())
    assert torch.equal(got, bits_pack_plain(bits))


def _mirror_majority(words, base):
    """csrc/sign.cu majority_kernel, block by block, the words starting
    `base` int32s past a 16-byte boundary and the votes on one (the split
    is the same at every alignment) -> (votes as majority_plain gives
    them, reads per word, writes per column)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.sign import VOTE_COLS, vote_tiles
    n, W = words.shape
    w64 = ref.words_from_i32(words)
    out = torch.zeros(W, dtype=torch.int64)
    reads = torch.zeros((n, W), dtype=torch.int64)
    writes = torch.zeros(W, dtype=torch.int64)
    thr = (n + 1) // 2
    mask = 0xFFFFFFFF
    for tile in range(vote_tiles(W)):
        cols = tile * VOTE_COLS + torch.arange(VOTE_COLS)  # one a thread
        c = cols[cols < W]                          # a thread leaves at c >= W
        for warp in range(0, len(c), 32):           # one 128-byte run a warp
            run = base + c[warp:warp + 32]
            assert bool((run == run[0] + torch.arange(len(run))).all())
        planes = torch.zeros((8, len(c)), dtype=torch.int64)
        for i0 in range(0, n, 8):
            for i in range(i0, min(i0 + 8, n)):     # the group's loads
                reads[i, c] += 1
            for i in range(i0, min(i0 + 8, n)):
                v = w64[i, c].clone()
                for p in range(8):                  # ripple-carry add
                    a = planes[p].clone()
                    planes[p] = a ^ v
                    v = a & v
        borrow = torch.zeros(len(c), dtype=torch.int64)
        for p in range(8):
            nb = ~planes[p] & mask
            borrow = nb | borrow if (thr >> p) & 1 else nb & borrow
        out[c] = ~borrow & mask
        writes[c] += 1
    return ref.words_to_i32(out), reads, writes


@pytest.mark.parametrize("base", [0, 1, 2, 3])
@pytest.mark.parametrize("W", EDGE_COLS)
def test_majority_split_writes_each_column_once(W, base):
    from repro_torch.kernels.sign import majority_plain
    for n in (1, 4, 9) if W < 1000 else (3, 8, 17):
        words = _votes(n, W, seed=10 * W + n + base)
        got, reads, writes = _mirror_majority(words, base)
        assert bool((reads == 1).all()) and bool((writes == 1).all())
        assert torch.equal(got, majority_plain(words))


def test_majority_split_at_255_voters():
    from repro_torch.kernels.sign import MAX_VOTERS, majority_plain
    for W, base in ((257, 0), (260, 0), (6, 1)):
        words = _votes(MAX_VOTERS, W, seed=W + base)
        got, reads, writes = _mirror_majority(words, base)
        assert bool((reads == 1).all()) and bool((writes == 1).all())
        assert torch.equal(got, majority_plain(words))


# ---- the wrappers against the plain twins and the reference -----------------

def _check_packs(bits_list, pallas_rows):
    """bits_pack_buckets (and ops.pack_words_buckets) in one call against
    the plain twin per bucket and the reference's pack_words per row: its
    Pallas kernel in interpret mode for the `pallas_rows` (bucket, row)
    pairs, its jnp oracle for every row."""
    import jax.numpy as jnp
    from test_torch_ref import reference
    from repro_torch.kernels import ops
    from repro_torch.kernels.pack import bits_pack_buckets, bits_pack_plain
    got = bits_pack_buckets(bits_list)
    assert len(got) == len(bits_list)
    for g, b, o in zip(got, bits_list, ops.pack_words_buckets(bits_list)):
        n, d = b.shape
        assert g.dtype == torch.int32
        assert tuple(g.shape) == (n, math.ceil(d / 32))
        assert torch.equal(g, bits_pack_plain(b))
        assert torch.equal(o, g)
    with reference() as ref:
        for i, (g, b) in enumerate(zip(got, bits_list)):
            a = b.contiguous().numpy()
            for r in range(b.shape[0]):
                want = ref.ops.pack_words(jnp.asarray(a[r]),
                                          use_pallas=(i, r) in pallas_rows)
                assert np.array_equal(np.asarray(want),
                                      g[r].numpy().view(np.uint32))


def test_bits_pack_buckets_match_plain_and_reference_at_edges():
    bits = [_bits(2, d, seed=d) for d in EDGE_DIMS]
    _check_packs(bits, pallas_rows={(0, 0), (3, 1), (6, 0)})


@pytest.mark.parametrize("case", ["resnet9_layerwise", "40_buckets"])
def test_bits_pack_buckets_match_plain_and_reference(case):
    shapes = _shapes(case)
    bits = [_bits(n, d, seed=i) for i, (n, d) in enumerate(shapes)]
    _check_packs(bits, pallas_rows={(i, 0) for i in range(0, len(shapes),
                                                           5)})


def test_bits_pack_buckets_on_views_past_a_16_byte_boundary():
    views = []
    for i, d in enumerate((1024, 4608, 100, 2049)):
        flat = _bits(1, 3 * d + 1, seed=70 + i).reshape(-1)
        v = flat[1:].view(3, d)                  # 4 bytes past the base
        assert v.data_ptr() % 16 == (flat.data_ptr() + 4) % 16
        views.append(v)
    _check_packs(views, pallas_rows={(1, 2)})


def _check_votes(words_list, pallas):
    """majority_buckets (and ops.majority_words_buckets) in one call
    against the plain twin per bucket and the reference's majority_words.
    Columns vote alone, so the reference takes the buckets of one worker
    count side by side in one call: its jnp oracle (ref.majority_words_ref)
    always, its Pallas kernel in interpret mode too where `pallas` (not at
    255 workers: interpret mode takes over a minute there)."""
    import jax.numpy as jnp
    from test_torch_ref import reference
    from repro_torch.kernels import ops
    from repro_torch.kernels.sign import (MAX_VOTERS, majority_buckets,
                                          majority_plain)
    got = majority_buckets(words_list)
    assert len(got) == len(words_list)
    for g, w, o in zip(got, words_list,
                       ops.majority_words_buckets(words_list)):
        assert g.dtype == torch.int32 and tuple(g.shape) == (w.shape[1],)
        assert torch.equal(g, majority_plain(w))
        assert torch.equal(o, g)
    with reference() as ref:
        for n in sorted({w.shape[0] for w in words_list}):
            idx = [i for i, w in enumerate(words_list) if w.shape[0] == n]
            u = jnp.asarray(torch.cat([words_list[i] for i in idx],
                                      dim=1).numpy().view(np.uint32))
            mine = torch.cat([got[i] for i in idx]).numpy().view(np.uint32)
            for use_pallas in {False, pallas and n < MAX_VOTERS}:
                want = ref.ops.majority_words(u, use_pallas=use_pallas)
                assert np.array_equal(np.asarray(want), mine)


@pytest.mark.parametrize("n", VOTERS)
def test_majority_buckets_match_plain_and_reference(n):
    words = [_votes(n, W, seed=100 * n + W) for W in EDGE_COLS]
    _check_votes(words, pallas=True)


@pytest.mark.parametrize("case", ["resnet9_layerwise", "40_buckets"])
def test_majority_buckets_match_plain_and_reference_on_groups(case):
    words = [_votes(n, W, seed=i) for i, (n, W) in
             enumerate(_vote_shapes(case))]
    _check_votes(words, pallas=case == "resnet9_layerwise")


def test_majority_buckets_on_views_past_a_16_byte_boundary():
    views = []
    for i, (n, W) in enumerate(((4, 1024), (3, 4608), (8, 100), (2, 2049))):
        flat = _votes(1, n * W + 1, seed=80 + i).reshape(-1)
        v = flat[1:].view(n, W)                  # 4 bytes past the base
        assert v.data_ptr() % 16 == (flat.data_ptr() + 4) % 16
        views.append(v)
    _check_votes(views, pallas=False)


def test_grouped_vote_route_cpu_and_keep_empty_buckets():
    from repro_torch import kernels
    from repro_torch.kernels import ops
    from repro_torch.kernels import pack as P
    from repro_torch.kernels import sign as S
    kernels.reset_launch_counts()
    bits = [_bits(2, 5, seed=3), torch.zeros((0, 7), dtype=torch.int32),
            torch.zeros((3, 0), dtype=torch.int32)]
    packed = P.bits_pack_buckets(bits)
    assert [tuple(o.shape) for o in packed] == [(2, 1), (0, 1), (3, 0)]
    assert torch.equal(packed[0], P.bits_pack_plain(bits[0]))
    assert torch.equal(P.bits_pack(bits[0]), packed[0])
    words = [_votes(3, 5, seed=4), torch.zeros((2, 0), dtype=torch.int32),
             _votes(1, 2, seed=5)]
    votes = S.majority_buckets(words)
    assert [tuple(v.shape) for v in votes] == [(5,), (0,), (2,)]
    assert torch.equal(votes[0], S.majority_plain(words[0]))
    assert torch.equal(votes[2], words[2][0])        # one voter: its words
    assert torch.equal(S.majority(words[0]), votes[0])
    assert P.bits_pack_buckets([]) == [] and S.majority_buckets([]) == []
    assert ops.pack_words_buckets([]) == []
    assert ops.majority_words_buckets([]) == []
    for n in (0, S.MAX_VOTERS + 1):
        with pytest.raises(ValueError, match="workers"):
            S.majority_buckets([words[0], torch.zeros((n, 4),
                                                      dtype=torch.int32)])
    assert kernels.launch_counts()["bits_pack"] == 0
    assert kernels.launch_counts()["majority"] == 0


def test_grouped_vote_refuses_a_device_without_a_kernel():
    """Any device but the card, the CPU and meta (the dry run's shape
    function) raises: XPU stand-ins, as this CPU build makes tensors on no
    other device."""
    import types
    from repro_torch.kernels.pack import bits_pack_buckets
    from repro_torch.kernels.sign import majority_buckets
    w = types.SimpleNamespace(device=torch.device("xpu"), shape=(2, 4),
                              dim=lambda: 2)
    for call in (lambda: bits_pack_buckets([w, w]),
                 lambda: majority_buckets([w, w])):
        with pytest.raises(ValueError, match="no kernel"):
            call()


# ---- the codecs -------------------------------------------------------------

DIMS = [1, 31, 33, 700, 2049]


def _codec_inputs(name, seed):
    """Seeded buckets of 1-3 units at DIMS and their unit keys (QSGD:
    dyadic entries, whose l2 norm is exact in any summation order)."""
    from test_torch_ref import tkeys
    rng = np.random.default_rng(seed)
    xs, ks = [], []
    for i, d in enumerate(DIMS):
        n = 1 + i % 3
        x = rng.standard_normal((n, d)).astype(np.float32)
        if name == "qsgd":
            x = rng.choice(np.float32([0, .25, -.25, .5, -.5, 1, -1, 2, -2]),
                           (n, d)).astype(np.float32)
        x[:, 2::11] = 0.0
        xs.append(x)
        ks.append(rng.integers(0, 2**32, (n, 2), dtype=np.uint64).astype(
            np.uint32))
    return xs, ks, [torch.from_numpy(x) for x in xs], [tkeys(k) for k in ks]


@pytest.mark.parametrize("name", ["qsgd", "terngrad", "signsgd"])
def test_per_unit_encode_buckets_match_per_bucket_and_reference(name):
    """fused=False encode_buckets packs every bucket in one launch
    (fields_pack for QSGD and TernGrad, bits_pack for signSGD): the same
    bytes as encode_rows / encode_batch per bucket, as the fused codec, and
    as the reference's per-unit codec unit by unit."""
    import jax.numpy as jnp
    from test_torch_ref import reference
    from repro_torch.core.compressors import make_compressor
    from repro_torch.core.wire import wire_codec
    comp = make_compressor(name)
    unit, fused = wire_codec(comp, fused=False), wire_codec(comp)
    xs, ks, txs, tks = _codec_inputs(name, seed=len(name))
    pays = unit.encode_buckets(txs, tks)
    assert len(pays) == len(DIMS)
    for p, x, k, f in zip(pays, txs, tks, fused.encode_buckets(txs, tks)):
        assert p.dtype == torch.uint8
        assert torch.equal(p, unit.encode_rows(x, k))
        assert torch.equal(p, unit.encode_batch(x, k))
        assert torch.equal(p, f)
    assert all(torch.equal(a, b) for a, b in
               zip(unit.encode_rows_buckets(txs, tks), pays))
    with reference() as ref:
        jcodec = ref.core.wire_codec(ref.core.make_compressor(name),
                                     fused=False)
        for p, x, k in zip(pays, xs, ks):
            for i in range(x.shape[0]):
                jp = jcodec.encode(jnp.asarray(x[i]), jnp.asarray(k[i]))
                assert np.array_equal(np.asarray(jp), p[i].numpy())


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
def test_majority_vote_buckets_match_per_bucket_and_reference(n):
    """majority_vote_buckets over every bucket of a step, fused (one
    majority launch) and not (one bits_unpack, the counts, one bits_pack):
    the same bytes as majority_vote per bucket and as the reference's
    fused and non-fused majority_vote, unit by unit; at even n every
    bucket holds exact ties."""
    import jax.numpy as jnp
    from test_torch_ref import reference
    from repro_torch.core.compressors import SignSGD
    from repro_torch.core.wire import SignSGDCodec
    rng = np.random.default_rng(n)
    fused = SignSGDCodec(comp=SignSGD())
    unfused = SignSGDCodec(comp=SignSGD(), fused=False)
    pays_list = []
    for i, d in enumerate(DIMS):
        units = 1 + i % 3
        x = rng.standard_normal((n, units, d)).astype(np.float32)
        if n % 2 == 0:                      # ties resolve to +1
            x[: n // 2, :, 0], x[n // 2:, :, 0] = 1.0, -1.0
        pays = fused.encode_batch(torch.from_numpy(x.reshape(-1, d)), None)
        pays_list.append(pays.reshape(n, units, -1))
    got = fused.majority_vote_buckets(pays_list, DIMS)
    rows = unfused.majority_vote_buckets(pays_list, DIMS)
    assert len(got) == len(rows) == len(DIMS)
    for g, r, p, d in zip(got, rows, pays_list, DIMS):
        assert tuple(g.shape) == tuple(p.shape[1:])
        assert torch.equal(g, r)
        assert torch.equal(g, fused.majority_vote(p, d))
        assert torch.equal(g, unfused.majority_vote(p, d))
        if n % 2 == 0:
            assert bool((fused.decode_batch(g, d)[:, 0] == 1.0).all())
    with reference() as ref:
        for f in (True, False):
            jcodec = ref.core.SignSGDCodec(comp=ref.core.SignSGD(), fused=f)
            for g, p, d in zip(got, pays_list, DIMS):
                for u in range(p.shape[1]):
                    jm = jcodec.majority_vote(jnp.asarray(p[:, u].numpy()),
                                              d)
                    assert np.array_equal(np.asarray(jm), g[u].numpy())
