"""Fused QSGD quantize+pack / unpack+dequantize (csrc/qsgd.cu) and the
compress-only quantize+dequantize (csrc/compress.cu): the wrappers of the
CUDA kernels and their plain-torch versions.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel,
or the wrapper raises. Nothing falls back. Each wrapper counts its kernel
launches in `<wrapper>.launches`. A meta tensor (a dry run,
launch/dryrun.py) takes the kernel's shape function: the card path's
checks and output allocations, no launch, `launches` unchanged. On the
card and on meta alike, each launch hands a cost observer
(launch/hlo_cost.py StepCost) the bytes of every buffer it reads or writes
(`kernel_bytes`: each input read once, each output written once, as
chip_smoke.py's bounds reckon them).

The wire pack and unpack are grouped: one launch serves up to MAX_BUCKETS
buckets (`qsgd_pack_buckets`, `qsgd_unpack_buckets`), described by a
table of sizes and first blocks (`grouped_table`) and launched by
`launch_grouped`, which the other grouped kernels share (kernels/sign.py,
kernels/terngrad.py, kernels/pack.py's bit unpack). The four grouped
unpacks (QSGD, TernGrad, bits, signSGD) are one tile walk,
csrc/unpack_tile.cuh. The compress-only quantizers are grouped too
(`qsgd_compress_buckets`, kernels/terngrad.py `terngrad_compress_buckets`):
one pair walk, csrc/compress.cu, that draws each unit's uniforms itself
over the unit's draw length.

Words are (n, words_per_unit(d, width)) int32 tensors holding the uint32
bit patterns of the payload (the bytes are what the wire carries).
Keys k0/k1 are (n,) int32 tensors holding the uint32 bit patterns of the
two key words (ops.py converts the int64 key data of random.py).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import itertools
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import build, prng, ref
from repro_torch.kernels.ref import words_per_unit


def _check(t: torch.Tensor, name: str, dtype, shape) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: want {dtype} {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _on_card(x: torch.Tensor, *others: torch.Tensor) -> bool:
    """True for CUDA inputs (launch the kernel) and meta inputs (the
    kernel's shape function), False for CPU inputs (plain version);
    anything else raises."""
    if x.device.type == "cpu":
        return False
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"no kernel for device {x.device}")
    for o in others:
        if o.device != x.device:
            raise ValueError(f"inputs on {o.device} and {x.device}")
    return True


#: the active cost observer (launch/hlo_cost.py StepCost), or None
_observer = None


def kernel_bytes(wrapper, tensors) -> bool:
    """Before one launch of `wrapper`'s kernel over `tensors` (every buffer
    it reads or writes, each once): hand their bytes to a cost observer.
    False on meta tensors: a dry run launches nothing."""
    if _observer is not None:
        _observer.kernel(wrapper.__name__,
                         sum(t.numel() * t.element_size() for t in tensors))
    return not tensors[0].is_meta


def _launch_args(device) -> tuple:
    """The trailing (device index, stream) of every C entry point: PyTorch's
    current stream on `device`."""
    return device.index, torch.cuda.current_stream(device).cuda_stream


# ---- pack -----------------------------------------------------------------

def qsgd_pack_plain(x, k0, k1, nrm, levels: int, width: int, lo: int = 0,
                    hi=None) -> torch.Tensor:
    """The words of positions [lo, hi) of each (n, d) unit (default all
    of it): words [lo * width / 32, ceil(hi * width / 32)), with lo a
    multiple of 32 and hi one or d. A unit too large for the plain
    arithmetic at once (int64 temporaries of every position) packs in
    such spans; its uniforms depend only on the position."""
    n, d = x.shape
    hi = d if hi is None else hi
    if lo % 32 or not lo <= hi <= d or (hi % 32 and hi != d):
        raise ValueError(f"span [{lo}, {hi}) of a {d}-entry unit")
    dp = lo + -(-(hi - lo) // 32) * 32
    pos = torch.arange(lo, dp, device=x.device)
    u = prng.uniform_at(ref.words_from_i32(k0)[:, None],
                        ref.words_from_i32(k1)[:, None], pos[None, :], d)
    codes = ref.qsgd_codes_ref(F.pad(x[:, lo:hi], (0, dp - hi)), u,
                               nrm[:, None], levels)
    codes = torch.where(pos < d, codes, 0)           # zero word padding
    nw = words_per_unit(hi, width) - lo * width // 32
    return ref.words_to_i32(ref.pack_fields_tile(codes, width)[:, :nw])


#: pairs of counters a pack block hashes for itself (csrc/qsgd.cu
#: kTilePairs: 15 chunks of 32, beside one halo chunk)
TILE_PAIRS = 480
#: codes an unpack block owns: 64 chunks of 32 (csrc/unpack_tile.cuh
#: kUnpackTile, the tile of every grouped unpack)
TILE_CODES = 2048
#: elements a one-bit pack block owns: 64 chunks (words) of 32
#: (csrc/ballot_pack.cuh kBallotTile, the sign pack's and the bit pack's)
BALLOT_TILE = 2048
#: threads of a compress-only block, which owns COMPRESS_THREADS * p
#: counter pairs of a unit, p = 1 or 4 a thread (csrc/compress.cu kThreads)
COMPRESS_THREADS = 256
#: buckets one grouped launch takes (csrc/hash_pack.cuh kPackMaxBuckets,
#: csrc/unpack_tile.cuh kUnpackMaxBuckets, csrc/sign.cu kMaxBuckets,
#: csrc/compress.cu kMaxBuckets)
MAX_BUCKETS = 32
#: widest code the unpack kernel stages (csrc/qsgd.cu kMaxUnpackWidth)
MAX_UNPACK_WIDTH = 31


def pack_tiles(d: int) -> int:
    """Pack blocks per unit of d elements: tiles of TILE_PAIRS of its
    ceil(d / 2) counter pairs."""
    return -(-(-(-d // 2)) // TILE_PAIRS)


def unpack_tiles(d: int) -> int:
    """Unpack blocks per unit of d elements: tiles of TILE_CODES."""
    return -(-d // TILE_CODES)


def ballot_tiles(d: int) -> int:
    """One-bit pack blocks per unit of d elements: tiles of BALLOT_TILE."""
    return -(-d // BALLOT_TILE)


def compress_tiles(d: int, draw: int, per_thread: int) -> int:
    """Compress-only blocks per unit of d elements whose uniforms are drawn
    over `draw` (even) positions: tiles of COMPRESS_THREADS * per_thread
    of its min(d, draw / 2) counter pairs."""
    return -(-min(d, draw // 2) // (COMPRESS_THREADS * per_thread))


@functools.lru_cache(maxsize=None)
def _resident_threads(device) -> int:
    if device.type == "meta":      # a dry run: no card to ask, no launch
        return 1 << 62
    p = torch.cuda.get_device_properties(device)
    return p.multi_processor_count * p.max_threads_per_multi_processor


def compress_walk(pairs: int, device) -> int:
    """Counter pairs a thread of the compress-only kernels takes in a call
    of `pairs` pairs: 1 while one pair a thread fits in one wave of the
    card's resident threads (SMs x threads an SM: the shortest chain a
    thread), 4 beyond (16-byte accesses, the hashes of a thread
    overlapping). On an H100 the two walks cross near 2^18 pairs."""
    return 1 if pairs <= _resident_threads(device) else 4


@dataclasses.dataclass(frozen=True)
class BucketTable:
    """One grouped launch: per bucket its n, d, words per unit, tiles per
    unit and first block (the prefix sum of n * tiles); `blocks` in
    all."""
    n: Tuple[int, ...]
    d: Tuple[int, ...]
    wpu: Tuple[int, ...]
    tiles: Tuple[int, ...]
    block_start: Tuple[int, ...]
    blocks: int


def grouped_table(shapes: Sequence[Tuple[int, ...]], width: int,
                  tiles_of) -> List[BucketTable]:
    """The launches of a grouped kernel over (n, d) buckets at `width` bits
    a code whose blocks each own one of a unit's tiles_of(d) tiles: one
    table per MAX_BUCKETS buckets, in order. A bucket given as (n, d, *more)
    has tiles_of(d, *more) tiles (the compress-only kernels' draw
    length)."""
    tables = []
    for i in range(0, len(shapes), MAX_BUCKETS):
        group = [tuple(int(v) for v in s) for s in shapes[i:i + MAX_BUCKETS]]
        tiles = tuple(tiles_of(*s[1:]) for s in group)
        starts = list(itertools.accumulate(
            [s[0] * t for s, t in zip(group, tiles)], initial=0))
        tables.append(BucketTable(
            n=tuple(s[0] for s in group), d=tuple(s[1] for s in group),
            wpu=tuple(words_per_unit(s[1], width) for s in group),
            tiles=tiles, block_start=tuple(starts[:-1]), blocks=starts[-1]))
    return tables


def bucket_table(shapes: Sequence[Tuple[int, int]],
                 width: int) -> List[BucketTable]:
    """The launches that pack (n, d) buckets at `width` bits a code."""
    return grouped_table(shapes, width, pack_tiles)


def unpack_table(shapes: Sequence[Tuple[int, int]],
                 width: int) -> List[BucketTable]:
    """The launches that unpack (n, d) buckets at `width` bits a code."""
    return grouped_table(shapes, width, unpack_tiles)


@functools.lru_cache(maxsize=256)
def _launches(shapes: Tuple[Tuple[int, ...], ...], width: int, tiles_of,
              extra: Tuple[int, ...]):
    """grouped_table's launches with each table's sizes as the C entry
    point's int array (n, d, wpu, tiles, block_start, then each bucket's
    `extra` int if given; cached: a step's shapes repeat)."""
    out = []
    for g, t in enumerate(grouped_table(shapes, width, tiles_of)):
        more = extra[g * MAX_BUCKETS:(g + 1) * MAX_BUCKETS]
        out.append((t, (ctypes.c_int * (5 * len(t.n) + len(more)))(
            *t.n, *t.d, *t.wpu, *t.tiles, *t.block_start, *more)))
    return out


def launch_grouped(wrapper, stem: str, entry: str, shapes, tensors,
                   width: int, tiles_of, *args, extra=None) -> None:
    """One launch of the C entry point `entry` of csrc/<stem>.cu per
    MAX_BUCKETS non-empty (n, d) buckets of `shapes` (grouped_table's
    forms), each counted in wrapper.launches. `tensors` holds one list per
    pointer the entry point takes for each bucket, in its order; `extra`,
    if given, one int per bucket that follows the table's sizes; `args` go
    between the block count and the (device, stream)."""
    live = [i for i, s in enumerate(shapes) if s[0] * s[1]]
    more = () if extra is None else tuple(int(extra[i]) for i in live)
    for g, (table, sizes) in enumerate(_launches(
            tuple(tuple(shapes[i]) for i in live), width, tiles_of, more)):
        idx = live[g * MAX_BUCKETS:(g + 1) * MAX_BUCKETS]
        if not kernel_bytes(wrapper, [t[i] for t in tensors for i in idx]):
            continue
        ptrs = (ctypes.c_void_p * (len(tensors) * len(idx)))(
            *(t[i].data_ptr() for t in tensors for i in idx))
        build.check(getattr(build.library(stem), entry)(
            len(idx), ptrs, sizes, table.blocks, *args,
            *_launch_args(tensors[0][idx[0]].device)), entry)
        wrapper.launches += 1


def pack_outputs(xs, k0s, k1s, stats, width: int) -> List[torch.Tensor]:
    """Check the inputs of a grouped stochastic pack (qsgd_pack_buckets,
    kernels/terngrad.py terngrad_pack_buckets) on the card: bucket i is
    xs[i] (n, d) f32, key words k0s[i] / k1s[i] (n,) int32 and statistics
    stats[i] (n,) f32, all contiguous -> its (n, words_per_unit(d, width))
    int32 output, allocated."""
    outs = []
    for i, (x, k0, k1, stat) in enumerate(zip(xs, k0s, k1s, stats)):
        n, d = _check_units(i, x, k0, k1, stat)
        outs.append(torch.empty((n, words_per_unit(d, width)),
                                dtype=torch.int32, device=x.device))
    return outs


def _check_units(i: int, x, k0, k1, stat) -> Tuple[int, int]:
    """Bucket i of a grouped stochastic kernel: x (n, d) f32, key words k0
    / k1 (n,) int32 and statistics stat (n,) f32, all contiguous -> (n,
    d)."""
    if x.dim() != 2:
        raise ValueError(f"x[{i}]: want (n, d), got {tuple(x.shape)}")
    n, d = x.shape
    _check(x, "x", torch.float32, (n, d))
    _check(stat, "stat", torch.float32, (n,))
    _check(k0, "k0", torch.int32, (n,))
    _check(k1, "k1", torch.int32, (n,))
    return n, d


def qsgd_pack_buckets(xs, k0s, k1s, nrms, levels: int,
                      width: int) -> List[torch.Tensor]:
    """qsgd_pack over many buckets at one (levels, width): bucket i is
    (xs[i], k0s[i], k1s[i], nrms[i]) as qsgd_pack takes them. On the card
    ONE launch per MAX_BUCKETS non-empty buckets (bucket_table), each
    counted in qsgd_pack.launches. On the CPU, qsgd_pack_plain per
    bucket."""
    if not xs:
        return []
    if not _on_card(xs[0], *xs[1:], *k0s, *k1s, *nrms):
        return [qsgd_pack_plain(x, k0, k1, nrm, levels, width)
                for x, k0, k1, nrm in zip(xs, k0s, k1s, nrms)]
    if not 1 <= width <= 16:
        raise ValueError(f"width {width} out of range")
    outs = pack_outputs(xs, k0s, k1s, nrms, width)
    launch_grouped(qsgd_pack, "qsgd", "qsgd_pack_buckets",
                   [tuple(x.shape) for x in xs], (xs, k0s, k1s, nrms, outs),
                   width, pack_tiles, levels, width)
    return outs


def qsgd_pack(x, k0, k1, nrm, levels: int, width: int) -> torch.Tensor:
    """x (n, d) f32 units, per-unit int32 key words k0/k1 (n,) and norms
    nrm (n,) f32 (+1e-12 already added) -> (n, words_per_unit(d, width)) int32 words of
    offset-binary codes sign(x)*stochastic_round(|x|/nrm*levels) + levels.
    On the card: the one-bucket launch of qsgd_pack_buckets."""
    return qsgd_pack_buckets([x], [k0], [k1], [nrm], levels, width)[0]


qsgd_pack.launches = 0


# ---- unpack ---------------------------------------------------------------

def unpack_codes_plain(words, d: int, width: int) -> torch.Tensor:
    """(n, wpu) int32 words -> (n, d) int64 codes (shared by both codecs)."""
    w = ref.words_from_i32(words)
    nc = -(-d // 32)
    w = F.pad(w, (0, nc * width - w.shape[1]))
    return ref.unpack_fields_tile(w, width)[:, :d]


def qsgd_unpack_plain(words, fac, d: int, levels: int,
                      width: int) -> torch.Tensor:
    return ref.qsgd_decode_ref(unpack_codes_plain(words, d, width),
                               fac[:, None], levels)


def qsgd_unpack_buckets(words_list, facs, dims, levels: int,
                        width: int) -> List[torch.Tensor]:
    """qsgd_unpack over many buckets at one (levels, width): bucket i is
    (words_list[i], facs[i], dims[i]) as qsgd_unpack takes them. On the
    card ONE launch per MAX_BUCKETS non-empty buckets (unpack_table), each
    counted in qsgd_unpack.launches. On the CPU, qsgd_unpack_plain per
    bucket."""
    if not words_list:
        return []
    if not _on_card(words_list[0], *words_list[1:], *facs):
        return [qsgd_unpack_plain(w, f, d, levels, width)
                for w, f, d in zip(words_list, facs, dims)]
    if not 1 <= width <= MAX_UNPACK_WIDTH:
        raise ValueError(f"width {width} out of range")
    outs, shapes = [], []
    for words, fac, d in zip(words_list, facs, dims):
        n = words.shape[0]
        _check(words, "words", torch.int32, (n, words_per_unit(d, width)))
        _check(fac, "fac", torch.float32, (n,))
        outs.append(torch.empty((n, d), dtype=torch.float32,
                                device=words.device))
        shapes.append((n, int(d)))
    launch_grouped(qsgd_unpack, "qsgd", "qsgd_unpack_buckets", shapes,
                   (words_list, facs, outs), width, unpack_tiles, levels,
                   width)
    return outs


def qsgd_unpack(words, fac, d: int, levels: int, width: int) -> torch.Tensor:
    """(n, wpu) int32 words + per-unit fac = nrm/levels (n,) f32, divided
    by the caller -> (n, d) f32 (code - levels) * fac. On the card: the
    one-bucket launch of qsgd_unpack_buckets."""
    return qsgd_unpack_buckets([words], [fac], [d], levels, width)[0]


qsgd_unpack.launches = 0


# ---- compress only (quantize + dequantize, noise drawn in the kernel) ------

def compress_noise(k0, k1, d: int, draw: int) -> torch.Tensor:
    """Key words k0 / k1 (n,) int32 -> (n, d) f32: row i is
    jax.random.uniform(key_i, (draw,))[:d], the uniforms the compress-only
    kernels draw for themselves."""
    pos = torch.arange(d, device=k0.device)
    return prng.uniform_at(ref.words_from_i32(k0)[:, None],
                           ref.words_from_i32(k1)[:, None], pos[None, :], draw)


def compress_outputs(xs, k0s, k1s, stats, draws) -> List[torch.Tensor]:
    """Check the inputs of a grouped compress-only kernel on the card, as
    pack_outputs does, and each draw length (even, d <= draw < 2**31) ->
    each bucket's (n, d) f32 output, allocated."""
    outs = []
    for i, (x, k0, k1, stat, draw) in enumerate(zip(xs, k0s, k1s, stats,
                                                    draws)):
        n, d = _check_units(i, x, k0, k1, stat)
        if draw % 2 or not d <= draw < 2**31:
            raise ValueError(f"draw[{i}]: want an even length >= d = {d}, "
                             f"got {draw}")
        outs.append(torch.empty_like(x))
    return outs


def launch_compress(wrapper, entry: str, xs, k0s, k1s, stats, draws,
                    *args) -> List[torch.Tensor]:
    """The grouped launches of the compress-only C entry point `entry`
    (csrc/compress.cu) over the buckets, counted in wrapper.launches, on
    the walk compress_walk picks for the call's pairs -> their outputs."""
    outs = compress_outputs(xs, k0s, k1s, stats, draws)
    per_thread = compress_walk(sum(x.shape[0] * min(x.shape[1], N // 2)
                                   for x, N in zip(xs, draws)),
                               xs[0].device)
    launch_grouped(wrapper, "compress", entry,
                   [(*x.shape, int(N), per_thread) for x, N in zip(xs, draws)],
                   (xs, k0s, k1s, stats, outs), 32, compress_tiles,
                   per_thread, *args, extra=draws)
    return outs


def qsgd_compress_rows_plain(x, noise, stat, levels: int) -> torch.Tensor:
    """The arithmetic of the QSGD compress-only kernel with the noise
    given: x, noise (n, d) f32 and one statistic per row (n,) f32."""
    return ref.qsgd_ref(x, noise, stat[:, None], levels)


def qsgd_compress_buckets_plain(xs, k0s, k1s, stats, draws,
                                levels: int) -> List[torch.Tensor]:
    return [qsgd_compress_rows_plain(
                x, compress_noise(k0, k1, x.shape[1], N), stat, levels)
            for x, k0, k1, stat, N in zip(xs, k0s, k1s, stats, draws)]


def qsgd_compress_buckets(xs, k0s, k1s, stats, draws,
                          levels: int) -> List[torch.Tensor]:
    """QSGD quantize+dequantize over many buckets: bucket i is xs[i] (n, d)
    f32 units, their key words k0s[i] / k1s[i] (n,) int32, l2 norms
    stats[i] (n,) f32 and the draw length draws[i] -> (n, d) f32 sign(x) *
    floor(|x| / s * levels + u) * s / levels with s = max(stat, 1e-12)
    and u = jax.random.uniform(key, (draw,))[:d] (ref.qsgd_ref). On the
    card ONE launch per MAX_BUCKETS non-empty buckets, each counted in
    qsgd_compress_rows.launches, on the walk compress_walk picks. On the
    CPU, the plain twin per bucket."""
    if not xs:
        return []
    if not _on_card(xs[0], *xs[1:], *k0s, *k1s, *stats):
        return qsgd_compress_buckets_plain(xs, k0s, k1s, stats, draws,
                                           levels)
    return launch_compress(qsgd_compress_rows, "qsgd_compress_buckets", xs,
                           k0s, k1s, stats, draws, levels,
                           1.0 / levels)      # ctypes rounds it to f32


def qsgd_compress_rows(x, k0, k1, stat, draw: int,
                       levels: int) -> torch.Tensor:
    """The one-bucket call of qsgd_compress_buckets: (n, d) f32 units."""
    return qsgd_compress_buckets([x], [k0], [k1], [stat], [draw], levels)[0]


qsgd_compress_rows.launches = 0
