"""Word packing: the wrappers of the CUDA kernels in csrc/pack.cu
(width-parametric fields, grouped over up to MAX_BUCKETS buckets of mixed
widths a launch) and csrc/bits.cu ({0,1} bits; the pack and the unpack
grouped over up to MAX_BUCKETS buckets a launch with kernels/qsgd.py's
bucket tables, the pack on the sign pack's tiles, csrc/ballot_pack.cuh),
with their plain-torch versions (the routing, checks and launch counters
of kernels/qsgd.py).

Fields are (n, k) int32 tensors read as uint32 (values < 2**width, width
1..31): the natural codec's 9-bit code leg and the sparse codecs'
ceil(log2 d)-bit index leg. Bits are (n, d) int32 tensors in {0, 1}: the
per-unit signSGD codec and the non-fused majority vote. Each unit packs
into words_per_unit(k, width) words (width 1 for bits), held as int32
tensors with the uint32 bit patterns.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import itertools
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import build, ref
from repro_torch.kernels.qsgd import (TILE_CODES, _check, _launch_args,
                                      _on_card, ballot_tiles, kernel_bytes,
                                      launch_grouped, unpack_codes_plain,
                                      unpack_tiles)
from repro_torch.kernels.ref import words_per_unit

MAX_WIDTH = 31


def _check_width(width: int) -> None:
    if not 1 <= width <= MAX_WIDTH:
        raise ValueError(f"width {width} out of range 1..{MAX_WIDTH}")


def fields_pack_plain(f, width: int) -> torch.Tensor:
    n, k = f.shape
    kp = -(-k // 32) * 32
    fields = F.pad(ref.words_from_i32(f), (0, kp - k))   # zero word padding
    words = ref.pack_fields_tile(fields, width)[:, :words_per_unit(k, width)]
    return ref.words_to_i32(words)


#: fields a pack / unpack block owns: 64 chunks of 32 (csrc/pack.cu
#: kTileFields)
TILE_FIELDS = 2048
#: buckets one launch takes (csrc/pack.cu kMaxBuckets)
MAX_BUCKETS = 32


def field_tiles(k: int) -> int:
    """Blocks per unit of k fields: tiles of TILE_FIELDS."""
    return -(-k // TILE_FIELDS)


@dataclasses.dataclass(frozen=True)
class FieldTable:
    """One grouped field launch: per bucket its n, k, width, words per
    unit, tiles per unit and first block (the prefix sum of n * tiles);
    `blocks` in all. Pack and unpack share it."""
    n: Tuple[int, ...]
    k: Tuple[int, ...]
    width: Tuple[int, ...]
    wpu: Tuple[int, ...]
    tiles: Tuple[int, ...]
    block_start: Tuple[int, ...]
    blocks: int


def field_table(buckets: Sequence[Tuple[int, int, int]]) -> List[FieldTable]:
    """The launches over (n, k, width) buckets: one table per MAX_BUCKETS
    buckets, in order."""
    tables = []
    for i in range(0, len(buckets), MAX_BUCKETS):
        group = [tuple(int(v) for v in b) for b in buckets[i:i + MAX_BUCKETS]]
        tiles = tuple(field_tiles(k) for _, k, _ in group)
        starts = list(itertools.accumulate(
            [n * t for (n, _, _), t in zip(group, tiles)], initial=0))
        tables.append(FieldTable(
            n=tuple(n for n, _, _ in group), k=tuple(k for _, k, _ in group),
            width=tuple(w for _, _, w in group),
            wpu=tuple(words_per_unit(k, w) for _, k, w in group),
            tiles=tiles, block_start=tuple(starts[:-1]), blocks=starts[-1]))
    return tables


@functools.lru_cache(maxsize=256)
def _launches(buckets: Tuple[Tuple[int, int, int], ...]):
    """field_table's launches with each table's sizes as the C entry
    point's int array (n, k, width, wpu, tiles, block_start; cached: a
    step's shapes repeat)."""
    return [(t, (ctypes.c_int * (6 * len(t.n)))(
        *t.n, *t.k, *t.width, *t.wpu, *t.tiles, *t.block_start))
        for t in field_table(buckets)]


def _launch_buckets(entry: str, wrapper, ins, outs, buckets) -> None:
    """One launch of `entry` per MAX_BUCKETS non-empty buckets, each
    counted in wrapper.launches."""
    live = [i for i, (n, k, _) in enumerate(buckets) if n * k]
    dev = ins[0].device
    for g, (table, sizes) in enumerate(_launches(
            tuple(buckets[i] for i in live))):
        idx = live[g * MAX_BUCKETS:(g + 1) * MAX_BUCKETS]
        if not kernel_bytes(wrapper, [t[i] for t in (ins, outs)
                                      for i in idx]):
            continue
        ptrs = (ctypes.c_void_p * (2 * len(idx)))(
            *(t[i].data_ptr() for t in (ins, outs) for i in idx))
        build.check(getattr(build.library("pack"), entry)(
            len(idx), ptrs, sizes, table.blocks, *_launch_args(dev)), entry)
        wrapper.launches += 1


def fields_pack_buckets(fs, widths) -> List[torch.Tensor]:
    """fields_pack over many buckets, each at its own width: bucket i is
    (fs[i], widths[i]) as fields_pack takes them. On the card ONE launch
    per MAX_BUCKETS non-empty buckets (field_table), each counted in
    fields_pack.launches. On the CPU, fields_pack_plain per bucket."""
    for w in widths:
        _check_width(w)
    if not fs:
        return []
    if not _on_card(fs[0], *fs[1:]):
        return [fields_pack_plain(f, w) for f, w in zip(fs, widths)]
    outs, buckets = [], []
    for f, w in zip(fs, widths):
        if f.dim() != 2:
            raise ValueError(f"fields: want (n, k), got {tuple(f.shape)}")
        n, k = f.shape
        _check(f, "fields", torch.int32, (n, k))
        outs.append(torch.empty((n, words_per_unit(k, w)),
                                dtype=torch.int32, device=f.device))
        buckets.append((n, k, w))
    _launch_buckets("fields_pack_buckets", fields_pack, fs, outs, buckets)
    return outs


def fields_pack(f, width: int) -> torch.Tensor:
    """(n, k) int32 fields -> (n, words_per_unit(k, width)) int32 words. On
    the card: the one-bucket launch of fields_pack_buckets."""
    return fields_pack_buckets([f], [width])[0]


fields_pack.launches = 0


def fields_unpack_plain(words, k: int, width: int) -> torch.Tensor:
    return unpack_codes_plain(words, k, width).to(torch.int32)


def fields_unpack_buckets(words_list, ks, widths) -> List[torch.Tensor]:
    """fields_unpack over many buckets: bucket i is (words_list[i], ks[i],
    widths[i]). On the card ONE launch per MAX_BUCKETS non-empty buckets,
    each counted in fields_unpack.launches. On the CPU,
    fields_unpack_plain per bucket."""
    for w in widths:
        _check_width(w)
    if not words_list:
        return []
    if not _on_card(words_list[0], *words_list[1:]):
        return [fields_unpack_plain(words, k, w)
                for words, k, w in zip(words_list, ks, widths)]
    outs, buckets = [], []
    for words, k, w in zip(words_list, ks, widths):
        n = words.shape[0]
        _check(words, "words", torch.int32, (n, words_per_unit(k, w)))
        outs.append(torch.empty((n, k), dtype=torch.int32,
                                device=words.device))
        buckets.append((n, int(k), w))
    _launch_buckets("fields_unpack_buckets", fields_unpack, words_list, outs,
                    buckets)
    return outs


def fields_unpack(words, k: int, width: int) -> torch.Tensor:
    """(n, words_per_unit(k, width)) int32 words -> (n, k) int32 fields. On
    the card: the one-bucket launch of fields_unpack_buckets."""
    return fields_unpack_buckets([words], [k], [width])[0]


fields_unpack.launches = 0


def bits_pack_plain(bits) -> torch.Tensor:
    n, d = bits.shape
    b = F.pad(bits.to(torch.int64), (0, -(-d // 32) * 32 - d))
    return ref.words_to_i32(ref.pack_bits_ref(b))


def bits_pack_buckets(bits_list) -> List[torch.Tensor]:
    """bits_pack over many buckets: bucket i is bits_list[i] as bits_pack
    takes it. On the card ONE launch per MAX_BUCKETS non-empty buckets
    (kernels/qsgd.py grouped_table at width 1 over ballot_tiles: the sign
    pack's staged-tile walk), each counted in
    bits_pack.launches. On the CPU, bits_pack_plain per bucket."""
    if not bits_list:
        return []
    if not _on_card(bits_list[0], *bits_list[1:]):
        return [bits_pack_plain(b) for b in bits_list]
    outs = []
    for i, b in enumerate(bits_list):
        if b.dim() != 2:
            raise ValueError(f"bits[{i}]: want (n, d), got {tuple(b.shape)}")
        n, d = b.shape
        _check(b, "bits", torch.int32, (n, d))
        outs.append(torch.empty((n, words_per_unit(d, 1)),
                                dtype=torch.int32, device=b.device))
    launch_grouped(bits_pack, "bits", "bits_pack_buckets",
                   [tuple(b.shape) for b in bits_list], (bits_list, outs), 1,
                   ballot_tiles)
    return outs


def bits_pack(bits) -> torch.Tensor:
    """(n, d) int32 {0,1} bits -> (n, words_per_unit(d, 1)) int32 words, bit
    p in word p // 32 at position p % 32, zero past d. On the card: the
    one-bucket launch of bits_pack_buckets."""
    return bits_pack_buckets([bits])[0]


bits_pack.launches = 0


def bits_unpack_plain(words, d: int) -> torch.Tensor:
    return ref.unpack_bits_ref(ref.words_from_i32(words))[:, :d].to(
        torch.int32)


#: bits an unpack block owns, and the unpack blocks per unit of d bits:
#: the tile of every grouped unpack (csrc/unpack_tile.cuh) at width 1
TILE_BITS = TILE_CODES
bits_tiles = unpack_tiles


def bits_unpack_buckets(words_list, dims) -> List[torch.Tensor]:
    """bits_unpack over many buckets: bucket i is (words_list[i], dims[i])
    as bits_unpack takes them. On the card ONE launch per MAX_BUCKETS
    non-empty buckets (kernels/qsgd.py grouped_table at width 1 over
    unpack_tiles), each counted in bits_unpack.launches.
    On the CPU, bits_unpack_plain per bucket."""
    if not words_list:
        return []
    if not _on_card(words_list[0], *words_list[1:]):
        return [bits_unpack_plain(w, d) for w, d in zip(words_list, dims)]
    outs, shapes = [], []
    for words, d in zip(words_list, dims):
        n = words.shape[0]
        _check(words, "words", torch.int32, (n, words_per_unit(d, 1)))
        outs.append(torch.empty((n, d), dtype=torch.int32,
                                device=words.device))
        shapes.append((n, int(d)))
    launch_grouped(bits_unpack, "bits", "bits_unpack_buckets", shapes,
                   (words_list, outs), 1, unpack_tiles)
    return outs


def bits_unpack(words, d: int) -> torch.Tensor:
    """(n, words_per_unit(d, 1)) int32 words -> (n, d) int32 {0,1} bits. On
    the card: the one-bucket launch of bits_unpack_buckets."""
    return bits_unpack_buckets([words], [d])[0]


bits_unpack.launches = 0
