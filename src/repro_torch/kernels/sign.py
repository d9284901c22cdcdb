"""Fused signSGD sign+pack / unpack+decode and the majority vote on packed
words: the wrappers of the CUDA kernels in csrc/sign.cu and their
plain-torch versions (the routing, checks and launch counters of
kernels/qsgd.py). The pack and the unpack are grouped over up to 32
buckets a launch (`sign_pack_buckets`, `sign_unpack_buckets`, with
kernels/qsgd.py's bucket tables); the unpack is the bit unpack's tile walk
(csrc/unpack_tile.cuh) with +1 / -1 for a bit.

Bit p of a unit is x[p] >= 0; each unit packs into words_per_unit(d, 1)
words, held as int32 tensors with the uint32 bit patterns.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import build, ref
from repro_torch.kernels.qsgd import (BucketTable, _check, _launch_args,
                                      _on_card, grouped_table, launch_grouped,
                                      unpack_codes_plain, unpack_tiles)
from repro_torch.kernels.ref import words_per_unit


def sign_pack_plain(x) -> torch.Tensor:
    n, d = x.shape
    dp = -(-d // 32) * 32
    pos = torch.arange(dp, device=x.device)
    codes = torch.where(pos < d, ref.sign_codes_ref(F.pad(x, (0, dp - d))),
                        0)                           # zero word padding
    return ref.words_to_i32(ref.pack_fields_tile(codes, 1)[:, :words_per_unit(
        d, 1)])


#: elements a pack block owns: 64 chunks (words) of 32 (csrc/sign.cu
#: kPackTile)
TILE_ELEMS = 2048


def sign_tiles(d: int) -> int:
    """Pack blocks per unit of d elements: tiles of TILE_ELEMS."""
    return -(-d // TILE_ELEMS)


def sign_table(shapes: Sequence[Tuple[int, int]]) -> List[BucketTable]:
    """The launches that pack (n, d) buckets of signs: one table per
    MAX_BUCKETS buckets, in order."""
    return grouped_table(shapes, 1, sign_tiles)


def sign_pack_buckets(xs) -> List[torch.Tensor]:
    """sign_pack over many buckets: bucket i is xs[i] as sign_pack takes
    it. On the card ONE launch per MAX_BUCKETS non-empty buckets
    (sign_table), each counted in sign_pack.launches. On the CPU,
    sign_pack_plain per bucket."""
    if not xs:
        return []
    if not _on_card(xs[0], *xs[1:]):
        return [sign_pack_plain(x) for x in xs]
    outs = []
    for i, x in enumerate(xs):
        if x.dim() != 2:
            raise ValueError(f"x[{i}]: want (n, d), got {tuple(x.shape)}")
        n, d = x.shape
        _check(x, "x", torch.float32, (n, d))
        outs.append(torch.empty((n, words_per_unit(d, 1)),
                                dtype=torch.int32, device=x.device))
    launch_grouped(sign_pack, "sign", "sign_pack_buckets",
                   [tuple(x.shape) for x in xs], (xs, outs), 1, sign_tiles)
    return outs


def sign_pack(x) -> torch.Tensor:
    """x (n, d) f32 units -> (n, words_per_unit(d, 1)) int32 sign words. On
    the card: the one-bucket launch of sign_pack_buckets."""
    return sign_pack_buckets([x])[0]


sign_pack.launches = 0


def sign_unpack_plain(words, d: int) -> torch.Tensor:
    return ref.sign_decode_ref(unpack_codes_plain(words, d, 1))


def sign_unpack_buckets(words_list, dims) -> List[torch.Tensor]:
    """sign_unpack over many buckets: bucket i is (words_list[i], dims[i])
    as sign_unpack takes them. On the card ONE launch per MAX_BUCKETS
    non-empty buckets (kernels/qsgd.py grouped_table at width 1 over
    unpack_tiles), each counted in sign_unpack.launches. On the CPU,
    sign_unpack_plain per bucket."""
    if not words_list:
        return []
    if not _on_card(words_list[0], *words_list[1:]):
        return [sign_unpack_plain(w, d) for w, d in zip(words_list, dims)]
    outs, shapes = [], []
    for words, d in zip(words_list, dims):
        n = words.shape[0]
        _check(words, "words", torch.int32, (n, words_per_unit(d, 1)))
        outs.append(torch.empty((n, d), dtype=torch.float32,
                                device=words.device))
        shapes.append((n, int(d)))
    launch_grouped(sign_unpack, "sign", "sign_unpack_buckets", shapes,
                   (words_list, outs), 1, unpack_tiles)
    return outs


def sign_unpack(words, d: int) -> torch.Tensor:
    """(n, words_per_unit(d, 1)) int32 sign words -> (n, d) f32 +1 / -1. On
    the card: the one-bucket launch of sign_unpack_buckets."""
    return sign_unpack_buckets([words], [d])[0]


sign_unpack.launches = 0


#: most workers the majority kernel counts (8 bit planes)
MAX_VOTERS = 255


def majority_plain(words) -> torch.Tensor:
    return ref.words_to_i32(ref.majority_words_ref(ref.words_from_i32(words)))


def majority(words) -> torch.Tensor:
    """(n_workers, W) int32 packed sign words -> (W,) int32 majority words:
    a bit is set where 2 * (votes for it) >= n_workers (ties -> +1)."""
    n, W = words.shape
    if not 1 <= n <= MAX_VOTERS:
        raise ValueError(f"majority of {n} workers: supports 1..{MAX_VOTERS}")
    if not _on_card(words):
        return majority_plain(words)
    _check(words, "words", torch.int32, (n, W))
    out = torch.empty((W,), dtype=torch.int32, device=words.device)
    if out.numel() == 0:
        return out
    build.check(build.library("sign").majority(
        words.data_ptr(), out.data_ptr(), n, W, *_launch_args(words.device)),
        "majority")
    majority.launches += 1
    return out


majority.launches = 0
