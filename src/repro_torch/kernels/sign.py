"""Fused signSGD sign+pack / unpack+decode and the majority vote on packed
words: the wrappers of the CUDA kernels in csrc/sign.cu and their
plain-torch versions (the routing, checks and launch counters of
kernels/qsgd.py). The pack, the unpack and the vote are grouped over up
to 32 buckets a launch (`sign_pack_buckets`, `sign_unpack_buckets` with
kernels/qsgd.py's bucket tables, `majority_buckets` with `vote_table`);
the pack is the staged-tile ballot walk it shares with the bit pack
(csrc/ballot_pack.cuh), the unpack the bit unpack's tile walk
(csrc/unpack_tile.cuh) with +1 / -1 for a bit.

Bit p of a unit is x[p] >= 0; each unit packs into words_per_unit(d, 1)
words, held as int32 tensors with the uint32 bit patterns.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ref
from repro_torch.kernels.qsgd import (BucketTable, _check, _on_card,
                                      ballot_tiles, grouped_table,
                                      launch_grouped, unpack_codes_plain,
                                      unpack_tiles)
from repro_torch.kernels.ref import words_per_unit


def sign_pack_plain(x) -> torch.Tensor:
    n, d = x.shape
    dp = -(-d // 32) * 32
    pos = torch.arange(dp, device=x.device)
    codes = torch.where(pos < d, ref.sign_codes_ref(F.pad(x, (0, dp - d))),
                        0)                           # zero word padding
    return ref.words_to_i32(ref.pack_fields_tile(codes, 1)[:, :words_per_unit(
        d, 1)])


def sign_table(shapes: Sequence[Tuple[int, int]]) -> List[BucketTable]:
    """The launches that pack (n, d) buckets of signs: one table per
    MAX_BUCKETS buckets, in order, over kernels/qsgd.py ballot_tiles."""
    return grouped_table(shapes, 1, ballot_tiles)


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
                   [tuple(x.shape) for x in xs], (xs, outs), 1, ballot_tiles)
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


#: word columns a majority block owns, one a thread (csrc/sign.cu
#: kVoteCols)
VOTE_COLS = 128


def vote_tiles(W: int) -> int:
    """Majority blocks per (n, W) bucket: tiles of VOTE_COLS columns."""
    return -(-W // VOTE_COLS)


def vote_table(shapes: Sequence[Tuple[int, int]]) -> List[BucketTable]:
    """The launches that vote over (n, W) buckets: one table per
    MAX_BUCKETS buckets, in order, each bucket one output row of W words
    in tiles of VOTE_COLS (grouped_table over (1, W); n is the voters)."""
    return grouped_table([(1, W) for _, W in shapes], 1, vote_tiles)


def majority_buckets(words_list) -> List[torch.Tensor]:
    """majority over many buckets: bucket i is words_list[i], (n_i, W_i)
    int32 words of n_i workers, as majority takes it. On the card ONE
    launch per MAX_BUCKETS buckets with W_i > 0 (vote_table), each counted
    in majority.launches. On the CPU, majority_plain per bucket."""
    for i, w in enumerate(words_list):
        if w.dim() != 2:
            raise ValueError(f"words[{i}]: want (n, W), got {tuple(w.shape)}")
        if not 1 <= w.shape[0] <= MAX_VOTERS:
            raise ValueError(f"majority of {w.shape[0]} workers: supports "
                             f"1..{MAX_VOTERS}")
    if not words_list:
        return []
    if not _on_card(words_list[0], *words_list[1:]):
        return [majority_plain(w) for w in words_list]
    outs = []
    for w in words_list:
        _check(w, "words", torch.int32, w.shape)
        outs.append(torch.empty((w.shape[1],), dtype=torch.int32,
                                device=w.device))
    # vote_table's launches: one output row of W words a bucket, its
    # voters after the table's sizes
    launch_grouped(majority, "sign", "majority_buckets",
                   [(1, w.shape[1]) for w in words_list], (words_list, outs),
                   1, vote_tiles, extra=[w.shape[0] for w in words_list])
    return outs


def majority(words) -> torch.Tensor:
    """(n_workers, W) int32 packed sign words -> (W,) int32 majority words:
    a bit is set where 2 * (votes for it) >= n_workers (ties -> +1). On
    the card: the one-bucket launch of majority_buckets."""
    return majority_buckets([words])[0]


majority.launches = 0
