"""Fused TernGrad ternarize+pack / unpack+dequantize (csrc/terngrad.cu)
and the compress-only ternarize+dequantize (csrc/compress.cu): the wrappers
of the CUDA kernels and their plain-torch versions — the TernGrad mirror of
kernels/qsgd.py (same routing, checks and counters). The pack and the
unpack are grouped over up to MAX_BUCKETS buckets a launch
(`terngrad_pack_buckets`, `terngrad_unpack_buckets`, with kernels/qsgd.py's
bucket tables): the pack is the QSGD pack's hash-once tile walk
(csrc/hash_pack.cuh), the unpack the QSGD unpack's tile walk
(csrc/unpack_tile.cuh) at width 2. The compress-only ternarize is the QSGD
compress-only pair walk (csrc/compress.cu) over its own quantizer, grouped
likewise (`terngrad_compress_buckets`)."""
from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F

from repro_torch.kernels import prng, ref
from repro_torch.kernels.qsgd import (_check, _on_card, compress_noise,
                                      launch_compress, launch_grouped,
                                      pack_outputs, pack_tiles,
                                      unpack_codes_plain, unpack_tiles)
from repro_torch.kernels.ref import words_per_unit

TERN_WIDTH = 2


def terngrad_pack_plain(x, k0, k1, scale) -> torch.Tensor:
    n, d = x.shape
    dp = -(-d // 32) * 32
    pos = torch.arange(dp, device=x.device)
    u = prng.uniform_at(ref.words_from_i32(k0)[:, None],
                        ref.words_from_i32(k1)[:, None], pos[None, :], d)
    codes = ref.terngrad_codes_ref(F.pad(x, (0, dp - d)), u, scale[:, None])
    codes = torch.where(pos < d, codes, 0)           # zero word padding
    words = ref.pack_fields_tile(codes, TERN_WIDTH)
    return ref.words_to_i32(words[:, :words_per_unit(d, TERN_WIDTH)])


def terngrad_pack_buckets(xs, k0s, k1s, scales) -> List[torch.Tensor]:
    """terngrad_pack over many buckets: bucket i is (xs[i], k0s[i], k1s[i],
    scales[i]) as terngrad_pack takes them. On the card ONE launch per
    MAX_BUCKETS non-empty buckets (kernels/qsgd.py bucket_table at width
    2), each counted in terngrad_pack.launches. On the CPU,
    terngrad_pack_plain per bucket."""
    if not xs:
        return []
    if not _on_card(xs[0], *xs[1:], *k0s, *k1s, *scales):
        return [terngrad_pack_plain(x, k0, k1, sc)
                for x, k0, k1, sc in zip(xs, k0s, k1s, scales)]
    outs = pack_outputs(xs, k0s, k1s, scales, TERN_WIDTH)
    launch_grouped(terngrad_pack, "terngrad", "terngrad_pack_buckets",
                   [tuple(x.shape) for x in xs],
                   (xs, k0s, k1s, scales, outs), TERN_WIDTH, pack_tiles)
    return outs


def terngrad_pack(x, k0, k1, scale) -> torch.Tensor:
    """x (n, d) f32 units, per-unit int32 key words k0/k1 (n,) and scales
    (n,) f32 (max|x| + 1e-12) -> (n, words_per_unit(d, 2)) int32 words of
    codes sign(x)*Bernoulli(|x|/scale) + 1. On the card: the one-bucket
    launch of terngrad_pack_buckets."""
    return terngrad_pack_buckets([x], [k0], [k1], [scale])[0]


terngrad_pack.launches = 0


def terngrad_unpack_plain(words, scale, d: int) -> torch.Tensor:
    return ref.terngrad_decode_ref(unpack_codes_plain(words, d, TERN_WIDTH),
                                   scale[:, None])


def terngrad_unpack_buckets(words_list, scales, dims) -> List[torch.Tensor]:
    """terngrad_unpack over many buckets: bucket i is (words_list[i],
    scales[i], dims[i]) as terngrad_unpack takes them. On the card ONE
    launch per MAX_BUCKETS non-empty buckets (kernels/qsgd.py unpack_table
    at width 2), each counted in terngrad_unpack.launches. On the CPU,
    terngrad_unpack_plain per bucket."""
    if not words_list:
        return []
    if not _on_card(words_list[0], *words_list[1:], *scales):
        return [terngrad_unpack_plain(w, s, d)
                for w, s, d in zip(words_list, scales, dims)]
    outs, shapes = [], []
    for words, scale, d in zip(words_list, scales, dims):
        n = words.shape[0]
        _check(words, "words", torch.int32,
               (n, words_per_unit(d, TERN_WIDTH)))
        _check(scale, "scale", torch.float32, (n,))
        outs.append(torch.empty((n, d), dtype=torch.float32,
                                device=words.device))
        shapes.append((n, int(d)))
    launch_grouped(terngrad_unpack, "terngrad", "terngrad_unpack_buckets",
                   shapes, (words_list, scales, outs), TERN_WIDTH,
                   unpack_tiles)
    return outs


def terngrad_unpack(words, scale, d: int) -> torch.Tensor:
    """(n, wpu) int32 words + per-unit payload scales (n,) f32 -> (n, d)
    f32 (code - 1) * scale. On the card: the one-bucket launch of
    terngrad_unpack_buckets."""
    return terngrad_unpack_buckets([words], [scale], [d])[0]


terngrad_unpack.launches = 0


# ---- compress only (ternarize + dequantize, noise drawn in the kernel) ----

def terngrad_compress_rows_plain(x, noise, stat) -> torch.Tensor:
    """The arithmetic of the TernGrad compress-only kernel with the noise
    given: x, noise (n, d) f32 and one max|x| per row (n,) f32."""
    return ref.terngrad_ref(x, noise, stat[:, None])


def terngrad_compress_buckets_plain(xs, k0s, k1s, stats,
                                    draws) -> List[torch.Tensor]:
    return [terngrad_compress_rows_plain(
                x, compress_noise(k0, k1, x.shape[1], N), stat)
            for x, k0, k1, stat, N in zip(xs, k0s, k1s, stats, draws)]


def terngrad_compress_buckets(xs, k0s, k1s, stats,
                              draws) -> List[torch.Tensor]:
    """TernGrad ternarize+dequantize over many buckets, bucket i as in
    kernels/qsgd.py qsgd_compress_buckets with max|x| per unit as stats[i]
    -> (n, d) f32 sign(x) * [u < |x| / s] * s with s = max(stat, 1e-12)
    (ref.terngrad_ref). On the card ONE launch per MAX_BUCKETS non-empty
    buckets, each counted in terngrad_compress_rows.launches, on the walk
    compress_walk picks. On the CPU, the plain twin per bucket."""
    if not xs:
        return []
    if not _on_card(xs[0], *xs[1:], *k0s, *k1s, *stats):
        return terngrad_compress_buckets_plain(xs, k0s, k1s, stats, draws)
    return launch_compress(terngrad_compress_rows,
                           "terngrad_compress_buckets", xs, k0s, k1s, stats,
                           draws)


def terngrad_compress_rows(x, k0, k1, stat, draw: int) -> torch.Tensor:
    """The one-bucket call of terngrad_compress_buckets: (n, d) f32
    units."""
    return terngrad_compress_buckets([x], [k0], [k1], [stat], [draw])[0]


terngrad_compress_rows.launches = 0
