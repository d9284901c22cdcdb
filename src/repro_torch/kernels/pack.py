"""Width-parametric field pack / unpack: the wrappers of the CUDA kernels in
csrc/pack.cu and their plain-torch versions (the routing, checks and launch
counters of kernels/qsgd.py). The natural codec's 9-bit code leg and the
sparse codecs' ceil(log2 d)-bit index leg.

Fields are (n, k) int32 tensors read as uint32 (values < 2**width, width
1..31); each unit packs into words_per_unit(k, width) words, held as int32
tensors with the uint32 bit patterns.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import build, ref
from repro_torch.kernels.qsgd import (_check, _launch_args, _on_card,
                                      unpack_codes_plain)
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


def fields_pack(f, width: int) -> torch.Tensor:
    """(n, k) int32 fields -> (n, words_per_unit(k, width)) int32 words."""
    _check_width(width)
    n, k = f.shape
    if not _on_card(f):
        return fields_pack_plain(f, width)
    _check(f, "fields", torch.int32, (n, k))
    wpu = words_per_unit(k, width)
    out = torch.empty((n, wpu), dtype=torch.int32, device=f.device)
    if out.numel() == 0:
        return out
    build.check(build.library("pack").fields_pack(
        f.data_ptr(), out.data_ptr(), n, k, width, wpu,
        *_launch_args(f.device)), "fields_pack")
    fields_pack.launches += 1
    return out


fields_pack.launches = 0


def fields_unpack_plain(words, k: int, width: int) -> torch.Tensor:
    return unpack_codes_plain(words, k, width).to(torch.int32)


def fields_unpack(words, k: int, width: int) -> torch.Tensor:
    """(n, words_per_unit(k, width)) int32 words -> (n, k) int32 fields."""
    _check_width(width)
    n = words.shape[0]
    if not _on_card(words):
        return fields_unpack_plain(words, k, width)
    wpu = words_per_unit(k, width)
    _check(words, "words", torch.int32, (n, wpu))
    out = torch.empty((n, k), dtype=torch.int32, device=words.device)
    if out.numel() == 0:
        return out
    build.check(build.library("pack").fields_unpack(
        words.data_ptr(), out.data_ptr(), n, k, width, wpu,
        *_launch_args(words.device)), "fields_unpack")
    fields_unpack.launches += 1
    return out


fields_unpack.launches = 0
