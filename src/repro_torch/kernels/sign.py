"""Fused signSGD sign+pack / unpack+decode: the wrappers of the CUDA kernels
in csrc/sign.cu and their plain-torch versions (the routing, checks and
launch counters of kernels/qsgd.py).

Bit p of a unit is x[p] >= 0; each unit packs into words_per_unit(d, 1)
words, held as int32 tensors with the uint32 bit patterns.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import build, ref
from repro_torch.kernels.qsgd import (_check, _launch_args, _on_card,
                                      unpack_codes_plain)
from repro_torch.kernels.ref import words_per_unit


def sign_pack_plain(x) -> torch.Tensor:
    n, d = x.shape
    dp = -(-d // 32) * 32
    pos = torch.arange(dp, device=x.device)
    codes = torch.where(pos < d, ref.sign_codes_ref(F.pad(x, (0, dp - d))),
                        0)                           # zero word padding
    return ref.words_to_i32(ref.pack_fields_tile(codes, 1)[:, :words_per_unit(
        d, 1)])


def sign_pack(x) -> torch.Tensor:
    """x (n, d) f32 units -> (n, words_per_unit(d, 1)) int32 sign words."""
    n, d = x.shape
    if not _on_card(x):
        return sign_pack_plain(x)
    _check(x, "x", torch.float32, (n, d))
    wpu = words_per_unit(d, 1)
    out = torch.empty((n, wpu), dtype=torch.int32, device=x.device)
    if out.numel() == 0:
        return out
    build.check(build.library("sign").sign_pack(
        x.data_ptr(), out.data_ptr(), n, d, wpu, *_launch_args(x.device)),
        "sign_pack")
    sign_pack.launches += 1
    return out


sign_pack.launches = 0


def sign_unpack_plain(words, d: int) -> torch.Tensor:
    return ref.sign_decode_ref(unpack_codes_plain(words, d, 1))


def sign_unpack(words, d: int) -> torch.Tensor:
    """(n, words_per_unit(d, 1)) int32 sign words -> (n, d) f32 +1 / -1."""
    n = words.shape[0]
    if not _on_card(words):
        return sign_unpack_plain(words, d)
    wpu = words_per_unit(d, 1)
    _check(words, "words", torch.int32, (n, wpu))
    out = torch.empty((n, d), dtype=torch.float32, device=words.device)
    if out.numel() == 0:
        return out
    build.check(build.library("sign").sign_unpack(
        words.data_ptr(), out.data_ptr(), n, d, wpu,
        *_launch_args(words.device)), "sign_unpack")
    sign_unpack.launches += 1
    return out


sign_unpack.launches = 0
