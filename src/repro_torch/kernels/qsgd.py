"""Fused QSGD quantize+pack / unpack+dequantize (csrc/qsgd.cu) and the
compress-only quantize+dequantize (csrc/compress.cu): the wrappers of the
CUDA kernels and their plain-torch versions.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel,
or the wrapper raises. Nothing falls back. Each wrapper counts its kernel
launches in `<wrapper>.launches`.

Words are (n, words_per_unit(d, width)) int32 tensors holding the uint32
bit patterns of the payload (the bytes are what the wire carries).
Keys k0/k1 are (n,) int32 tensors holding the uint32 bit patterns of the
two key words (ops.py converts the int64 key data of random.py).
"""
from __future__ import annotations

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
    """True for CUDA inputs (launch the kernel), False for CPU inputs (plain
    version); anything else raises."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    for o in others:
        if o.device != x.device:
            raise ValueError(f"inputs on {o.device} and {x.device}")
    return True


def stat_column(stat: torch.Tensor, rows: int):
    """A compress kernel's statistic: (rows,) per row (stride 1) or one
    scalar () for every row (stride 0) -> (plain-version broadcast form,
    stride)."""
    if stat.dim() == 0:
        return stat, 0
    if tuple(stat.shape) != (rows,):
        raise ValueError(f"stat: want () or ({rows},), got "
                         f"{tuple(stat.shape)}")
    return stat[:, None], 1


def _launch_args(device) -> tuple:
    """The trailing (device index, stream) of every C entry point: PyTorch's
    current stream on `device`."""
    return device.index, torch.cuda.current_stream(device).cuda_stream


# ---- pack -----------------------------------------------------------------

def qsgd_pack_plain(x, k0, k1, nrm, levels: int, width: int) -> torch.Tensor:
    n, d = x.shape
    dp = -(-d // 32) * 32
    pos = torch.arange(dp, device=x.device)
    u = prng.uniform_at(ref.words_from_i32(k0)[:, None],
                        ref.words_from_i32(k1)[:, None], pos[None, :], d)
    codes = ref.qsgd_codes_ref(F.pad(x, (0, dp - d)), u, nrm[:, None], levels)
    codes = torch.where(pos < d, codes, 0)           # zero word padding
    words = ref.pack_fields_tile(codes, width)[:, :words_per_unit(d, width)]
    return ref.words_to_i32(words)


def qsgd_pack(x, k0, k1, nrm, levels: int, width: int) -> torch.Tensor:
    """x (n, d) f32 units, per-unit int32 key words k0/k1 (n,) and norms
    nrm (n,) f32 (+1e-12 already added) -> (n, words_per_unit(d, width)) int32 words of
    offset-binary codes sign(x)*stochastic_round(|x|/nrm*levels) + levels."""
    n, d = x.shape
    if not _on_card(x, k0, k1, nrm):
        return qsgd_pack_plain(x, k0, k1, nrm, levels, width)
    if not 1 <= width <= 16:
        raise ValueError(f"width {width} out of range")
    _check(x, "x", torch.float32, (n, d))
    _check(nrm, "nrm", torch.float32, (n,))
    _check(k0, "k0", torch.int32, (n,))
    _check(k1, "k1", torch.int32, (n,))
    wpu = words_per_unit(d, width)
    out = torch.empty((n, wpu), dtype=torch.int32, device=x.device)
    if out.numel() == 0:
        return out
    build.check(build.library("qsgd").qsgd_pack(
        x.data_ptr(), k0.data_ptr(), k1.data_ptr(), nrm.data_ptr(),
        out.data_ptr(), n, d, levels, width, wpu, *_launch_args(x.device)),
        "qsgd_pack")
    qsgd_pack.launches += 1
    return out


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


def qsgd_unpack(words, fac, d: int, levels: int, width: int) -> torch.Tensor:
    """(n, wpu) int32 words + per-unit fac = nrm/levels (n,) f32, divided
    by the caller -> (n, d) f32 (code - levels) * fac."""
    n = words.shape[0]
    if not _on_card(words, fac):
        return qsgd_unpack_plain(words, fac, d, levels, width)
    wpu = words_per_unit(d, width)
    _check(words, "words", torch.int32, (n, wpu))
    _check(fac, "fac", torch.float32, (n,))
    out = torch.empty((n, d), dtype=torch.float32, device=words.device)
    if out.numel() == 0:
        return out
    build.check(build.library("qsgd").qsgd_unpack(
        words.data_ptr(), fac.data_ptr(), out.data_ptr(), n, d, levels,
        width, wpu, *_launch_args(words.device)), "qsgd_unpack")
    qsgd_unpack.launches += 1
    return out


qsgd_unpack.launches = 0


# ---- compress only (quantize + dequantize, noise given) -----------------------

def qsgd_compress_rows_plain(x, noise, stat, levels: int) -> torch.Tensor:
    return ref.qsgd_ref(x, noise, stat_column(stat, x.shape[0])[0], levels)


def qsgd_compress_rows(x, noise, stat, levels: int) -> torch.Tensor:
    """x, noise (R, C) f32 and the l2 norm of each row (R,) or of all rows
    () f32 -> (R, C) f32 sign(x) * floor(|x| / n * levels + u) * n / levels
    with n = max(stat, 1e-12) (ref.qsgd_ref)."""
    if not _on_card(x, noise, stat):
        return qsgd_compress_rows_plain(x, noise, stat, levels)
    R, C = x.shape
    _, stride = stat_column(stat, R)
    _check(x, "x", torch.float32, (R, C))
    _check(noise, "noise", torch.float32, (R, C))
    _check(stat, "stat", torch.float32, stat.shape)
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    build.check(build.library("compress").qsgd_compress_rows(
        x.data_ptr(), noise.data_ptr(), stat.data_ptr(), out.data_ptr(), R,
        C, stride, levels, 1.0 / levels,      # ctypes rounds it to f32
        *_launch_args(x.device)), "qsgd_compress_rows")
    qsgd_compress_rows.launches += 1
    return out


qsgd_compress_rows.launches = 0
