"""Bucket entry points of the fused compress+pack kernels: what the wire
codecs (core/wire.py) call, one kernel launch per bucket and direction
(the JAX package's kernels/ops.py:274-522).

A bucket is an (n, d) f32 matrix whose rows are compression units. The
caller-side pieces stay here, outside the kernels, exactly as in the
reference: the per-unit statistic (l2 norm or max|x|, + 1e-12), the
division nrm / levels of the QSGD decode (ops.py:372) and the
error-feedback subtract m = e - xhat after decode (ops.py:383-395).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels.pack import fields_pack, fields_unpack
from repro_torch.kernels.qsgd import qsgd_pack, qsgd_unpack
from repro_torch.kernels.ref import words_per_unit, words_to_i32
from repro_torch.kernels.sign import sign_pack, sign_unpack
from repro_torch.kernels.terngrad import terngrad_pack, terngrad_unpack

__all__ = ["words_per_unit", "qsgd_pack_units", "qsgd_unpack_units",
           "qsgd_unpack_ef_units", "terngrad_pack_units",
           "terngrad_unpack_units", "terngrad_unpack_ef_units",
           "sign_pack_units", "sign_unpack_units", "sign_unpack_ef_units",
           "fields_pack_units", "fields_unpack_units", "pack_fields",
           "unpack_fields", "pack_bytes_moved", "unpack_bytes_moved"]


def _split_keys(keys: torch.Tensor, device):
    """(n, 2) int64 key data -> the kernels' two (n,) int32 key-word
    columns on `device`."""
    kw = words_to_i32(keys.to(device))
    return kw[:, 0].contiguous(), kw[:, 1].contiguous()


def qsgd_pack_units(x2d, keys, levels: int, width: int):
    """Fused QSGD encode of a bucket: (n, d) f32 + (n, 2) unit keys ->
    ((n, words_per_unit(d, width)) int32 words, (n,) f32 norms). The norms
    include the compressor's +1e-12 and are exactly the payload norm field."""
    xf = x2d.to(torch.float32).contiguous()
    nrms = torch.linalg.vector_norm(xf, dim=1) + 1e-12
    k0, k1 = _split_keys(keys, xf.device)
    return qsgd_pack(xf, k0, k1, nrms, levels, width), nrms


def qsgd_unpack_units(words, nrms, d: int, levels: int,
                      width: int) -> torch.Tensor:
    """Fused QSGD decode: words + payload norms -> (n, d) f32."""
    fac = (nrms.to(torch.float32) / levels).contiguous()
    return qsgd_unpack(words.contiguous(), fac, d, levels, width)


def qsgd_unpack_ef_units(words, nrms, e2d, d: int, levels: int, width: int):
    """QSGD decode + error-feedback residual m = e - xhat, the subtract in
    the caller (one unpack launch + one elementwise pass) -> (xhat, m)."""
    xhat = qsgd_unpack_units(words, nrms, d, levels, width)
    return xhat, e2d.to(torch.float32) - xhat


def terngrad_pack_units(x2d, keys):
    """Fused TernGrad encode: (n, d) f32 + unit keys -> ((n,
    words_per_unit(d, 2)) int32 words, (n,) f32 scales incl. +1e-12)."""
    xf = x2d.to(torch.float32).contiguous()
    scales = xf.abs().amax(dim=1) + 1e-12
    k0, k1 = _split_keys(keys, xf.device)
    return terngrad_pack(xf, k0, k1, scales), scales


def terngrad_unpack_units(words, scales, d: int) -> torch.Tensor:
    """Fused TernGrad decode: words + payload scales -> (n, d) f32."""
    return terngrad_unpack(words.contiguous(),
                           scales.to(torch.float32).contiguous(), d)


def terngrad_unpack_ef_units(words, scales, e2d, d: int):
    """TernGrad decode + EF residual (caller-side subtract) -> (xhat, m)."""
    xhat = terngrad_unpack_units(words, scales, d)
    return xhat, e2d.to(torch.float32) - xhat


def sign_pack_units(x2d) -> torch.Tensor:
    """Fused signSGD encode: (n, d) f32 -> (n, words_per_unit(d, 1)) int32
    sign words (bit = x >= 0). No statistic, no randomness."""
    return sign_pack(x2d.to(torch.float32).contiguous())


def sign_unpack_units(words, d: int) -> torch.Tensor:
    """Fused signSGD decode: sign words -> (n, d) f32 in {-1, +1}."""
    return sign_unpack(words.contiguous(), d)


def sign_unpack_ef_units(words, e2d, d: int):
    """signSGD decode + EF residual (caller-side subtract) -> (xhat, m)."""
    xhat = sign_unpack_units(words, d)
    return xhat, e2d.to(torch.float32) - xhat


def fields_pack_units(f2d, width: int) -> torch.Tensor:
    """Word-wise field packing of a bucket: (n, k) int fields (values
    < 2**width) -> (n, words_per_unit(k, width)) int32 words, each unit's
    leg separately word-padded with zero bits (the wire padding rule)."""
    return fields_pack(f2d.to(torch.int32).contiguous(), width)


def fields_unpack_units(words, k: int, width: int) -> torch.Tensor:
    """Inverse of fields_pack_units -> (n, k) int32."""
    return fields_unpack(words.contiguous(), k, width)


def pack_fields(vals, width: int) -> torch.Tensor:
    """(k,) int fields -> (words_per_unit(k, width),) int32 words."""
    return fields_pack_units(vals[None], width)[0]


def unpack_fields(words, k: int, width: int) -> torch.Tensor:
    """Inverse of pack_fields -> (k,) int32."""
    return fields_unpack_units(words[None], k, width)[0]


# ---- bytes moved: what each kernel must read and write for one bucket ------

# per-unit 4-byte words a kernel reads beside its data: QSGD / TernGrad pack
# read two key words and the statistic, their unpack the factor; the sign
# and field kernels read none
_PACK_UNIT_WORDS = {"qsgd": 3, "terngrad": 3, "sign": 0, "fields": 0}
_UNPACK_UNIT_WORDS = {"qsgd": 1, "terngrad": 1, "sign": 0, "fields": 0}


def pack_bytes_moved(n: int, d: int, width: int,
                     family: str = "qsgd") -> Dict[str, int]:
    """One pack launch over an (n, d) bucket: the 4-byte units (f32 values
    or int32 fields) and the per-unit words read once, the packed words
    written once."""
    return {"read": 4 * n * d + 4 * _PACK_UNIT_WORDS[family] * n,
            "write": 4 * n * words_per_unit(d, width)}


def unpack_bytes_moved(n: int, d: int, width: int,
                       family: str = "qsgd") -> Dict[str, int]:
    """One unpack launch: the packed words and the per-unit words read
    once, the 4-byte units written once (the EF subtract is a separate
    pass)."""
    return {"read": (4 * n * words_per_unit(d, width)
                     + 4 * _UNPACK_UNIT_WORDS[family] * n),
            "write": 4 * n * d}
