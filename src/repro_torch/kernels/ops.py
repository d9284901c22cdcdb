"""The kernels' entry points (the JAX package's kernels/ops.py).

The compress-only path (ops.py:37-198, 665-679): `qsgd_compress`,
`terngrad_compress` and `blockwise_topk` over a whole input, the
bucket-level `qsgd_compress_units` / `terngrad_compress_units`,
`plan_compress` (one kernel launch for every UnitPlan bucket) and
`rmsnorm`. Inputs of any float dtype are computed in f32 and cast back.

The bucket entry points of the fused compress+pack kernels: what the wire
codecs (core/wire.py) call (the reference's ops.py:274-522), each with a
grouped form that takes every bucket of a step in one launch: the QSGD
pack and unpack (`qsgd_pack_units_buckets`, `qsgd_unpack_units_buckets`),
the TernGrad pack and unpack (`terngrad_pack_units_buckets`,
`terngrad_unpack_units_buckets`), the sign pack and unpack
(`sign_pack_units_buckets`, `sign_unpack_units_buckets`), the field pack
and unpack of the natural and sparse codecs and of the per-unit QSGD /
TernGrad decode (`fields_pack_units_buckets`,
`fields_unpack_units_buckets`), the bit pack and unpack of the per-unit
signSGD encode and decode (`pack_words_buckets`, `unpack_words_buckets`)
and the majority vote (`majority_words_buckets`). The one-bucket entry
points are the grouped calls with one bucket.

A bucket is an (n, d) f32 matrix whose rows are compression units. The
caller-side pieces stay here, outside the kernels, exactly as in the
reference: the per-unit statistic (l2 norm or max|x|, + 1e-12), the
division nrm / levels of the QSGD decode (ops.py:372) and the
error-feedback subtract m = e - xhat after decode (ops.py:383-395).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels.pack import (bits_pack, bits_pack_buckets,
                                      bits_unpack, bits_unpack_buckets,
                                      fields_pack, fields_pack_buckets,
                                      fields_unpack, fields_unpack_buckets)
from repro_torch.kernels.qsgd import (qsgd_compress_buckets,
                                      qsgd_pack_buckets, qsgd_unpack_buckets)
from repro_torch.kernels.ref import words_per_unit, words_to_i32
from repro_torch.kernels.rmsnorm import rmsnorm as rmsnorm_rows
from repro_torch.kernels.sign import (majority, majority_buckets,
                                      sign_pack_buckets, sign_unpack_buckets)
from repro_torch.kernels.terngrad import (terngrad_compress_buckets,
                                          terngrad_pack_buckets,
                                          terngrad_unpack_buckets)
from repro_torch.kernels.topk_mask import BLOCK_C, topk_mask_flat
from repro_torch.kernels.topk_mask import KERNEL_DTYPES as TOPK_DTYPES

__all__ = ["qsgd_compress", "terngrad_compress", "blockwise_topk",
           "qsgd_compress_units", "terngrad_compress_units", "plan_compress",
           "rmsnorm", "words_per_unit", "qsgd_pack_units",
           "qsgd_pack_units_buckets", "qsgd_unpack_units",
           "qsgd_unpack_units_buckets", "qsgd_unpack_ef_units",
           "terngrad_pack_units", "terngrad_pack_units_buckets",
           "terngrad_unpack_units", "terngrad_unpack_units_buckets",
           "terngrad_unpack_ef_units", "sign_pack_units",
           "sign_pack_units_buckets", "sign_unpack_units",
           "sign_unpack_units_buckets", "sign_unpack_ef_units",
           "fields_pack_units", "fields_pack_units_buckets",
           "fields_unpack_units", "fields_unpack_units_buckets",
           "pack_fields", "unpack_fields", "pack_words",
           "pack_words_buckets", "unpack_words", "unpack_words_buckets",
           "majority_words", "majority_words_buckets", "chunk_runs",
           "pack_bytes_moved", "unpack_bytes_moved", "majority_bytes_moved"]


# ---- compress only: whole inputs ---------------------------------------------

# The reference tiles a flat input into rows of BLOCK_C lanes, rounded up to
# a multiple of BLOCK_R rows, and draws its noise over that whole tile. Every
# uniform depends on the number drawn (prng.py), so the port draws with the
# same length: a whole input of d elements is one unit whose uniforms span
# WHOLE_DRAW * ceil(d / WHOLE_DRAW) positions, a UnitPlan unit's its rows
# of BLOCK_C lanes (BLOCK_C * ceil(d / BLOCK_C), reference ops.py:115-120).
BLOCK_R = 256
WHOLE_DRAW = BLOCK_R * BLOCK_C


def draw_length(d: int, granule: int) -> int:
    """The reference's draw over d elements padded to whole `granule`s."""
    return granule * -(-d // granule)


def _compress_buckets(kind: str, x2ds, keys_list, granule: int, **kw):
    """Compress (n, d) buckets, each unit against its own statistic (l2
    norm for "qsgd", max|x| for "terngrad") with its own (2,) key, the
    uniforms drawn over draw_length(d, granule): ONE kernel launch for up
    to MAX_BUCKETS buckets -> the (n, d) f32 outputs."""
    xfs = [x.to(torch.float32).contiguous() for x in x2ds]
    ks = [_split_keys(k, xf.device) for k, xf in zip(keys_list, xfs)]
    draws = [draw_length(xf.shape[1], granule) for xf in xfs]
    k0s, k1s = [k[0] for k in ks], [k[1] for k in ks]
    if kind == "qsgd":
        norms = [torch.linalg.vector_norm(xf, dim=1) for xf in xfs]
        return qsgd_compress_buckets(xfs, k0s, k1s, norms, draws,
                                     kw.get("levels", 16))
    scales = [xf.abs().amax(dim=1) for xf in xfs]
    return terngrad_compress_buckets(xfs, k0s, k1s, scales, draws)


def qsgd_compress(x, key, levels: int = 16) -> torch.Tensor:
    """QSGD quantize+dequantize over the WHOLE input against its one l2
    norm (the caller picks the granularity unit, per the paper); key is a
    (2,) key. One kernel launch."""
    out = _compress_buckets("qsgd", [x.reshape(1, -1)], [key[None]],
                            WHOLE_DRAW, levels=levels)[0]
    return out.reshape(x.shape).to(x.dtype)


def terngrad_compress(x, key) -> torch.Tensor:
    """TernGrad quantize+dequantize over the whole input against its one
    max|x|. One kernel launch."""
    out = _compress_buckets("terngrad", [x.reshape(1, -1)], [key[None]],
                            WHOLE_DRAW)[0]
    return out.reshape(x.shape).to(x.dtype)


def blockwise_topk(x, k_per_block: int) -> torch.Tensor:
    """Block-local top-k: each BLOCK_C-element row of the flat input keeps
    its k largest magnitudes (the last row zero-padded, as the reference
    pads it). One kernel launch: topk_mask_flat takes f32 and bf16 as
    they are and pads the last row itself; other dtypes are cast to f32
    and back."""
    if x.dtype not in TOPK_DTYPES:
        return topk_mask_flat(x.float().contiguous(), k_per_block).to(x.dtype)
    return topk_mask_flat(x.contiguous(), k_per_block)


# ---- compress only: UnitPlan buckets ----------------------------------------

def qsgd_compress_units(x2d, keys, levels: int = 16) -> torch.Tensor:
    """QSGD over a whole bucket: rows of x2d are compression units, each
    against its own l2 norm, keys (n, 2) one key per unit. One launch
    whatever the number of units (plan_compress's one-bucket form)."""
    return _compress_buckets("qsgd", [x2d], [keys], BLOCK_C,
                             levels=levels)[0].to(x2d.dtype)


def terngrad_compress_units(x2d, keys) -> torch.Tensor:
    """TernGrad over a whole bucket (each unit against its own max|x|)."""
    return _compress_buckets("terngrad", [x2d], [keys],
                             BLOCK_C)[0].to(x2d.dtype)


def plan_compress(plan, grads, key, kind: str = "qsgd", **kw):
    """Compress a gradient tree through the kernels, driven by a
    core.plan.UnitPlan: gather every bucket, ONE kernel launch for all of
    them (up to MAX_BUCKETS a launch), scatter every bucket back. The unit
    keys are the plan's (those of plan.execute), but the draws span each
    unit's rows of BLOCK_C lanes, so the result is the same operator
    family as plan.execute(comp.sim, ...), not bit for bit the same
    numbers (as in the reference)."""
    if kind not in ("qsgd", "terngrad"):
        raise ValueError(f"no bucket kernel for {kind!r}; "
                         f"have ['qsgd', 'terngrad']")
    flat = plan.flatten(grads)
    keys = plan.unit_keys(key).to(flat.device)
    ys = _compress_buckets(kind, [plan.gather_bucket(flat, b)
                                  for b in plan.buckets],
                           [keys[list(b.unit_ids)] for b in plan.buckets],
                           BLOCK_C, **kw)
    out = torch.zeros_like(flat)
    for b, y in zip(plan.buckets, ys):
        plan.scatter_bucket(out, b, y)
    return plan.unflatten(out)


def rmsnorm(x, gamma, eps: float = 1e-5) -> torch.Tensor:
    """(..., D) row-wise RMSNorm with D % 128 == 0, in x's dtype. One
    launch."""
    D = x.shape[-1]
    if D % 128:
        raise ValueError(f"rmsnorm needs D % 128 == 0, got D = {D}")
    return rmsnorm_rows(x.reshape(-1, D).contiguous(), gamma,
                        eps).reshape(x.shape)


# ---- wire: fused compress+pack bucket entry points ---------------------------

def _split_keys(keys: torch.Tensor, device):
    """(n, 2) int64 key data -> the kernels' two (n,) int32 key-word
    columns on `device`."""
    kw = words_to_i32(keys.to(device))
    return kw[:, 0].contiguous(), kw[:, 1].contiguous()


def qsgd_pack_units(x2d, keys, levels: int, width: int):
    """Fused QSGD encode of a bucket: (n, d) f32 + (n, 2) unit keys ->
    ((n, words_per_unit(d, width)) int32 words, (n,) f32 norms). The norms
    include the compressor's +1e-12 and are exactly the payload norm field."""
    return qsgd_pack_units_buckets([x2d], [keys], levels, width)[0]


def qsgd_pack_units_buckets(x2ds, keys_list, levels: int, width: int):
    """qsgd_pack_units over many buckets at one (levels, width) ->
    [(words, nrms)] per bucket; the packing is ONE kernel launch for up to
    MAX_BUCKETS buckets (kernels/qsgd.py qsgd_pack_buckets)."""
    xfs = [x.to(torch.float32).contiguous() for x in x2ds]
    nrms = [torch.linalg.vector_norm(xf, dim=1) + 1e-12 for xf in xfs]
    ks = [_split_keys(k, xf.device) for k, xf in zip(keys_list, xfs)]
    words = qsgd_pack_buckets(xfs, [k[0] for k in ks], [k[1] for k in ks],
                              nrms, levels, width)
    return list(zip(words, nrms))


def qsgd_unpack_units(words, nrms, d: int, levels: int,
                      width: int) -> torch.Tensor:
    """Fused QSGD decode: words + payload norms -> (n, d) f32."""
    return qsgd_unpack_units_buckets([words], [nrms], [d], levels, width)[0]


def qsgd_unpack_units_buckets(words_list, nrms_list, dims, levels: int,
                              width: int) -> list:
    """qsgd_unpack_units over many buckets at one (levels, width) -> [(n_i,
    d_i) f32]; ONE kernel launch for up to MAX_BUCKETS buckets
    (kernels/qsgd.py qsgd_unpack_buckets). The factors nrm / levels of
    every bucket come from one elementwise f32 divide, the same rounding
    as a divide per bucket."""
    if not words_list:
        return []
    nrms = [n.to(torch.float32) for n in nrms_list]
    facs = (torch.cat(nrms) / levels).split([n.shape[0] for n in nrms])
    return qsgd_unpack_buckets([w.contiguous() for w in words_list],
                               list(facs), dims, levels, width)


def qsgd_unpack_ef_units(words, nrms, e2d, d: int, levels: int, width: int):
    """QSGD decode + error-feedback residual m = e - xhat, the subtract in
    the caller (one unpack launch + one elementwise pass) -> (xhat, m)."""
    xhat = qsgd_unpack_units(words, nrms, d, levels, width)
    return xhat, e2d.to(torch.float32) - xhat


def terngrad_pack_units(x2d, keys):
    """Fused TernGrad encode: (n, d) f32 + unit keys -> ((n,
    words_per_unit(d, 2)) int32 words, (n,) f32 scales incl. +1e-12)."""
    return terngrad_pack_units_buckets([x2d], [keys])[0]


def terngrad_pack_units_buckets(x2ds, keys_list):
    """terngrad_pack_units over many buckets -> [(words, scales)] per
    bucket; the packing is ONE kernel launch for up to MAX_BUCKETS buckets
    (kernels/terngrad.py terngrad_pack_buckets)."""
    xfs = [x.to(torch.float32).contiguous() for x in x2ds]
    scales = [xf.abs().amax(dim=1) + 1e-12 for xf in xfs]
    ks = [_split_keys(k, xf.device) for k, xf in zip(keys_list, xfs)]
    words = terngrad_pack_buckets(xfs, [k[0] for k in ks],
                                  [k[1] for k in ks], scales)
    return list(zip(words, scales))


def terngrad_unpack_units(words, scales, d: int) -> torch.Tensor:
    """Fused TernGrad decode: words + payload scales -> (n, d) f32."""
    return terngrad_unpack_units_buckets([words], [scales], [d])[0]


def terngrad_unpack_units_buckets(words_list, scales_list, dims) -> list:
    """terngrad_unpack_units over many buckets -> [(n_i, d_i) f32]; ONE
    kernel launch for up to MAX_BUCKETS buckets (kernels/terngrad.py
    terngrad_unpack_buckets)."""
    return terngrad_unpack_buckets(
        [w.contiguous() for w in words_list],
        [s.to(torch.float32).contiguous() for s in scales_list], dims)


def terngrad_unpack_ef_units(words, scales, e2d, d: int):
    """TernGrad decode + EF residual (caller-side subtract) -> (xhat, m)."""
    xhat = terngrad_unpack_units(words, scales, d)
    return xhat, e2d.to(torch.float32) - xhat


def sign_pack_units(x2d) -> torch.Tensor:
    """Fused signSGD encode: (n, d) f32 -> (n, words_per_unit(d, 1)) int32
    sign words (bit = x >= 0). No statistic, no randomness."""
    return sign_pack_units_buckets([x2d])[0]


def sign_pack_units_buckets(x2ds) -> list:
    """sign_pack_units over many buckets -> [(n_i, words_per_unit(d_i, 1))
    int32 words]; ONE kernel launch for up to MAX_BUCKETS buckets
    (kernels/sign.py sign_pack_buckets)."""
    return sign_pack_buckets([x.to(torch.float32).contiguous()
                              for x in x2ds])


def sign_unpack_units(words, d: int) -> torch.Tensor:
    """Fused signSGD decode: sign words -> (n, d) f32 in {-1, +1}."""
    return sign_unpack_units_buckets([words], [d])[0]


def sign_unpack_units_buckets(words_list, dims) -> list:
    """sign_unpack_units over many buckets -> [(n_i, d_i) f32 in {-1,
    +1}]; ONE kernel launch for up to MAX_BUCKETS buckets (kernels/sign.py
    sign_unpack_buckets)."""
    return sign_unpack_buckets([w.contiguous() for w in words_list], dims)


def sign_unpack_ef_units(words, e2d, d: int):
    """signSGD decode + EF residual (caller-side subtract) -> (xhat, m)."""
    xhat = sign_unpack_units(words, d)
    return xhat, e2d.to(torch.float32) - xhat


def fields_pack_units(f2d, width: int) -> torch.Tensor:
    """Word-wise field packing of a bucket: (n, k) int fields (values
    < 2**width) -> (n, words_per_unit(k, width)) int32 words, each unit's
    leg separately word-padded with zero bits (the wire padding rule)."""
    return fields_pack(f2d.to(torch.int32).contiguous(), width)


def fields_pack_units_buckets(f2ds, widths) -> list:
    """fields_pack_units over many buckets, bucket i at widths[i] -> [(n_i,
    words_per_unit(k_i, widths[i])) int32 words]; ONE kernel launch for up
    to MAX_BUCKETS buckets (kernels/pack.py fields_pack_buckets)."""
    return fields_pack_buckets([f.to(torch.int32).contiguous() for f in f2ds],
                               widths)


def fields_unpack_units(words, k: int, width: int) -> torch.Tensor:
    """Inverse of fields_pack_units -> (n, k) int32."""
    return fields_unpack(words.contiguous(), k, width)


def fields_unpack_units_buckets(words_list, ks, widths) -> list:
    """fields_unpack_units over many buckets -> [(n_i, ks[i]) int32]; ONE
    kernel launch for up to MAX_BUCKETS buckets."""
    return fields_unpack_buckets([w.contiguous() for w in words_list], ks,
                                 widths)


def pack_fields(vals, width: int) -> torch.Tensor:
    """(k,) int fields -> (words_per_unit(k, width),) int32 words."""
    return fields_pack_units(vals[None], width)[0]


def unpack_fields(words, k: int, width: int) -> torch.Tensor:
    """Inverse of pack_fields -> (k,) int32."""
    return fields_unpack_units(words[None], k, width)[0]


def pack_words(bits) -> torch.Tensor:
    """(n, d) {0,1} int bits -> (n, words_per_unit(d, 1)) int32 words, bit p
    in word p // 32 at position p % 32 (the reference's ops.pack_words,
    ops.py:211, with a leading batch of rows)."""
    return bits_pack(bits.to(torch.int32).contiguous())


def pack_words_buckets(bits_list) -> list:
    """pack_words over many buckets -> [(n_i, words_per_unit(d_i, 1)) int32
    words]; ONE kernel launch for up to MAX_BUCKETS buckets
    (kernels/pack.py bits_pack_buckets)."""
    return bits_pack_buckets([b.to(torch.int32).contiguous()
                              for b in bits_list])


def unpack_words(words, d: int) -> torch.Tensor:
    """Inverse of pack_words: (n, words_per_unit(d, 1)) int32 words -> the
    first d bits of each row as (n, d) int32 {0, 1} (ops.py:239)."""
    return bits_unpack(words.contiguous(), d)


def unpack_words_buckets(words_list, dims) -> list:
    """unpack_words over many buckets -> [(n_i, dims[i]) int32 {0, 1}];
    ONE kernel launch for up to MAX_BUCKETS buckets (kernels/pack.py
    bits_unpack_buckets)."""
    return bits_unpack_buckets([w.contiguous() for w in words_list], dims)


def majority_words(words) -> torch.Tensor:
    """(n_workers, W) int32 packed sign words -> (W,) majority-vote words
    (ties -> +1), counted on the packed words: the {0,1} bit tensor never
    exists (ops.py:525)."""
    return majority(words.contiguous())


def majority_words_buckets(words_list) -> list:
    """majority_words over many buckets, bucket i (n_i, W_i) words of n_i
    workers -> [(W_i,) majority-vote words]; ONE kernel launch for up to
    MAX_BUCKETS buckets (kernels/sign.py majority_buckets)."""
    return majority_buckets([w.contiguous() for w in words_list])


# ---- chunk-granular dispatch (the streaming collective's unit of wire motion)

def chunk_runs(sizes, chunk_bytes):
    """Partition consecutive payload regions into dispatch chunks (the
    reference's ops.py:542).

    `sizes` are per-region byte counts (one fused message's per-bucket
    payload regions, in buffer order); the return value is a tuple of
    runs, tuples of region indices covering 0..len(sizes)-1 in order. A
    run accumulates consecutive regions until its bytes reach
    `chunk_bytes`, then closes (build_schedule's greedy rule one level
    down). `chunk_bytes` None, NaN or inf means one chunk for the whole
    message; 0 one chunk per region. Regions are never split, so every
    chunk decodes with whole-bucket unpack launches the hop it arrives.
    """
    sizes = [int(s) for s in sizes]
    if not sizes:
        return ()
    if chunk_bytes is None or chunk_bytes != chunk_bytes or \
            chunk_bytes == float("inf"):
        return (tuple(range(len(sizes))),)
    cb = float(chunk_bytes)
    if cb < 0:
        raise ValueError(f"chunk_bytes must be >= 0, got {chunk_bytes!r}")
    runs, cur, cur_bytes = [], [], 0
    for i, s in enumerate(sizes):
        cur.append(i)
        cur_bytes += s
        if cur_bytes >= cb:
            runs.append(tuple(cur))
            cur, cur_bytes = [], 0
    if cur:
        runs.append(tuple(cur))
    return tuple(runs)


# ---- bytes moved: what each kernel must read and write for one bucket ------

# per-unit 4-byte words a kernel reads beside its data: QSGD / TernGrad pack
# read two key words and the statistic, their unpack the factor; the sign,
# field and bit kernels read none
_PACK_UNIT_WORDS = {"qsgd": 3, "terngrad": 3, "sign": 0, "fields": 0,
                    "bits": 0}
_UNPACK_UNIT_WORDS = {"qsgd": 1, "terngrad": 1, "sign": 0, "fields": 0,
                      "bits": 0}


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


def majority_bytes_moved(n: int, W: int) -> Dict[str, int]:
    """One majority launch: n workers' W words read once, W words written."""
    return {"read": 4 * n * W, "write": 4 * W}
