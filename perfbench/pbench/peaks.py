"""The yardstick's peaks and the least work of each wire kernel.

Peaks of one NVIDIA H100 SXM at 700 W (data sheet; the int32 rate
derived from the Hopper whitepaper): 989 TFLOP/s dense bf16, 67 TFLOP/s
f32 outside the tensor cores, 3.35 TB/s of HBM, and 132 SMs x 64 int32
lanes x 1.98 GHz of integer operations.

A kernel's least time over a step is the larger of its bytes over the
HBM rate and its operations over their rates, counted from the cell's
shapes and the algorithm alone, whatever implements it:
  - a pack reads the gradient's entries once in the parameters' dtype and
    writes the payload once at the codec's width (whole 32-bit words a
    unit, and QSGD's 32-bit norm);
  - an unpack reads the payload once and writes the entries once in the
    parameters' dtype;
  - operations: the threefry2x32 hash for each pair of draws
    (THREEFRY_INT_OPS), and ELEMENT_OPS' integer and f32 operations an
    entry (the rounding, the code and its place in the word).
The top-k index leg's pack and unpack read and write its k indices as
32-bit fields and the packed index words (ceil(log2 d) bits a field).
The counts are frozen copies of chip_smoke.py's `bounds`, ELEMENT_OPS
and THREEFRY_INT_OPS and of the byte model of kernels/ops.py, with the
entries counted in the parameters' dtype.
"""
from __future__ import annotations

from typing import Iterable, Tuple

BF16_FLOPS_PER_S = 989e12
FP32_OPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# 20 rounds of add / rotate / xor, 5 key injections of 3 adds, the 2
# initial adds and the parity xor
THREEFRY_INT_OPS = 20 * 3 + 5 * 3 + 2 + 2
# (int32, f32) operations an entry beyond the hash
ELEMENT_OPS = {"qsgd_pack": (3, 7), "qsgd_unpack": (4, 2),
               "fields_pack": (3, 0), "fields_unpack": (4, 0)}
HASHING = ("qsgd_pack",)
DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def qsgd_width(levels: int) -> int:
    """Bits of a QSGD code: offset-binary levels in [0, 2s]."""
    return max(2, (2 * levels).bit_length())


def index_width(d: int) -> int:
    """Bits of a sparse index into d entries: ceil(log2 d), at least 1."""
    return max(1, (d - 1).bit_length()) if d > 1 else 1


def topk_k(ratio: float, d: int) -> int:
    return max(1, min(d, int(round(ratio * d))))


def _words(n: int, width: int) -> int:
    return -(-n * width // 32)


def kernel_work(kernel: str, dims: Iterable[int], workers: int,
                elt_bytes: int, levels: int = 16,
                ratio: float = 0.01) -> Tuple[float, float, float]:
    """(bytes, int32 ops, f32 ops) of one step's launches of `kernel`
    over units of `dims` entries for each of `workers`."""
    nbytes = iops = fops = 0.0
    per_int, per_fp = ELEMENT_OPS[kernel]
    for d in dims:
        if kernel.startswith("qsgd"):
            payload = 4 * _words(d, qsgd_width(levels)) + 4
            nbytes += elt_bytes * d + payload
            n = d
        else:
            k = topk_k(ratio, d)
            nbytes += 4 * k + 4 * _words(k, index_width(d))
            n = k
        iops += per_int * n
        fops += per_fp * n
        if kernel in HASHING:
            iops += -(-d // 2) * THREEFRY_INT_OPS
    return workers * nbytes, workers * iops, workers * fops


def least_seconds(kernel: str, dims: Iterable[int], workers: int,
                  elt_bytes: int, **kw) -> Tuple[float, str]:
    """(least seconds a step, "bytes" or "operations", whichever bounds)."""
    nbytes, iops, fops = kernel_work(kernel, dims, workers, elt_bytes, **kw)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = iops / INT32_OPS_PER_S + fops / FP32_OPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
