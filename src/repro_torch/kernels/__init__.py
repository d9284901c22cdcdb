"""The port's kernels: threefry (prng.py), the plain oracles (ref.py), the
hand-written CUDA kernels (csrc/, built by build.py) with their wrappers,
and the entry points (ops.py).

Wrappers, each with a plain version and a `.launches` counter:

- wire pack / unpack: qsgd.py (pack and unpack grouped over up to 32
  buckets a launch, `qsgd_pack_buckets` / `qsgd_unpack_buckets`),
  terngrad.py (pack and unpack grouped likewise,
  `terngrad_pack_buckets` / `terngrad_unpack_buckets`), sign.py (pack,
  unpack and majority vote grouped likewise, `sign_pack_buckets` /
  `sign_unpack_buckets` / `majority_buckets`), pack.py (width-bit fields,
  pack and unpack grouped over up to 32 buckets of mixed widths a launch,
  `fields_pack_buckets` / `fields_unpack_buckets`; and bits, grouped
  likewise, `bits_pack_buckets` / `bits_unpack_buckets`);
- compress only: `qsgd_compress_rows` (qsgd.py), `terngrad_compress_rows`
  (terngrad.py), the one-bucket calls of `qsgd_compress_buckets` /
  `terngrad_compress_buckets` (grouped over up to 32 buckets a launch, the
  uniforms drawn in the kernel), `topk_mask` (topk_mask.py), `rmsnorm`
  (rmsnorm.py).

Exported here, as from the JAX package's `repro.kernels`: `qsgd_compress`,
`terngrad_compress` and `blockwise_topk` (whole inputs) and `rmsnorm`.
`ops` also holds the bucket-level `qsgd_compress_units` /
`terngrad_compress_units` and `plan_compress`, and the wire codecs'
bucket entry points.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.kernels.ops import (blockwise_topk, qsgd_compress, rmsnorm,
                                     terngrad_compress)

__all__ = ["qsgd_compress", "terngrad_compress", "blockwise_topk", "rmsnorm",
           "launch_counts", "reset_launch_counts"]


def _wrappers():
    from repro_torch.kernels.pack import (bits_pack, bits_unpack,
                                          fields_pack, fields_unpack)
    from repro_torch.kernels.qsgd import (qsgd_compress_rows, qsgd_pack,
                                          qsgd_unpack)
    from repro_torch.kernels.sign import majority, sign_pack, sign_unpack
    from repro_torch.kernels.terngrad import (terngrad_compress_rows,
                                              terngrad_pack, terngrad_unpack)
    from repro_torch.kernels.rmsnorm import rmsnorm as rms
    from repro_torch.kernels.topk_mask import topk_mask
    return (qsgd_pack, qsgd_unpack, terngrad_pack, terngrad_unpack,
            sign_pack, sign_unpack, fields_pack, fields_unpack, bits_pack,
            bits_unpack, majority, qsgd_compress_rows,
            terngrad_compress_rows, topk_mask, rms)


def launch_counts() -> Dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {w.__name__: w.launches for w in _wrappers()}


def reset_launch_counts() -> None:
    for w in _wrappers():
        w.launches = 0
