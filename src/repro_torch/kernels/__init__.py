"""The port's kernels: threefry (prng.py), the plain tile oracles (ref.py),
the hand-written CUDA pack/unpack and majority-vote kernels (csrc/, built
by build.py) with their wrappers (qsgd.py, terngrad.py, sign.py, pack.py),
and the bucket entry points the wire codecs call (ops.py)."""
from __future__ import annotations

from typing import Dict


def _wrappers():
    from repro_torch.kernels.pack import (bits_pack, bits_unpack,
                                          fields_pack, fields_unpack)
    from repro_torch.kernels.qsgd import qsgd_pack, qsgd_unpack
    from repro_torch.kernels.sign import majority, sign_pack, sign_unpack
    from repro_torch.kernels.terngrad import terngrad_pack, terngrad_unpack
    return (qsgd_pack, qsgd_unpack, terngrad_pack, terngrad_unpack,
            sign_pack, sign_unpack, fields_pack, fields_unpack, bits_pack,
            bits_unpack, majority)


def launch_counts() -> Dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {w.__name__: w.launches for w in _wrappers()}


def reset_launch_counts() -> None:
    for w in _wrappers():
        w.launches = 0
