"""Row-wise RMSNorm: the wrapper of the CUDA kernel in csrc/rmsnorm.cu and
its plain-torch version (ref.rmsnorm_ref); the same routing, checks and
launch counter as kernels/qsgd.py. The kernel takes f32 or bf16 rows whose
width is a multiple of 128, through 16-byte loads and stores: x and gamma
must start on a 16-byte boundary (a view with a storage offset may not;
the wrapper raises)."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.qsgd import (_check, _launch_args, _on_card,
                                      kernel_bytes)

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
VEC_BYTES = 16
#: vectors a thread keeps in registers at most, and the block sizes
#: (csrc/rmsnorm.cu: VPT templates 1..8, kMaxThreads)
MAX_VECS = 8
ROW_THREADS = 128
MAX_THREADS = 512


def launch_plan(D: int, elt: int) -> Tuple[str, int, int]:
    """(variant, threads a block, vectors a thread) for rows of D elements
    of `elt` bytes: 128 threads with as many 16-byte vectors each as the
    row needs ("registers"); past 8 vectors, more threads, up to 512; a
    wider row takes the looped kernel (vectors 0)."""
    nvec = D * elt // VEC_BYTES
    vpt = min(MAX_VECS, -(-nvec // ROW_THREADS))
    threads = 32 * -(-(-(-nvec // vpt)) // 32)
    if threads <= MAX_THREADS:
        return "registers", threads, vpt
    return "looped", MAX_THREADS, 0


def check_aligned(t: torch.Tensor, name: str) -> None:
    """Raise unless t's data starts on a 16-byte boundary."""
    if t.data_ptr() % VEC_BYTES:
        raise ValueError(
            f"{name}: the kernel's 16-byte loads need a 16-byte aligned "
            f"start, got address {t.data_ptr():#x} (storage offset "
            f"{t.storage_offset()}); pass a copy (.clone())")


def rmsnorm_plain(x, gamma, eps: float = 1e-5) -> torch.Tensor:
    return ref.rmsnorm_ref(x, gamma, eps)


def rmsnorm(x, gamma, eps: float = 1e-5) -> torch.Tensor:
    """x (R, D) f32 or bf16, gamma (D,) -> (R, D) in x's dtype:
    x * rsqrt(mean(x * x) + eps) * gamma, computed in f32. The variant the
    last launch took is `rmsnorm.variant`."""
    if not _on_card(x, gamma):
        return rmsnorm_plain(x, gamma, eps)
    R, D = x.shape
    if x.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"x: the kernel takes f32 or bf16, got {x.dtype}")
    if D % 128:
        raise ValueError(f"D = {D} is not a multiple of 128")
    _check(x, "x", x.dtype, (R, D))
    g = gamma.to(torch.float32).contiguous()
    _check(g, "gamma", torch.float32, (D,))
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    for t, name in ((x, "x"), (g, "gamma"), (out, "out")):
        check_aligned(t, name)
    variant, threads, vpt = launch_plan(D, x.element_size())
    if not kernel_bytes(rmsnorm, [x, g, out]):
        return out
    build.check(build.library("rmsnorm").rmsnorm(
        x.data_ptr(), g.data_ptr(), out.data_ptr(), R, D,
        int(x.dtype == torch.bfloat16), vpt, threads, eps,
        *_launch_args(x.device)), "rmsnorm")
    rmsnorm.launches += 1
    rmsnorm.variant = variant
    return out


rmsnorm.launches = 0
rmsnorm.variant = None
