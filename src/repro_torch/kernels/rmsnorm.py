"""Row-wise RMSNorm: the wrapper of the CUDA kernel in csrc/rmsnorm.cu and
its plain-torch version (ref.rmsnorm_ref); the same routing, checks and
launch counter as kernels/qsgd.py. The kernel takes f32 or bf16 rows whose
width is a multiple of 128."""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.qsgd import _check, _launch_args, _on_card

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def rmsnorm_plain(x, gamma, eps: float = 1e-5) -> torch.Tensor:
    return ref.rmsnorm_ref(x, gamma, eps)


def rmsnorm(x, gamma, eps: float = 1e-5) -> torch.Tensor:
    """x (R, D) f32 or bf16, gamma (D,) -> (R, D) in x's dtype:
    x * rsqrt(mean(x * x) + eps) * gamma, computed in f32."""
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
    build.check(build.library("rmsnorm").rmsnorm(
        x.data_ptr(), g.data_ptr(), out.data_ptr(), R, D,
        int(x.dtype == torch.bfloat16), eps, *_launch_args(x.device)),
        "rmsnorm")
    rmsnorm.launches += 1
    return out


rmsnorm.launches = 0
