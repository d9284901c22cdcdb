"""Block-local top-k mask: the wrapper of the CUDA kernel in
csrc/topk_mask.cu and its plain-torch version (ref.topk_mask_ref).

Each 512-wide row keeps its entries with |x| at or above the threshold
that 24 bisection halvings of [0, row max] find for k; the same routing,
checks and launch counter as kernels/qsgd.py."""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.qsgd import _check, _launch_args, _on_card

BLOCK_C = 512


def topk_mask_plain(x, k: int) -> torch.Tensor:
    return ref.topk_mask_ref(x, k)


def topk_mask(x, k: int) -> torch.Tensor:
    """x (R, 512) f32 -> (R, 512) f32: each row's top-k by magnitude kept
    (ties at the threshold keep more), the rest 0."""
    if not _on_card(x):
        return topk_mask_plain(x, k)
    R = x.shape[0]
    _check(x, "x", torch.float32, (R, BLOCK_C))
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    build.check(build.library("topk_mask").topk_mask(
        x.data_ptr(), out.data_ptr(), R, k, *_launch_args(x.device)),
        "topk_mask")
    topk_mask.launches += 1
    return out


topk_mask.launches = 0
