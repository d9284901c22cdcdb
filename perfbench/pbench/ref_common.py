"""Pieces the plain references share: the leaf declaration, float32 and
float8 matrix products, RMSNorm and the chunked cross-entropy."""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch
import torch.utils.checkpoint

NORMAL, ONES, ZEROS = "normal", "ones", "zeros"
# tokens whose logits are taken at a time
XENT_CHUNK = 2048
# the largest finite float8 e4m3 value
FP8_MAX = 448.0


class Leaf(NamedTuple):
    shape: Tuple[int, ...]
    init: str
    std: Optional[float] = None


def padded_vocab(c: dict) -> int:
    """The embedding's rows: the vocabulary rounded up to 128."""
    return -(-c["vocab_size"] // 128) * 128


def plain_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a @ b


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """t scaled by its own largest magnitude onto float8 e4m3's range,
    rounded to float8 and scaled back (the per-tensor scaling of float8
    matrix products); the gradient passes straight through."""
    amax = t.detach().abs().amax().clamp_min(1e-30)
    s = FP8_MAX / amax
    q = (t.detach() * s).to(torch.float8_e4m3fn).to(t.dtype) / s
    return t + (q - t.detach())


def fp8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The product of both operands rounded to float8 e4m3."""
    return fp8_round(a) @ fp8_round(b)


def rmsnorm(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * g


def _chunk_nll(x: torch.Tensor, head: torch.Tensor, t: torch.Tensor,
               vocab: int, mm: Callable) -> torch.Tensor:
    logits = mm(x, head[:, :vocab])
    return torch.nn.functional.cross_entropy(logits, t, reduction="sum")


def xent_sum(x: torch.Tensor, head: torch.Tensor, targets: torch.Tensor,
             vocab: int, mm: Callable) -> torch.Tensor:
    """Summed cross-entropy of x (T, d) @ head (d, >= vocab) over the
    first `vocab` columns, XENT_CHUNK tokens at a time (each chunk's
    logits recomputed in the backward)."""
    total = x.new_zeros(())
    for s in range(0, x.shape[0], XENT_CHUNK):
        total = total + torch.utils.checkpoint.checkpoint(
            _chunk_nll, x[s:s + XENT_CHUNK], head,
            targets[s:s + XENT_CHUNK], vocab, mm, use_reentrant=False)
    return total
