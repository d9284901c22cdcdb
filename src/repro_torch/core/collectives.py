"""The collectives compressed_allreduce runs across ranks, on a
torch.distributed process group (the reference's jax.lax.all_gather /
psum / psum_scatter inside shard_map).

Every collective is an all_gather of raw bytes followed by arithmetic in
rank order, so a rank's result depends on its peers' data only, never on
a backend's reduction order: `rank_mean` sums ((x_0 + x_1) + x_2) + ...
then divides by n, exactly as aggregation.worker_mean does over a worker
axis on one device. Neither gloo's nor NCCL's all_reduce fixes its
summation order, and gloo has no reduce_scatter.

Tensors travel as uint8 views, so any dtype crosses any backend. gloo
takes CUDA tensors directly (it stages them through host memory itself);
NCCL needs one card per rank.

`all_gather.sent_bytes` / `.recv_bytes` / `.calls` count what the
collectives move since the last `reset_counts()`: a rank contributes its
tensor once (sent) and receives the n - 1 others' (recv); `.seconds` is
the host wall time spent inside the all_gather calls.
"""
from __future__ import annotations

import time
from typing import Dict

import torch
import torch.distributed as dist


def all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's `t` (same shape and dtype on all ranks) stacked in rank
    order -> (n, *t.shape), on t's device."""
    n = dist.get_world_size(group)
    raw = t.contiguous().reshape(-1).view(torch.uint8)
    out = torch.empty((n * raw.numel(),), dtype=torch.uint8,
                      device=t.device)
    t0 = time.perf_counter()
    dist.all_gather_into_tensor(out, raw, group=group)
    all_gather.seconds += time.perf_counter() - t0
    all_gather.calls += 1
    all_gather.sent_bytes += raw.numel()
    all_gather.recv_bytes += (n - 1) * raw.numel()
    return out.view(n, -1).view(t.dtype).reshape((n,) + tuple(t.shape))


def counts() -> Dict[str, float]:
    """Collective calls, bytes and host seconds since the last reset."""
    return {"calls": all_gather.calls, "sent_bytes": all_gather.sent_bytes,
            "recv_bytes": all_gather.recv_bytes,
            "seconds": all_gather.seconds}


def reset_counts() -> None:
    all_gather.calls = all_gather.sent_bytes = all_gather.recv_bytes = 0
    all_gather.seconds = 0.0


reset_counts()


def rank_sum(g: torch.Tensor) -> torch.Tensor:
    """Sum over the leading rank axis in rank order."""
    acc = g[0]
    for i in range(1, g.shape[0]):
        acc = acc + g[i]
    return acc


def rank_mean(x: torch.Tensor, group=None) -> torch.Tensor:
    """The mean of `x` over the ranks, summed in rank order, then divided by
    n: bit for bit the worker mean of the simulated-worker harness."""
    g = all_gather(x, group)
    return rank_sum(g) / g.shape[0]
