"""The collectives compressed_allreduce runs across ranks, on a
torch.distributed process group (the reference's jax.lax.all_gather /
psum / psum_scatter / ppermute inside shard_map).

Every reduction is a data movement followed by arithmetic in rank order,
so a rank's result depends on its peers' data only, never on a backend's
reduction order: `rank_mean` sums ((x_0 + x_1) + x_2) + ... then divides
by n, exactly as aggregation.worker_mean does over a worker axis on one
device, and `reduce_scatter` gives each rank that rank-order sum of its
own slice. Neither gloo's nor NCCL's all_reduce fixes its summation
order, and gloo has no reduce_scatter.

  all_gather      every rank's tensor, stacked in rank order
  all_reduce      an all_gather, then the rank-order sum (or another
                  reduction over the rank axis): the reference's psum
  reduce_scatter  this rank's slice of the rank-order sum: n - 1
                  point-to-point sends of one slice each way
  ring_shift      the ppermute i -> i + 1 mod n of the streaming
                  collectives: send to rank + 1, receive from rank - 1
  gather_metrics  every rank's tensor in rank order, for a step's metric
                  reductions: not counted below

Tensors travel as uint8 views, so any dtype crosses any backend. gloo
takes CUDA tensors in all_gather_into_tensor (it stages them through host
memory itself) but its send / recv read the raw pointer as host memory,
so the point-to-point collectives stage a CUDA tensor through pinned host
buffers under gloo: an explicit route chosen by backend and device,
counted in `staged_bytes` (both directions). NCCL moves device memory
directly and needs one card per rank.

`counts()` totals what the collectives moved since the last
`reset_counts()`, `counts(name)` one collective's: `calls`, `sent_bytes`
(a rank's bytes put on the wire), `recv_bytes` (bytes it received),
`staged_bytes` (host copies of the gloo route) and `seconds` (host wall
time inside the calls, staging included).

A cost observer (launch/hlo_cost.py StepCost, the dry run's counter) sees
each collective as the reference HLO op it stands for (`observe`: kind,
result bytes, group size), an all_reduce as one all-reduce however it
moves its bytes; the ops a collective dispatches belong to it (`inside`).
On meta tensors (a dry run over PyTorch's fake process group) the
point-to-point collectives move nothing: their receive buffers are
already of the right shape, and nothing is staged through host memory.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

COLLECTIVES = ("all_gather", "reduce_scatter", "ring_shift")
_FIELDS = ("calls", "sent_bytes", "recv_bytes", "staged_bytes", "seconds")
_counts: Dict[str, Dict[str, float]] = {}


def _count(name: str, t0: float, sent: int, recv: int,
           staged: int = 0) -> None:
    c = _counts[name]
    c["seconds"] += time.perf_counter() - t0
    c["calls"] += 1
    c["sent_bytes"] += sent
    c["recv_bytes"] += recv
    c["staged_bytes"] += staged


def counts(name: Optional[str] = None) -> Dict[str, float]:
    """Calls, bytes and host seconds since the last reset: of collective
    `name`, or summed over all of them."""
    if name is not None:
        return dict(_counts[name])
    return {f: sum(_counts[c][f] for c in COLLECTIVES) for f in _FIELDS}


def reset_counts() -> None:
    for c in COLLECTIVES:
        _counts[c] = {f: 0.0 if f == "seconds" else 0 for f in _FIELDS}


reset_counts()

#: the active cost observer (launch/hlo_cost.py StepCost), or None
_observer = None
_depth = 0


def inside() -> bool:
    """True while a collective runs (its ops are the collective's)."""
    return _depth > 0


@contextlib.contextmanager
def observe(kind: str, result_bytes: int, group):
    """Mark the collective that runs inside as the reference HLO op `kind`
    ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute") with a result of `result_bytes` on each rank of
    `group`; the outermost mark wins."""
    global _depth
    if _observer is not None and _depth == 0:
        _observer.collective(kind, int(result_bytes),
                             dist.get_world_size(group))
    _depth += 1
    try:
        yield
    finally:
        _depth -= 1


def _raw(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().reshape(-1).view(torch.uint8)


def all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's `t` (same shape and dtype on all ranks) stacked in rank
    order -> (n, *t.shape), on t's device."""
    n = dist.get_world_size(group)
    with observe("all-gather", n * t.numel() * t.element_size(), group):
        raw = _raw(t)
        out = torch.empty((n * raw.numel(),), dtype=torch.uint8,
                          device=t.device)
        t0 = time.perf_counter()
        dist.all_gather_into_tensor(out, raw, group=group)
        _count("all_gather", t0, raw.numel(), (n - 1) * raw.numel())
        return out.view(n, -1).view(t.dtype).reshape((n,) + tuple(t.shape))


def gather_metrics(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's `x` in rank order -> (n, *x.shape): a step's metric
    reduction (the reference's pmean / pmin), one all-reduce to a cost
    observer, kept out of the wire counters."""
    n = dist.get_world_size(group)
    with observe("all-reduce", x.numel() * x.element_size(), group):
        out = torch.empty((n * x.numel(),), dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, x.reshape(-1).contiguous(),
                                    group=group)
    return out.view((n,) + tuple(x.shape))


def all_reduce(x: torch.Tensor, group=None, reduce=None) -> torch.Tensor:
    """The reduction over the ranks of every rank's `x`: all_gather, then
    `reduce` over the leading rank axis (default rank_sum, the rank-order
    sum). One all-reduce to a cost observer."""
    with observe("all-reduce", x.numel() * x.element_size(), group):
        return (reduce or rank_sum)(all_gather(x, group))


def _staged(raws: List[torch.Tensor], group) -> bool:
    """True where point-to-point bytes of these tensors go through pinned
    host buffers (gloo with CUDA tensors; never a meta tensor)."""
    return raws[0].is_cuda and dist.get_backend(group) == "gloo"


def _exchange(sends, recvs, group) -> int:
    """Post every send and receive (peer, uint8 tensor) at once, then wait
    for all of them, so no rank blocks on a send its peer has not yet
    matched. Returns the bytes staged through host memory."""
    raws = [t for _, t in sends] + [t for _, t in recvs]
    if raws and raws[0].is_meta:
        return 0
    staged = 0
    if _staged(raws, group):
        hsend = [(p, torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                  .copy_(t)) for p, t in sends]
        hrecv = [(p, torch.empty(t.shape, dtype=t.dtype, pin_memory=True))
                 for p, t in recvs]
        staged = sum(t.numel() for t in raws)
    else:
        hsend, hrecv = sends, recvs
    peer = ((lambda r: r) if group is None
            else (lambda r: dist.get_global_rank(group, r)))
    ops = ([dist.P2POp(dist.isend, t, peer(p), group) for p, t in hsend]
           + [dist.P2POp(dist.irecv, t, peer(p), group) for p, t in hrecv])
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    if hrecv is not recvs:
        for (_, dst), (_, src) in zip(recvs, hrecv):
            dst.copy_(src)
    return staged


def ring_shift(t: torch.Tensor, group=None) -> torch.Tensor:
    """The ring permutation i -> i + 1 mod n: this rank's `t` goes to rank
    + 1, and the returned tensor (t's shape, dtype and device) is rank -
    1's. Every rank calls it with the same shape."""
    rank, n = dist.get_rank(group), dist.get_world_size(group)
    with observe("collective-permute", t.numel() * t.element_size(), group):
        raw = _raw(t)
        out = torch.empty_like(raw)
        t0 = time.perf_counter()
        staged = _exchange([((rank + 1) % n, raw)], [((rank - 1) % n, out)],
                           group)
        _count("ring_shift", t0, raw.numel(), raw.numel(), staged)
        return out.view(t.dtype).reshape(t.shape)


def reduce_scatter(x: torch.Tensor, group=None) -> torch.Tensor:
    """This rank's slice of the rank-order sum over the ranks: `x` is
    (..., n * ds) on every rank, the result (..., ds) is
    ((x_0 + x_1) + x_2) + ... over columns [rank * ds, (rank + 1) * ds).
    Only the slices move: n - 1 sends of one slice to its owner and n - 1
    receives of this rank's slice, a real reduce-scatter's bytes."""
    rank, n = dist.get_rank(group), dist.get_world_size(group)
    ds = x.shape[-1] // n
    if ds * n != x.shape[-1]:
        raise ValueError(f"last dim {x.shape[-1]} does not split over {n} "
                         f"ranks")
    with observe("reduce-scatter", x.numel() // n * x.element_size(), group):
        parts = [x[..., r * ds:(r + 1) * ds].contiguous() for r in range(n)]
        got = [parts[rank] if r == rank else torch.empty_like(parts[rank])
               for r in range(n)]
        sends = [(r, _raw(parts[r])) for r in range(n) if r != rank]
        recvs = [(r, got[r].view(-1).view(torch.uint8)) for r in range(n)
                 if r != rank]
        t0 = time.perf_counter()
        staged = _exchange(sends, recvs, group) if n > 1 else 0
        nb = sum(t.numel() for _, t in sends)
        _count("reduce_scatter", t0, nb, nb, staged)
        return rank_sum(got)


def rank_sum(g) -> torch.Tensor:
    """Sum over the leading rank axis (or a list in rank order), in rank
    order."""
    acc = g[0]
    for i in range(1, len(g)):
        acc = acc + g[i]
    return acc


def rank_mean(x: torch.Tensor, group=None) -> torch.Tensor:
    """The mean of `x` over the ranks, summed in rank order, then divided by
    n: bit for bit the worker mean of the simulated-worker harness."""
    return all_reduce(x, group) / dist.get_world_size(group)
