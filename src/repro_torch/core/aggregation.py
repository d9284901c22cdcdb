"""Algorithm 1 on simulated workers (the JAX package's
core/aggregation.py:63-127, 479-620).

  worker i:  g_i -> Q_W(g_i) -> send
  master  :  Q_M( (1/n) Σ_i Q_W(g_i) )

`aggregate_simulated_workers` is the paper-repro harness: worker
gradients carry a leading worker axis n on one device. The per-worker
pass is ONE batched execution over all n workers (the reference vmaps
it): worker i's unit keys derive from fold_in(key, i). With wire=True
every worker's compressed units travel as real packed message buffers
(core/wire.py), bit-identical to the sim path. The worker mean is summed
in worker order, ((w0 + w1) + w2) + ... then divided by n, so it does
not depend on a reduction kernel's order.

compressed_allreduce across real processes is ROADMAP.md Queue 1 item 8.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.convert import tree_leaves, tree_map
from repro_torch.core.compressors import Compressor, Identity, RandomK
from repro_torch.core.granularity import Granularity
from repro_torch.core.plan import build_plan
from repro_torch.core.schedule import build_schedule
from repro_torch.core.wire import (execute_schedule_wire,
                                   execute_schedule_wire_with_state,
                                   wire_codec)
from repro_torch.random import fold_in

STRATEGIES = ("dense", "simulated", "allgather", "rs_compress_ag",
              "shared_random", "ring", "rs_stream")

_MASTER_FOLD = 0x5EED


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    """Static configuration of the compressed-communication stack (the
    reference's fields; see its docstring for each)."""
    qw: Compressor = Identity()
    qm: Compressor = Identity()
    granularity: Granularity = Granularity("layerwise")
    strategy: str = "simulated"
    error_feedback: bool = False
    wire_dtype: str = "float32"
    fusion_bytes: Optional[float] = None
    integrity: bool = False

    def __post_init__(self):
        if self.strategy not in STRATEGIES:
            raise ValueError(f"unknown strategy {self.strategy!r}")
        if self.strategy == "shared_random" and not isinstance(self.qw,
                                                               RandomK):
            raise ValueError("shared_random requires a RandomK worker "
                             "compressor")
        if self.error_feedback and self.strategy not in (
                "simulated", "allgather", "ring", "rs_stream"):
            raise ValueError("error feedback supports simulated/allgather/"
                             "ring/rs_stream only")
        if self.fusion_bytes is not None and not float(self.fusion_bytes) >= 0:
            raise ValueError(
                f"fusion_bytes must be >= 0 or None, got {self.fusion_bytes!r}")


def _simulated_wire_codec(cfg: CompressionConfig):
    """The wire codec of cfg.qw for the simulated-worker harness, refusing
    one whose payload is not bit-exact against sim (capacity-bounded
    threshold records, or the lossy bf16 value cast): the simulated
    strategy promises the exact operator."""
    codec = wire_codec(cfg.qw, wire_dtype=cfg.wire_dtype,
                       integrity=cfg.integrity)
    if not codec.exact_sim:
        raise ValueError(
            f"{cfg.qw.name}: this wire format is not bit-exact against "
            f"sim (capacity-bounded records, or the lossy bfloat16 value "
            f"cast) while strategy='simulated' promises the exact "
            f"operator — drop wire=True")
    return codec


def worker_mean(g: torch.Tensor) -> torch.Tensor:
    """Mean over the leading worker axis, summed in worker order."""
    acc = g[0]
    for i in range(1, g.shape[0]):
        acc = acc + g[i]
    return acc / g.shape[0]


def aggregate_simulated_workers(worker_grads, stacked,
                                cfg: CompressionConfig, key: torch.Tensor,
                                ef_state=None, wire: bool = False):
    """Single-device realization of Algorithm 1: `worker_grads` leaves
    carry a leading worker axis n. Returns (grads_hat, new_ef_state).
    cfg.fusion_bytes streams the worker pass through a CommSchedule
    (bit-identical). `wire=True` materializes each worker's compression
    pass as real bit-packed message buffers (per-bucket messages unless
    cfg.fusion_bytes says otherwise); the master Q_M pass stays dense.
    A codec that is not sim-exact raises ValueError under wire=True."""
    n = tree_leaves(worker_grads)[0].shape[0]
    per_worker = tree_map(lambda x: torch.empty(x.shape[1:], dtype=x.dtype,
                                                device="meta"), worker_grads)
    plan = build_plan(per_worker, stacked, cfg.granularity)
    ex = (plan if cfg.fusion_bytes is None
          else build_schedule(plan, cfg.fusion_bytes))
    wkeys = fold_in(key[None], torch.arange(n))        # (n, 2) worker keys
    if wire:
        codec = _simulated_wire_codec(cfg)
        sched = build_schedule(plan, cfg.fusion_bytes or 0.0)

    if cfg.error_feedback:
        if ef_state is None:
            raise ValueError("error_feedback=True requires ef_state")
        if wire:
            compressed, new_ef, _bufs = execute_schedule_wire_with_state(
                sched, codec, worker_grads, ef_state, wkeys)
        else:
            def fn_ef(x, m, ukeys):
                e = x + m
                q = cfg.qw.sim(e, ukeys)
                return q, e - q
            compressed, new_ef = ex.execute_with_state(fn_ef, worker_grads,
                                                       ef_state, wkeys)
    else:
        if wire:
            compressed, _bufs = execute_schedule_wire(sched, codec,
                                                      worker_grads, wkeys)
        else:
            compressed = ex.execute(cfg.qw.sim, worker_grads, wkeys)
        new_ef = ef_state

    mean = tree_map(worker_mean, compressed)
    if type(cfg.qm) is Identity:
        # Q_M = identity: the master pass returns its input bit for bit,
        # so skip its dispatches (and the per-unit master-key folds)
        return mean, new_ef

    def master_fn(x, ukeys):
        return cfg.qm.sim(x, fold_in(ukeys, _MASTER_FOLD))
    return ex.execute(master_fn, mean, key), new_ef
