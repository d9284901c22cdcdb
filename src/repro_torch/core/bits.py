"""Communicated-bits accounting for every (operator, granularity, strategy)
(the JAX package's core/bits.py).

Analytic wire sizes computed from static unit dimensions. Payload (beta)
bits alone cannot tell entire-model from layer-wise from fused layer-wise
communication: what separates them on a real link is the per-message
latency (alpha) term, so `comm_report` also reports `n_messages` and, with
`alpha_bits_per_message`, a latency line in bit-equivalents.

What the port's collectives move (core/collectives.py counts it): under
allgather with wire=True a rank contributes exactly `uplink_bits_per_worker`
and receives exactly `downlink_bits_per_worker` of comm_report(measured=True).
The dense legs (dense, simulated) are reported as the reference reports a
ring all-reduce, d up and d down; the port's order-fixed mean is an
all_gather, which moves d up and (n - 1) d down.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

from repro_torch.core.aggregation import CompressionConfig
from repro_torch.core.plan import UnitPlan
from repro_torch.core.schedule import CommSchedule, build_schedule


@dataclasses.dataclass(frozen=True)
class CommReport:
    strategy: str
    n_workers: int
    dense_bits: int              # uncompressed fp32 allreduce reference
    uplink_bits_per_worker: int  # worker -> aggregation
    downlink_bits_per_worker: int  # aggregation -> worker
    compression_ratio: float     # dense / (up + down), payload only
    n_messages: int = 0          # wire transactions per step (alpha count)
    alpha_bits_per_message: int = 0  # per-message latency, bit-equivalents

    def total_bits_per_worker(self) -> int:
        return self.uplink_bits_per_worker + self.downlink_bits_per_worker

    def latency_bits(self) -> int:
        """The alpha term: n_messages x per-message latency cost."""
        return self.n_messages * self.alpha_bits_per_message

    def total_bits_with_latency(self) -> int:
        return self.total_bits_per_worker() + self.latency_bits()


def _wire_bits(cfg: CompressionConfig) -> int:
    return 16 if cfg.wire_dtype == "bfloat16" else 32


def comm_report(cfg: CompressionConfig,
                unit_dims: Union[UnitPlan, Sequence[int]],
                n_workers: int,
                schedule: Optional[CommSchedule] = None,
                alpha_bits_per_message: int = 0,
                measured: bool = False) -> CommReport:
    """Wire cost of one aggregation step (the reference's docstring holds:
    without a schedule one message per unit; with one, or with a UnitPlan
    and cfg.fusion_bytes, the fused message count; `measured=True` charges
    the compressed legs the real packed codec bytes instead of the
    analytic payload bits)."""
    if (schedule is None and isinstance(unit_dims, UnitPlan)
            and cfg.fusion_bytes is not None):
        schedule = build_schedule(unit_dims, cfg.fusion_bytes)
    if isinstance(unit_dims, UnitPlan):
        unit_dims = list(unit_dims.unit_dims)
    d_total = sum(unit_dims)
    dense_bits = 2 * 32 * d_total
    n_messages = (schedule.num_messages if schedule is not None
                  else len(unit_dims))

    if measured:
        from repro_torch.core.wire import wire_codec
        bits_of = wire_codec(cfg.qw).wire_bits
    else:
        bits_of = cfg.qw.payload_bits

    w = _wire_bits(cfg)
    if cfg.strategy in ("dense", "simulated"):
        up = down = w * d_total  # ring all-reduce: ~d out + ~d in
    elif cfg.strategy == "allgather":
        payload = sum(bits_of(d) for d in unit_dims)
        up = payload                       # contribute own payload
        down = (n_workers - 1) * payload   # receive everyone else's
    elif cfg.strategy in ("rs_compress_ag", "rs_stream"):
        # dense reduce-scatter + all-gather of the TRUE per-shard payloads
        # (shards of ceil(d/n) with a short tail, summing exactly to d)
        payload_all = 0
        for d in unit_dims:
            ds = -(-d // n_workers)
            payload_all += sum(bits_of(min(ds, d - wk * ds))
                               for wk in range(n_workers)
                               if d - wk * ds > 0)
        own = -(-payload_all // n_workers)
        up = w * d_total + own
        down = payload_all - own
    elif cfg.strategy == "shared_random":
        kept = sum(max(1, int(round(cfg.qw.ratio * d))) for d in unit_dims)
        up = down = w * kept
    else:  # pragma: no cover
        raise ValueError(cfg.strategy)

    total = up + down
    return CommReport(cfg.strategy, n_workers, dense_bits, up, down,
                      dense_bits / max(1, total),
                      n_messages=n_messages,
                      alpha_bits_per_message=alpha_bits_per_message)
