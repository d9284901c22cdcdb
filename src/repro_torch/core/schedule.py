"""CommSchedule: fused, backward-ordered streaming of compressed buckets
(the JAX package's core/schedule.py:96-381).

build_schedule(plan, fusion_bytes) orders the plan's buckets by backward
readiness and greedily fuses consecutive ones into messages until a
message's dense bytes reach `fusion_bytes` (0 = one message per bucket,
math.inf = one message). Execution runs the plan's per-bucket dispatches
message by message in that order. The reference pins that order with
lax.optimization_barrier; eager PyTorch keeps program order, so no
barrier is needed. Scheduling never changes numerics.

`execute_streaming(_with_state)` runs the schedule through the streaming
ring collective across the ranks of a process group
(core.wire.execute_schedule_stream). `simulate_schedule` is the
reference's deterministic alpha-beta cost model of one step's comm: a
model, not a measurement, pure Python over plan metadata.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.plan import UnitPlan

#: fusion_bytes sentinel: never close a message, everything fuses into one.
FUSE_ALL = math.inf


@dataclasses.dataclass(frozen=True)
class Message:
    """One wire message: a readiness-ordered group of fused buckets."""
    bucket_ids: Tuple[int, ...]
    nbytes: int
    ready: int

    @property
    def n_buckets(self) -> int:
        return len(self.bucket_ids)


@dataclasses.dataclass(frozen=True)
class CommSchedule:
    """Static communication schedule for one (UnitPlan, fusion_bytes)."""
    plan: UnitPlan
    fusion_bytes: float
    order: Tuple[int, ...]
    messages: Tuple[Message, ...]

    @property
    def num_messages(self) -> int:
        return len(self.messages)

    def summary(self) -> str:
        ms = ", ".join(f"{m.n_buckets}b/{m.nbytes >> 10}KiB"
                       for m in self.messages)
        fb = ("inf" if math.isinf(self.fusion_bytes)
              else f"{int(self.fusion_bytes)}")
        return (f"CommSchedule(fuse<{fb}B: {self.num_messages} messages "
                f"over {self.plan.num_dispatches} dispatches [{ms}])")

    def _groups(self) -> List[Tuple[int, ...]]:
        return [m.bucket_ids for m in self.messages]

    def execute(self, fn: Callable, grads, key, *, recorder=None):
        """UnitPlan.execute, streamed in message order: identical
        per-bucket dispatches and keys, bit-identical output. (Real wire
        buffers: core.wire.execute_schedule_wire.) `recorder` (duck-typed,
        obs.trace.TraceRecorder) marks one span per message; None or a
        disabled recorder runs the uninstrumented ops."""
        return self.plan._execute(fn, grads, key, self._groups(), recorder,
                                  "message")

    def execute_with_state(self, fn: Callable, grads, state, key, *,
                           recorder=None):
        """UnitPlan.execute_with_state, streamed in message order."""
        return self.plan._execute_with_state(fn, grads, state, key,
                                             self._groups(), recorder,
                                             "message")

    def execute_streaming(self, post, grads, key, *, wire, group=None,
                          n_workers: int, mode: str = "ring", wire_key=None,
                          chunk_bytes=None, recorder=None, faults=None):
        """Run the schedule through a real streaming collective across the
        ranks of `group`: the packed message buffers ride a chunked ring
        (mode='ring') or, under mode='rs', each rank encodes only the
        shard it owns after a dense reduce-scatter and the packed shards
        ride the ring. `wire` is the WireCodec, `post(xm2d, keys2d)` the
        master-compression closure on the cross-rank mean (None returns
        the mean), `chunk_bytes` the hop granularity (None: whole
        messages). Returns (tree, buffers); mode='ring' is bit-identical
        to the allgather wire path. See core.wire.execute_schedule_stream."""
        from repro_torch.core.wire import execute_schedule_stream
        return execute_schedule_stream(
            self, wire, post, grads, None, key, group=group,
            n_workers=n_workers, mode=mode, wire_key=wire_key,
            chunk_bytes=chunk_bytes, recorder=recorder, faults=faults)

    def execute_streaming_with_state(self, post, grads, state, key, *, wire,
                                     group=None, n_workers: int,
                                     mode: str = "ring", wire_key=None,
                                     chunk_bytes=None, recorder=None,
                                     faults=None):
        """Error-feedback twin of execute_streaming: e = x + m is encoded
        and m' = e - decode(own payload), the serialized wire path's local
        EF discipline (under mode='rs' only the owned shard of each
        residual row is live). Returns (tree, m_tree, buffers)."""
        from repro_torch.core.wire import execute_schedule_stream
        return execute_schedule_stream(
            self, wire, post, grads, state, key, group=group,
            n_workers=n_workers, mode=mode, wire_key=wire_key,
            chunk_bytes=chunk_bytes, recorder=recorder, faults=faults)


@functools.lru_cache(maxsize=256)
def build_schedule(plan: UnitPlan, fusion_bytes: float) -> CommSchedule:
    """Compile the (cached) CommSchedule for a plan: buckets in backward-
    readiness order, greedily fused until a message's dense bytes reach
    `fusion_bytes`."""
    fb = float(fusion_bytes)
    if math.isnan(fb) or fb < 0:
        raise ValueError(f"fusion_bytes must be >= 0, got {fusion_bytes!r}")
    order = plan.readiness_order()
    messages: List[Message] = []
    cur: List[int] = []
    cur_bytes = 0
    cur_ready = 0
    for bi in order:
        b = plan.buckets[bi]
        cur.append(bi)
        cur_bytes += b.nbytes
        cur_ready = max(cur_ready, b.ready)
        if cur_bytes >= fb:
            messages.append(Message(tuple(cur), cur_bytes, cur_ready))
            cur, cur_bytes, cur_ready = [], 0, 0
    if cur:
        messages.append(Message(tuple(cur), cur_bytes, cur_ready))
    return CommSchedule(plan=plan, fusion_bytes=fb, order=order,
                        messages=tuple(messages))


# ---- alpha-beta cost model (the reference's schedule.py:382-472) ------------

def message_wire_bits(schedule: CommSchedule, qw=None,
                      bucket_bits: Optional[Sequence[int]] = None
                      ) -> List[int]:
    """Per-message wire payload bits. With a compressor `qw`, each bucket
    contributes n_units * qw.payload_bits(dim) (the allgather-strategy
    payload); `bucket_bits` overrides with measured per-bucket bits; with
    neither, dense f32."""
    plan = schedule.plan
    if bucket_bits is not None:
        if len(bucket_bits) != len(plan.buckets):
            raise ValueError(
                f"bucket_bits has {len(bucket_bits)} entries, plan has "
                f"{len(plan.buckets)} buckets")
        per_bucket = [int(v) for v in bucket_bits]
    elif qw is not None:
        per_bucket = [b.n * qw.payload_bits(b.dim) for b in plan.buckets]
    else:
        per_bucket = [32 * b.n * b.dim for b in plan.buckets]
    return [sum(per_bucket[bi] for bi in m.bucket_ids)
            for m in schedule.messages]


def simulate_schedule(schedule: CommSchedule, *, qw=None,
                      bucket_bits: Optional[Sequence[int]] = None,
                      alpha_us: float = 50.0, gbps: float = 12.5,
                      compress_gbps: float = 25.0,
                      backward_us: Optional[float] = None) -> Dict:
    """Deterministic alpha-beta pipeline simulation of one step's comm
    (two streams, one network channel): backward emits leaves in reverse
    order uniformly over `backward_us` (default 2x streaming the dense
    gradient at `compress_gbps`); the compute stream compresses messages
    in schedule order at `compress_gbps`; the network sends message m for
    alpha_us + wire_bytes / gbps once both its compression is done and
    the previous message has left. Returns totals and per-message
    timelines, `exposed_comm_us` and `overlap_frac`. MODEL outputs, for
    relative comparisons only."""
    plan = schedule.plan
    n_leaves = max(1, plan.num_leaves)
    dense_bytes = 4 * plan.exec_total
    if backward_us is None:
        backward_us = 2.0 * dense_bytes / (compress_gbps * 1e3)
    wire = message_wire_bits(schedule, qw=qw, bucket_bits=bucket_bits)

    msgs = []
    c = 0.0        # compute-stream head (compression)
    e = 0.0        # network-stream head
    comm_sum = 0.0
    for m, bits in zip(schedule.messages, wire):
        ready_us = backward_us * (m.ready + 1) / n_leaves
        c = max(c, ready_us) + m.nbytes / (compress_gbps * 1e3)
        send_us = alpha_us + (bits / 8.0) / (gbps * 1e3)
        start = max(c, e)
        e = start + send_us
        comm_sum += send_us
        msgs.append({"n_buckets": m.n_buckets, "dense_bytes": m.nbytes,
                     "wire_bits": bits, "ready_rank": m.ready,
                     "ready_us": round(ready_us, 3),
                     "compressed_us": round(c, 3),
                     "sent_us": round(e, 3)})
    compute_end = max(backward_us, c)
    total = max(e, compute_end)
    exposed = max(0.0, total - compute_end)
    return {
        "n_messages": schedule.num_messages,
        "n_dispatches": plan.num_dispatches,
        "fusion_bytes": (None if math.isinf(schedule.fusion_bytes)
                         else schedule.fusion_bytes),
        "alpha_us": alpha_us, "gbps": gbps,
        "compress_gbps": compress_gbps,
        "backward_us": round(backward_us, 3),
        "wire_bits_total": int(sum(wire)),
        "comm_us_total": round(comm_sum, 3),
        "t_total_us": round(total, 3),
        "exposed_comm_us": round(exposed, 3),
        "overlap_frac": round(1.0 - exposed / comm_sum, 4) if comm_sum
        else 1.0,
        "messages": msgs,
    }
