"""CommSchedule: fused, backward-ordered streaming of compressed buckets
(the JAX package's core/schedule.py:96-381).

build_schedule(plan, fusion_bytes) orders the plan's buckets by backward
readiness and greedily fuses consecutive ones into messages until a
message's dense bytes reach `fusion_bytes` (0 = one message per bucket,
math.inf = one message). Execution runs the plan's per-bucket dispatches
message by message in that order. The reference pins that order with
lax.optimization_barrier; eager PyTorch keeps program order, so no
barrier is needed. Scheduling never changes numerics.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, List, Tuple

from repro_torch.core.plan import UnitPlan


@dataclasses.dataclass(frozen=True)
class Message:
    """One wire message: a readiness-ordered group of fused buckets."""
    bucket_ids: Tuple[int, ...]
    nbytes: int
    ready: int


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

    def _bucket_order(self) -> List[int]:
        return [bi for m in self.messages for bi in m.bucket_ids]

    def execute(self, fn: Callable, grads, key):
        """UnitPlan.execute, streamed in message order: identical
        per-bucket dispatches and keys, bit-identical output. (Real wire
        buffers: core.wire.execute_schedule_wire.)"""
        return self.plan._execute(fn, grads, key, self._bucket_order())

    def execute_with_state(self, fn: Callable, grads, state, key):
        """UnitPlan.execute_with_state, streamed in message order."""
        return self.plan._execute_with_state(fn, grads, state, key,
                                             self._bucket_order())


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
