"""Resilience plane (the JAX package's resil/): wire-fault injection,
detection bookkeeping, and recovery policies for the compressed pipeline.

`faults.FaultInjector` turns a CorruptionSpec (sim/scenario.py) into
perturbations of packed uint8 wire buffers (the hook core.wire's
executors call on every received message / hop) plus the Fletcher-32
verdict stream the caller drains.

`recovery` wires detection to action: RecoveryConfig / RecoveryManager
(resend, dense fallback after repeated failures, non-finite step guard,
partial participation) and `train_resilient`, the checkpointed training
loop with the bitwise train-N == train-k / resume / train-(N-k) contract.
"""
from repro_torch.resil.faults import FaultInjector
from repro_torch.resil.recovery import (RecoveryConfig, RecoveryManager,
                                        train_resilient)

__all__ = ["FaultInjector", "RecoveryConfig", "RecoveryManager",
           "train_resilient"]
