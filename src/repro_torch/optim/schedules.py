"""Learning-rate schedules (the JAX package's optim/schedules.py:12)."""
from __future__ import annotations

import torch


def piecewise_linear(peak: float, total_steps: int, warmup_steps: int):
    """The paper's schedule: linear 0 -> peak over warmup, then peak -> 0,
    as an f32 scalar tensor (the reference's arithmetic, in float32)."""
    def fn(step):
        s = torch.tensor(step, dtype=torch.float32)
        up = peak * s / max(1, warmup_steps)
        down = peak * (total_steps - s) / max(1, total_steps - warmup_steps)
        return torch.clamp(torch.minimum(up, down), 0.0, peak)
    return fn
