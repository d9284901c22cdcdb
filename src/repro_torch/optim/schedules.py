"""Learning-rate schedules (the JAX package's optim/schedules.py): f32
scalar tensors of the step, in the reference's arithmetic."""
from __future__ import annotations

import math

import torch


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32)


def piecewise_linear(peak: float, total_steps: int, warmup_steps: int):
    """The paper's schedule: linear 0 -> peak over warmup, then peak -> 0,
    as an f32 scalar tensor (the reference's arithmetic, in float32)."""
    def fn(step):
        s = torch.tensor(step, dtype=torch.float32)
        up = peak * s / max(1, warmup_steps)
        down = peak * (total_steps - s) / max(1, total_steps - warmup_steps)
        return torch.clamp(torch.minimum(up, down), 0.0, peak)
    return fn


def cosine(peak: float, total_steps: int, warmup_steps: int = 0,
           floor: float = 0.0):
    """Linear warmup to `peak`, then a half cosine down to `floor`."""
    def fn(step):
        s = torch.tensor(step, dtype=torch.float32)
        warm = peak * s / max(1, warmup_steps) if warmup_steps else peak
        t = torch.clamp((s - warmup_steps)
                        / max(1, total_steps - warmup_steps), 0.0, 1.0)
        cos = floor + (peak - floor) * 0.5 * (1 + torch.cos(math.pi * t))
        return torch.where(s < warmup_steps, warm, cos) if warmup_steps \
            else cos
    return fn
