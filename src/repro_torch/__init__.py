"""PyTorch/CUDA port of the compressed-communication repro (`src/repro/`).

Module names follow the JAX package so each counterpart is easy to find:
`kernels/` (threefry, the plain tile oracles, the hand-written Hopper
pack/unpack kernels and their wrappers), `core/` (compressors,
granularity, UnitPlan, CommSchedule, wire codecs, Algorithm-1
aggregation), `models/cnn.py`, `data/synthetic.py`, `optim/schedules.py`
and `experiment.py` (the paper's train_cnn experiment).

Every entry point takes `device=` and defaults to "cuda"; asking for the
card on a machine without one raises instead of running on the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """torch.device for `device`, refusing a CUDA device when no card is
    visible (the port never carries on silently on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} asked for the GPU, but torch sees no CUDA "
            f"device; pass device='cpu' to run the plain versions")
    return dev
