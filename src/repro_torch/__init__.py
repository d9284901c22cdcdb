"""PyTorch/CUDA port of the compressed-communication repro (`src/repro/`).

Module names follow the JAX package so each counterpart is easy to find:
`kernels/` (threefry, the plain tile oracles, the hand-written Hopper
pack/unpack and majority-vote kernels and their wrappers), `core/`
(compressors with their payload records, granularity, UnitPlan,
CommSchedule, the fused and per-unit wire codecs with Fletcher-32
integrity and the signSGD majority vote, the collectives, Algorithm-1
aggregation on simulated workers and across ranks in
`compressed_allreduce`, and the bits accounting), `launch/` (rank
processes, their process group and data meshes; the data-parallel Engine
and the train CLI across ranks; comm scheduling; the serve CLI), `ckpt/`
(checkpoints in the reference's file format), `models/` (the paper's
CNNs and the LM families on one device), `configs/` (the arch registry),
`data/synthetic.py`, `optim/` and `experiment.py` (the paper's train_cnn
experiment, on simulated workers or across ranks, and train_lm, the
quickstart's Algorithm 1 on the LMs).

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
