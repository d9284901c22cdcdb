"""Synthetic CIFAR-shaped classification data (the JAX package's
data/synthetic.py:65-86): smooth class prototypes + pixel noise, a pure
function of the key. Same shapes and recipe as the reference, drawn from
a seeded torch.Generator, so the numbers differ from JAX's (the tests
feed JAX-made batches where they compare)."""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch import resolve_device


def _generator(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def _class_prototypes(classes: int, hw: int, channels: int) -> torch.Tensor:
    """Fixed smooth prototypes: 4x4 random grids bilinearly upsampled, x2."""
    coarse = torch.randn((classes, channels, 4, 4), generator=_generator(1234))
    up = F.interpolate(coarse, size=(hw, hw), mode="bilinear",
                       align_corners=False)
    return (up * 2.0).permute(0, 2, 3, 1)            # NHWC


def classification_batch(key: torch.Tensor, batch: int, classes: int = 10,
                         hw: int = 32, channels: int = 3, noise: float = 0.5,
                         device="cuda") -> Dict[str, torch.Tensor]:
    """{"images": (B, hw, hw, C) f32 NHWC, "labels": (B,) int64}."""
    dev = resolve_device(device)
    k = key.tolist()
    g = _generator((int(k[0]) << 32) | int(k[1]))
    protos = _class_prototypes(classes, hw, channels)
    labels = torch.randint(0, classes, (batch,), generator=g)
    x = protos[labels] + noise * torch.randn((batch, hw, hw, channels),
                                             generator=g)
    return {"images": x.to(torch.float32).to(dev), "labels": labels.to(dev)}
