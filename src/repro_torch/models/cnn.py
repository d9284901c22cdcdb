"""The paper's benchmark models: a ResNet-9-style CNN, an AlexNet-style CNN
and an MLP for CIFAR-shaped classification (the JAX package's
models/cnn.py).

Params are a flat dict of tensors in the JAX layout: conv weights HWIO,
dense weights (din, dout). The public functions take NHWC images;
cnn_forward permutes to NCHW / OIHW internally, so autograd returns
gradients in the JAX layout and the element order inside every
compression unit matches the reference (which fixes the PRNG draw each
weight sees).
"""
from __future__ import annotations

import functools
import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.configs.resnet9_cifar import CNNConfig
from repro_torch.random import normal as jax_normal
from repro_torch.random import split


def init_cnn(cfg: CNNConfig, key: torch.Tensor, device="cuda") -> Dict:
    """He-initialised params from `key` (random.key data), on `device`: the
    reference's draws, split(key, 32) taken in its order, each weight
    std * normal(k, shape) drawn on the CPU and moved (so the card and the
    CPU start from the same params). The CPU draws of the last INIT_CACHE
    (config, key) pairs are kept: the figures start every run of a model
    from one key."""
    dev = resolve_device(device)
    k0, k1 = (int(w) for w in key.tolist())
    return {k: (v.clone() if dev.type == "cpu" else v.to(dev))
            for k, v in _init_cpu(cfg, k0, k1).items()}


INIT_CACHE = 8


@functools.lru_cache(maxsize=INIT_CACHE)
def _init_cpu(cfg: CNNConfig, k0: int, k1: int) -> Dict:
    ks = iter(split(torch.tensor([k0, k1], dtype=torch.int64), 32))

    def normal(std, *shape):
        return jax_normal(next(ks), shape) * float(np.float32(std))

    def zeros(n):
        return torch.zeros((n,))

    p: Dict = {}
    if cfg.kind == "mlp":
        d = cfg.hw * cfg.hw * cfg.channels
        for i, w in enumerate(cfg.widths):
            p[f"fc{i}_w"] = normal(math.sqrt(2.0 / d), d, w)
            p[f"fc{i}_b"] = zeros(w)
            d = w
        p["head_w"] = normal(math.sqrt(2.0 / d), d, cfg.classes)
        p["head_b"] = zeros(cfg.classes)
        return p
    cin = cfg.channels
    for i, w in enumerate(cfg.widths):
        p[f"conv{i}_w"] = normal(math.sqrt(2.0 / (9 * cin)), 3, 3, cin, w)
        p[f"conv{i}_b"] = zeros(w)
        if cfg.kind == "resnet9":
            p[f"res{i}a_w"] = normal(math.sqrt(2.0 / (9 * w)), 3, 3, w, w)
            p[f"res{i}b_w"] = normal(math.sqrt(2.0 / (9 * w)), 3, 3, w, w)
        cin = w
    p["head_w"] = normal(math.sqrt(2.0 / cfg.widths[-1]), cfg.widths[-1],
                         cfg.classes)
    p["head_b"] = zeros(cfg.classes)
    return p


def _chan_rms(x, eps=1e-5):
    """Parameter-free channel RMS normalization over C of NCHW."""
    return x * torch.rsqrt(torch.mean(torch.square(x), dim=1, keepdim=True)
                           + eps)


def _conv(x, w_hwio, b=None):
    """SAME 3x3 stride-1 convolution of NCHW x with an HWIO weight."""
    return F.conv2d(x, w_hwio.permute(3, 2, 0, 1), b, padding="same")


def cnn_forward(cfg: CNNConfig, p: Dict, images: torch.Tensor):
    """NHWC images -> (B, classes) logits."""
    if cfg.kind == "mlp":
        h = images.reshape(images.shape[0], -1)
        for i in range(len(cfg.widths)):
            h = F.relu(h @ p[f"fc{i}_w"] + p[f"fc{i}_b"])
        return h @ p["head_w"] + p["head_b"]
    x = images.permute(0, 3, 1, 2)
    for i in range(len(cfg.widths)):
        x = _chan_rms(F.relu(_conv(x, p[f"conv{i}_w"], p[f"conv{i}_b"])))
        x = F.max_pool2d(x, 2)
        if cfg.kind == "resnet9":
            r = _chan_rms(F.relu(_conv(x, p[f"res{i}a_w"])))
            r = _chan_rms(F.relu(_conv(r, p[f"res{i}b_w"])))
            x = x + r
    x = x.mean(dim=(2, 3))
    return x @ p["head_w"] + p["head_b"]


def cnn_loss(cfg: CNNConfig, p: Dict, batch) -> torch.Tensor:
    logits = cnn_forward(cfg, p, batch["images"])
    logp = F.log_softmax(logits, dim=-1)
    return -logp.gather(1, batch["labels"].long()[:, None]).mean()


def cnn_accuracy(cfg: CNNConfig, p: Dict, batch) -> torch.Tensor:
    logits = cnn_forward(cfg, p, batch["images"])
    return (logits.argmax(-1) == batch["labels"]).to(torch.float32).mean()
