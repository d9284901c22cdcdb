"""Deterministic synthetic data (the JAX package's data/synthetic.py).

Language modelling: sequences from a fixed random first-order Markov
chain over the vocab (`make_markov`, numpy's default_rng as the
reference's, so the matrix is bitwise the reference's), sampled by
Gumbel-max (`markov_lm_batch`, `lm_batches`); vision and audio stubs:
projected patch embeddings (`patches_stub`) and frame embeddings
(`frames_stub`). Classification: CIFAR-shaped smooth class
prototypes + pixel noise (data/synthetic.py:65-86). Same shapes and recipes
as the reference; every draw but the Markov matrix comes from a
torch.Generator seeded by the key's words, so the numbers differ from
JAX's (the tests feed JAX-made batches where they compare)."""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.random import fold_in, generator
from repro_torch.random import key as make_key


def _class_prototypes(classes: int, hw: int, channels: int) -> torch.Tensor:
    """Fixed smooth prototypes: 4x4 random grids bilinearly upsampled, x2."""
    coarse = torch.randn((classes, channels, 4, 4), generator=torch.Generator().manual_seed(1234))
    up = F.interpolate(coarse, size=(hw, hw), mode="bilinear",
                       align_corners=False)
    return (up * 2.0).permute(0, 2, 3, 1)            # NHWC


def classification_batch(key: torch.Tensor, batch: int, classes: int = 10,
                         hw: int = 32, channels: int = 3, noise: float = 0.5,
                         device="cuda") -> Dict[str, torch.Tensor]:
    """{"images": (B, hw, hw, C) f32 NHWC, "labels": (B,) int64}."""
    dev = resolve_device(device)
    g = generator(key)
    protos = _class_prototypes(classes, hw, channels)
    labels = torch.randint(0, classes, (batch,), generator=g)
    x = protos[labels] + noise * torch.randn((batch, hw, hw, channels),
                                             generator=g)
    return {"images": x.to(torch.float32).to(dev), "labels": labels.to(dev)}


# ---- language modelling ------------------------------------------------------

def make_markov(vocab: int, seed: int = 0, concentration: float = 0.3,
                device="cuda") -> torch.Tensor:
    """(vocab, vocab) row-stochastic f32 transition matrix with low entropy
    (learnable), bitwise the reference's (the same numpy draws)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    logits = rng.gumbel(size=(vocab, vocab)) / concentration
    p = np.exp(logits - logits.max(axis=1, keepdims=True))
    p = p / p.sum(axis=1, keepdims=True)
    return torch.from_numpy(p.astype(np.float32)).to(dev)


def markov_lm_batch(key: torch.Tensor, trans: torch.Tensor, batch: int,
                    seq: int) -> Dict[str, torch.Tensor]:
    """{"tokens", "targets"}: (batch, seq) int64 on trans's device, targets
    the next token. First tokens uniform, then each step a Gumbel-max draw
    from log(trans[tok] + 1e-9), as the reference samples; the draws come
    from a generator on the device seeded by the key, so they are not the
    reference's."""
    vocab = trans.shape[0]
    dev = trans.device
    g = generator(key, dev)
    logp = torch.log(trans + 1e-9)
    tok = torch.randint(0, vocab, (batch,), generator=g, device=dev)
    seqs = [tok]
    for _ in range(seq):
        u = torch.rand((batch, vocab), generator=g, device=dev)
        gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
        tok = torch.argmax(logp[tok] + gumbel, dim=-1)
        seqs.append(tok)
    s = torch.stack(seqs, dim=1)                          # (B, S+1)
    return {"tokens": s[:, :-1], "targets": s[:, 1:]}


def lm_batches(vocab: int, batch: int, seq: int, seed: int = 0,
               device="cuda") -> Iterator[Dict[str, torch.Tensor]]:
    """Infinite deterministic LM batch stream: step i from fold_in(key(seed),
    i) over make_markov(vocab, seed)."""
    trans = make_markov(vocab, seed, device=device)
    base = make_key(seed)
    step = 0
    while True:
        yield markov_lm_batch(fold_in(base, step), trans, batch, seq)
        step += 1


def patches_stub(key: torch.Tensor, batch: int, patches: int, d_model: int,
                 device="cuda") -> torch.Tensor:
    """Vision frontend stub: (batch, patches, d_model) f32 projected patch
    embeddings, 0.02 x standard normal (not the reference's draws)."""
    dev = resolve_device(device)
    g = generator(key, dev)
    return 0.02 * torch.randn((batch, patches, d_model), generator=g,
                              device=dev)


def frames_stub(key: torch.Tensor, batch: int, frames: int, d_model: int,
                device="cuda") -> torch.Tensor:
    """Audio frontend stub: (batch, frames, d_model) f32 precomputed frame
    embeddings, 0.02 x standard normal (not the reference's draws)."""
    dev = resolve_device(device)
    g = generator(key, dev)
    return 0.02 * torch.randn((batch, frames, d_model), generator=g,
                              device=dev)
