"""Deterministic synthetic data (the JAX package's data/synthetic.py).

Language modelling: sequences from a fixed random first-order Markov
chain over the vocab (`make_markov`, numpy's default_rng as the
reference's, so the matrix is bitwise the reference's), sampled by
Gumbel-max (`markov_lm_batch`, `lm_batches`); vision and audio stubs:
projected patch embeddings (`patches_stub`) and frame embeddings
(`frames_stub`). Classification: CIFAR-shaped smooth class
prototypes + pixel noise (data/synthetic.py:65-86), drawn with
repro_torch.random's jax draws on the CPU, so the images and labels are
the reference's (labels bitwise; tests/test_torch_draws.py states the
images' bound). Same shapes and recipes as the reference; the LM batches
and the vision and audio stubs draw from a torch.Generator seeded by the
key's words, so their numbers differ from JAX's (the tests feed JAX-made
batches where they compare)."""
from __future__ import annotations

import functools
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels.ref import fma_f32
from repro_torch.random import fold_in, generator
from repro_torch.random import key as make_key
from repro_torch.random import normal, randint, split


def _triangle_weights(n_in: int, n_out: int) -> torch.Tensor:
    """(n_in, n_out) f32 weights of jax.image.resize's bilinear upsampling
    along one dim: the triangle kernel max(0, 1 - |s - i|) at the sample
    s = (o + 0.5) n_in / n_out - 0.5, each column normalized by its sum,
    columns whose sample lies outside [-0.5, n_in - 0.5] zeroed."""
    inv = np.float32(n_in) / np.float32(n_out)
    s = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * inv \
        - np.float32(0.5)
    w = np.maximum(np.float32(0), np.float32(1) - np.abs(
        s[None, :] - np.arange(n_in, dtype=np.float32)[:, None]))
    tot = w.sum(axis=0, keepdims=True, dtype=np.float32)
    w = np.where(np.abs(tot) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(tot != 0, tot, 1), 0).astype(np.float32)
    inside = (s >= -0.5) & (s <= n_in - 0.5)
    return torch.from_numpy(np.where(inside[None, :], w, 0)
                            .astype(np.float32))


def _contract(x: torch.Tensor, w: torch.Tensor, dim: int) -> torch.Tensor:
    """x contracted with w (n_in, n_out) over `dim`, the products summed in
    input order. XLA's CPU dot rounds in another order: the prototypes
    agree with the reference's within one f32 ulp of their largest
    magnitude (ROADMAP Queue 3 item 17)."""
    x = x.movedim(dim, -1)
    acc = x[..., 0:1] * w[0]
    for i in range(1, w.shape[0]):
        acc = acc + x[..., i:i + 1] * w[i]
    return acc.movedim(-1, dim)


@functools.lru_cache(maxsize=None)
def _class_prototypes(classes: int, hw: int, channels: int) -> torch.Tensor:
    """The fixed smooth prototypes (NHWC, on the CPU; cached, read-only):
    normal(key(1234), (classes, 4, 4, channels)) upsampled bilinearly to
    hw x hw as jax.image.resize does (rows, then columns), times 2."""
    coarse = normal(make_key(1234), (classes, 4, 4, channels))
    up = _contract(_contract(coarse, _triangle_weights(4, hw), 1),
                   _triangle_weights(4, hw), 2)
    return up * 2.0


def classification_batch(key: torch.Tensor, batch: int, classes: int = 10,
                         hw: int = 32, channels: int = 3, noise: float = 0.5,
                         device="cuda") -> Dict[str, torch.Tensor]:
    """{"images": (B, hw, hw, C) f32 NHWC, "labels": (B,) int64}: the
    reference's draws (split(key, 3), randint for the labels, normal for
    the noise), made on the CPU and moved to `device`, so the card and the
    CPU see the same batch. protos[labels] + noise * n is one fma, as the
    reference's jitted code fuses it. The CPU draws of the last
    BATCH_CACHE (key, shape) pairs are kept: the figures' runs replay one
    data stream row after row."""
    dev = resolve_device(device)
    k0, k1 = (int(w) for w in key.tolist())
    x, labels = _batch_cpu(k0, k1, batch, classes, hw, channels, noise)
    if dev.type == "cpu":
        return {"images": x.clone(), "labels": labels.clone()}
    return {"images": x.to(dev), "labels": labels.to(dev)}


BATCH_CACHE = 128


@functools.lru_cache(maxsize=BATCH_CACHE)
def _batch_cpu(k0: int, k1: int, batch: int, classes: int, hw: int,
               channels: int, noise: float):
    key = torch.tensor([k0, k1], dtype=torch.int64)
    _, kl, kn = split(key, 3)
    protos = _class_prototypes(classes, hw, channels)
    labels = randint(kl, (batch,), 0, classes)
    n = normal(kn, (batch, hw, hw, channels))
    x = fma_f32(n, torch.full_like(n, float(np.float32(noise))),
                protos[labels])
    return x, labels


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
