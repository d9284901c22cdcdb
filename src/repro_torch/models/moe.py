"""Mixture-of-Experts with top-k routing and static capacity, one device
(the JAX package's models/moe.py).

Each token's top-k experts by router probability (ties to the lower
expert index, as lax.top_k: a stable descending sort), gates renormalized
over the k. Tokens go to a (E, C, d) capacity buffer by their rank within
the expert (a one-hot cumulative count); past capacity they land in a
dump row that is dropped. The experts run as one batched matmul, and
each token's output is the sum over its k weighted expert outputs, taken
in k order (the reference's scatter-add), plus the shared expert. Aux
loss: load balance plus 1e-3 router z-loss.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.dist import (DistConfig, fdot, region_in, region_out,
                                     tp_shared)
from repro_torch.models.layers import gelu, silu


def capacity(tokens: int, top_k: int, n_experts: int, cf: float) -> int:
    return max(1, int(math.ceil(tokens * top_k / n_experts * cf)))


def moe_ffn(p: dict, x: torch.Tensor, cfg, dist: DistConfig,
            fd=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (T, d) tokens -> (out (T, d), aux_loss f32 scalar)."""
    fd = fd or {}
    d = x.shape[-1]
    E, K = cfg.n_experts, cfg.experts_per_token
    xi = region_in(x, dist, axis=0)
    T = xi.shape[0]
    logits = (xi @ tp_shared(p["router"], dist.tp)).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    order = torch.sort(probs, dim=-1, descending=True, stable=True)[1]
    eidx = order[:, :K]                                  # (T, K)
    gate = probs.gather(1, eidx)
    gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)

    # ---- aux losses ----
    density = F.one_hot(eidx, E).to(torch.float32).mean(dim=(0, 1))
    mean_prob = probs.mean(dim=0)
    lb_loss = E * torch.sum(density * mean_prob)
    z_loss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    aux = lb_loss + 1e-3 * z_loss

    # ---- dispatch: rank within expert, capacity drops to the dump row ----
    C = capacity(T, K, E, cfg.moe_capacity_factor)
    flat_e = eidx.reshape(-1)                            # (T*K,)
    flat_g = gate.reshape(-1)
    flat_t = torch.arange(T, device=x.device).repeat_interleave(K)
    onehot = F.one_hot(flat_e, E)
    slot = (torch.cumsum(onehot, dim=0) - onehot).gather(
        1, flat_e[:, None])[:, 0]
    keep = slot < C
    dest = torch.where(keep, flat_e * C + slot, E * C)
    rows = torch.where(keep[:, None], xi[flat_t], 0.0)
    buf = torch.zeros((E * C + 1, d), dtype=x.dtype,
                      device=x.device).index_add(0, dest, rows)
    eb = buf[:-1].reshape(E, C, d)

    # ---- expert FFN, batched over experts ----
    if cfg.mlp == "swiglu":
        h = silu(torch.einsum("ecd,edf->ecf", eb, p["w_gate"])) * \
            torch.einsum("ecd,edf->ecf", eb, p["w_in"])
    else:
        h = gelu(torch.einsum("ecd,edf->ecf", eb, p["w_in"]))
    eo = torch.einsum("ecf,efd->ecd", h, p["w_out"])     # (E, C, d)

    # ---- combine: each token's k contributions summed in k order ----
    picked = torch.where(keep[:, None],
                         eo.reshape(E * C, d)[torch.where(keep, dest, 0)],
                         0.0)
    contrib = (picked * flat_g[:, None].to(x.dtype)).reshape(T, K, d)
    out = torch.zeros((T, d), dtype=x.dtype, device=x.device)
    for j in range(K):
        out = out + contrib[:, j]
    if cfg.moe_shared_expert:
        hs = silu(fdot(xi, p["shared_w_gate"], fd.get("shared_w_gate"),
                         dist)) * \
            fdot(xi, p["shared_w_in"], fd.get("shared_w_in"), dist)
        out = out + fdot(hs, p["shared_w_out"], fd.get("shared_w_out"), dist)
    return region_out(out, dist, axis=0), aux
