"""Mixture-of-Experts with top-k routing, static capacity, and expert
parallelism over the TP axis (the JAX package's models/moe.py).

Every rank of a TP group sees the same tokens and owns E / tp experts
(the weights arrive sliced). Each rank routes every token (router
replicated -> tp_shared), keeps the assignments to its own experts, and
gathers those tokens into an (E_local, C, d) capacity buffer by their rank
within the expert (a one-hot cumulative count; past capacity they land in
a dump row that is dropped). Top-k ties go to the lower expert index, as
lax.top_k (a stable descending sort); gates renormalize over the k. The
experts run as one batched matmul, each token's output is the sum over its
k weighted expert outputs in k order (the reference's scatter-add), plus
the shared expert, and one reduction over the TP axis combines the ranks'
experts. Aux loss: load balance plus 1e-3 router z-loss, divided by the TP
size (its gradient paths sum over the ranks).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.dist import (DistConfig, all_gather, axis_index,
                                     axis_size, fdot, psum, region_in,
                                     region_out, tp_shared)
from repro_torch.models.layers import gelu, silu


def capacity(tokens: int, top_k: int, n_experts: int, cf: float) -> int:
    return max(1, int(math.ceil(tokens * top_k / n_experts * cf)))


def moe_ffn(p: dict, x: torch.Tensor, cfg, dist: DistConfig,
            fd=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (T, d) tokens (TP-replicated) -> (out (T, d), aux_loss f32
    scalar). fd: per-leaf fsdp dims on the decode path of an FSDP arch,
    where the expert weights stay sharded over the data axis (w_in /
    w_gate input-dim sharded: slice + sum; w_out output-dim sharded:
    gather the features)."""
    fd = fd or {}
    d = x.shape[-1]
    E, K = cfg.n_experts, cfg.experts_per_token
    tp = dist.tp
    E_l = p["w_in"].shape[0]                             # local experts
    r = axis_index(tp)
    xi = region_in(x, dist, axis=0)   # sp: gather the seq-sharded tokens
    T = xi.shape[0]
    logits = (xi @ tp_shared(p["router"], tp)).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    order = torch.sort(probs, dim=-1, descending=True, stable=True)[1]
    eidx = order[:, :K]                                  # (T, K)
    gate = probs.gather(1, eidx)
    gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)

    # ---- aux losses (the same on every rank) ----
    density = F.one_hot(eidx, E).to(torch.float32).mean(dim=(0, 1))
    mean_prob = probs.mean(dim=0)
    lb_loss = E * torch.sum(density * mean_prob)
    z_loss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    aux = lb_loss + 1e-3 * z_loss
    if axis_size(tp) > 1:
        aux = aux / float(axis_size(tp))

    # ---- dispatch to the local experts: rank within expert, capacity
    # drops to the dump row ----
    C = capacity(T, K, E, cfg.moe_capacity_factor)
    flat_e = eidx.reshape(-1)                            # (T*K,)
    flat_g = gate.reshape(-1)
    flat_t = torch.arange(T, device=x.device).repeat_interleave(K)
    local_e = flat_e - r * E_l
    sel = (local_e >= 0) & (local_e < E_l)
    le = torch.where(sel, local_e, E_l)
    onehot = F.one_hot(le, E_l + 1)
    slot = (torch.cumsum(onehot, dim=0) - onehot).gather(1, le[:, None])[:, 0]
    keep = sel & (slot < C)
    dest = torch.where(keep, le * C + slot, E_l * C)
    rows = torch.where(keep[:, None], xi[flat_t], 0.0)
    buf = torch.zeros((E_l * C + 1, d), dtype=x.dtype,
                      device=x.device).index_add(0, dest, rows)
    eb = buf[:-1].reshape(E_l, C, d)

    # ---- expert FFN, batched over the local experts ----
    fs = dist.fsdp is not None and axis_size(dist.fsdp) > 1
    eb_in = eb
    if fd.get("w_in") is not None and fs:
        dl = p["w_in"].shape[1]
        eb_in = eb.narrow(-1, axis_index(dist.fsdp) * dl, dl)

    def ein_in(w):
        h = torch.einsum("ecd,edf->ecf", eb_in, w)
        if fd.get("w_in") is not None and fs:
            h = psum(h, dist.fsdp)
        return h
    if cfg.mlp == "swiglu":
        h = silu(ein_in(p["w_gate"])) * ein_in(p["w_in"])
    else:
        h = gelu(ein_in(p["w_in"]))
    eo = torch.einsum("ecf,efd->ecd", h, p["w_out"])     # (E_l,C,d[/fsdp])

    # ---- combine: each token's k contributions summed in k order ----
    d_out = eo.shape[-1]
    picked = torch.where(keep[:, None],
                         eo.reshape(E_l * C, d_out)[torch.where(keep, dest,
                                                                0)], 0.0)
    contrib = (picked * flat_g[:, None].to(x.dtype)).reshape(T, K, d_out)
    out = torch.zeros((T, d_out), dtype=x.dtype, device=x.device)
    for j in range(K):
        out = out + contrib[:, j]
    if fd.get("w_out") is not None and fs:
        out = all_gather(out, dist.fsdp, gather_axis=out.dim() - 1)
    if cfg.moe_shared_expert:
        # the shared expert is TP-sharded (column / row parallel); its
        # partial sum rides the expert combine's reduction
        hs = silu(fdot(xi, p["shared_w_gate"], fd.get("shared_w_gate"),
                       dist)) * \
            fdot(xi, p["shared_w_in"], fd.get("shared_w_in"), dist)
        out = out + fdot(hs, p["shared_w_out"], fd.get("shared_w_out"), dist)
    return region_out(out, dist, axis=0), aux
