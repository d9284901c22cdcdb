"""The plain reference of one step of Algorithm 1 over simulated workers:
each worker's loss and gradient on its contiguous share of the rows, the
gradient split into compression units, each unit compressed by the
worker compressor Q_W with the worker's draws, the compressed gradients
averaged over the workers in worker order, and the SGD update
p - lr * g stored in the parameters' dtype.

Units: every leaf, in sorted path order, flattened and laid end to end.
Layer-wise, a leaf under "blocks/" gives one unit a layer and any other
leaf one unit; entire-model, the whole vector is one unit. Keys: worker
w's key is fold_in(step key, w); a unit's key is fold_in(worker key,
uid), and a layer's fold_in(fold_in(worker key, uid of the leaf's first
layer), layer). QSGD with s levels keeps ||x|| sign(x_i) l_i / s with
l_i = floor(s |x_i| / ||x||) + [u_i < frac(s |x_i| / ||x||)], u_i the
unit's uniforms (pbench.keys); ||x|| carries 1e-12 against an all-zero
unit. Top-k keeps the round(ratio d) entries of largest magnitude.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, NamedTuple, Tuple

import torch

from pbench.keys import fold_in, pair_uniforms
from pbench.ref_common import NORMAL, ONES, ZEROS, Leaf

# counter pairs a QSGD unit draws at a time
PAIR_SPAN = 1 << 22
NORM_EPS = 1e-12


class Unit(NamedTuple):
    offset: int
    dim: int
    key: torch.Tensor           # (2,) int64, the worker key folded in


def ordered(leaves: Dict[str, Leaf]) -> List[str]:
    """Leaf paths in the order the program flattens its tree: sorted by
    their path components."""
    return sorted(leaves, key=lambda p: tuple(p.split("/")))


def units(leaves: Dict[str, Leaf], granularity: str,
          wkey: torch.Tensor) -> List[Unit]:
    out, off, uid = [], 0, 0
    for path in ordered(leaves):
        shape = leaves[path].shape
        size = math.prod(shape)
        if granularity == "layerwise" and path.startswith("blocks/"):
            base = fold_in(wkey, uid)
            per = size // shape[0]
            out += [Unit(off + i * per, per, fold_in(base, i))
                    for i in range(shape[0])]
            uid += shape[0]
        elif granularity == "layerwise":
            out.append(Unit(off, size, fold_in(wkey, uid)))
            uid += 1
        off += size
    if granularity == "entire_model":
        return [Unit(0, off, fold_in(wkey, 0))]
    if granularity != "layerwise":
        raise ValueError(granularity)
    return out


def _qsgd_part(x: torch.Tensor, u: torch.Tensor, nrm: torch.Tensor,
               s: int) -> torch.Tensor:
    y = x.abs() / nrm * s
    lo = torch.floor(y)
    lev = lo + (u < y - lo).to(y.dtype)
    return torch.sign(x) * lev * (nrm / s)


def qsgd_add(x: torch.Tensor, key: torch.Tensor, levels: int,
             acc: torch.Tensor) -> None:
    """acc += QSGD(x) for one unit x (d,) f32."""
    d = x.numel()
    nrm = torch.linalg.vector_norm(x) + NORM_EPS
    h = (d + 1) // 2
    for j0 in range(0, h, PAIR_SPAN):
        j1 = min(h, j0 + PAIR_SPAN)
        u0, u1 = pair_uniforms(key, d, j0, j1, x.device)
        acc[j0:j1] += _qsgd_part(x[j0:j1], u0, nrm, levels)
        hi = min(d, j1 + h) - (j0 + h)
        if hi > 0:
            acc[j0 + h:j0 + h + hi] += _qsgd_part(x[j0 + h:j0 + h + hi],
                                                  u1[:hi], nrm, levels)


def topk_add(x: torch.Tensor, ratio: float, acc: torch.Tensor) -> None:
    """acc += top-k(x) for one unit x (d,) f32."""
    d = x.numel()
    k = max(1, min(d, int(round(ratio * d))))
    idx = torch.topk(x.abs(), k, sorted=False).indices
    acc[idx] += x[idx]


def compress_add(flat: torch.Tensor, us: List[Unit], comp: dict,
                 acc: torch.Tensor) -> None:
    """acc += Q_W(flat) unit by unit."""
    for u in us:
        x, a = flat[u.offset:u.offset + u.dim], acc[u.offset:u.offset + u.dim]
        if comp["name"] == "qsgd":
            qsgd_add(x, u.key, comp["levels"], a)
        elif comp["name"] == "topk":
            topk_add(x, comp["ratio"], a)
        else:
            raise ValueError(f"no reference for compressor {comp['name']!r}")


def make_params(leaves: Dict[str, Leaf], seed: int, dtype: torch.dtype,
                device) -> Dict[str, torch.Tensor]:
    """The weights of a seed, made on `device` in `dtype`: every normal
    leaf a view of ONE draw from a generator on the device, scaled in
    place by its standard deviation; ones and zeros filled."""
    order = ordered(leaves)
    n = sum(math.prod(leaves[p].shape) for p in order
            if leaves[p].init == NORMAL)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) & ((1 << 63) - 1))
    pool = torch.randn(n, generator=g, dtype=dtype, device=device)
    out, off = {}, 0
    for p in order:
        leaf = leaves[p]
        if leaf.init == NORMAL:
            size = math.prod(leaf.shape)
            out[p] = pool[off:off + size].view(leaf.shape).mul_(leaf.std)
            off += size
        elif leaf.init == ONES:
            out[p] = torch.ones(leaf.shape, dtype=dtype, device=device)
        elif leaf.init == ZEROS:
            out[p] = torch.zeros(leaf.shape, dtype=dtype, device=device)
        else:
            raise ValueError(leaf.init)
    return out


def step(family, c: dict, leaves: Dict[str, Leaf],
         params: Dict[str, torch.Tensor], tokens: torch.Tensor,
         targets: torch.Tensor, key: torch.Tensor, traffic: dict,
         mm: Callable) -> Tuple[float, Dict[str, torch.Tensor],
                                Dict[str, torch.Tensor]]:
    """One reference step from `params` (the stored dtype) -> (mean worker
    loss, the aggregated gradient g (f32 leaves), the new params)."""
    order = ordered(leaves)
    W = traffic["workers"]
    per = tokens.shape[0] // W
    total = sum(math.prod(leaves[p].shape) for p in order)
    dev = tokens.device
    acc = torch.zeros(total, dtype=torch.float32, device=dev)
    losses = []
    for w in range(W):
        pf = {p: params[p].detach().to(torch.float32, copy=True)
              .requires_grad_(True) for p in order}
        rows = slice(w * per, (w + 1) * per)
        loss = family.loss(pf, tokens[rows], targets[rows], c, mm)
        grads = torch.autograd.grad(loss, [pf[p] for p in order])
        losses.append(float(loss.detach()))
        del pf, loss
        flat = torch.cat([g.reshape(-1) for g in grads])
        del grads
        compress_add(flat, units(leaves, traffic["granularity"],
                                 fold_in(key, w)), traffic["compressor"],
                     acc)
        del flat
    acc /= W
    g, new, off = {}, {}, 0
    lr = traffic["lr"]
    for p in order:
        size = math.prod(leaves[p].shape)
        g[p] = acc[off:off + size].view(leaves[p].shape)
        new[p] = (params[p].float() - lr * g[p]).to(params[p].dtype)
        off += size
    return sum(losses) / W, g, new
