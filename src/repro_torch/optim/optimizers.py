"""SGD, momentum (with Nesterov) and Adam over the port's parameter trees
(the JAX package's optim/optimizers.py). Functional, as the reference:
every update returns (new params, new state); states are f32 trees shaped
like the params, on the params' device.

The arithmetic is the reference's jitted update on XLA's CPU backend, bit
for bit. XLA contracts `wd * p + g`, `beta1 * m + g`, `g + beta1 * m` (the
Nesterov step), Adam's moment updates and `p - lr * step` into fmas
(kernels/ref.fma_f32 here); its algebraic simplifier turns Adam's
(m / b1c) / (sqrt(v / b2c) + eps) into m / (b1c * (sqrt(v / b2c) + eps));
its f32 sqrt is correctly rounded, which torch's CPU sqrt is not, so the
port takes the square root in f64 and rounds (exact for one sqrt). Adam's
bias corrections 1 - beta ** count are host scalars: beta ** count is
rounded to f32 from f64, which equals XLA's f32 pow for counts below 685
(beta 0.9) and 873 (beta 0.999) and is at most one ulp off beyond
(ROADMAP.md Queue 3). `_clip`'s global norm sums its squares in another
order than jnp.sum (a tolerance, as for QSGD's unit norms). Every other
step is elementwise, so the card computes the CPU's bits.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.convert import tree_leaves, tree_map, tree_paths, \
    tree_unflatten
from repro_torch.kernels.ref import fma_f32


@dataclasses.dataclass(frozen=True)
class OptConfig:
    name: str = "sgd"          # sgd | momentum | adam
    lr: float = 0.1            # base lr; schedules multiply it
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    nesterov: bool = False
    grad_clip: float = 0.0     # 0 = off; global-norm clip


def init_opt_state(cfg: OptConfig, params):
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    if cfg.name == "sgd":
        return {}
    if cfg.name == "momentum":
        return {"m": tree_map(zeros, params)}
    if cfg.name == "adam":
        dev = tree_leaves(params)[0].device
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "count": torch.zeros((), dtype=torch.int32, device=dev)}
    raise ValueError(cfg.name)


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    """A Python number rounded to an f32 scalar on `like`'s device (the
    reference's weakly typed constants)."""
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 sqrt (XLA's): in f64, then rounded."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def _clip(grads, max_norm: float):
    if max_norm <= 0:
        return grads
    leaves = tree_leaves(grads)
    gn = _sqrt(sum(torch.sum(g.to(torch.float32) ** 2) for g in leaves))
    scale = torch.clamp_max(_f32(max_norm, gn) / torch.clamp_min(
        gn, _f32(1e-12, gn)), 1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads)


def _grad32(cfg: OptConfig, p32, g):
    """The f32 gradient, plus weight decay: fma(wd, p, g)."""
    g32 = g.to(torch.float32)
    if cfg.weight_decay:
        g32 = fma_f32(p32, _f32(cfg.weight_decay, p32), g32)
    return g32


# entries of a leaf an update takes at a time: fma_f32 works in f64, so a
# slice's temporaries are a few times 8 bytes an entry
CHUNK = 1 << 24


def _chunked(upd, leaves):
    """upd on corresponding leaves (p, g and state of one parameter). Every
    op of an update is elementwise, so a leaf of more than CHUNK entries
    updates slice by slice into preallocated outputs, each slice's
    temporaries let go before the next: the same bits, bounded memory."""
    n = leaves[0].numel()
    if n <= CHUNK:
        return upd(*leaves)
    flat = [l.reshape(-1) for l in leaves]
    outs = None
    for s in range(0, n, CHUNK):
        part = upd(*(f[s:s + CHUNK] for f in flat))
        if outs is None:
            outs = [torch.empty(n, dtype=o.dtype, device=o.device)
                    for o in part]
        for o, v in zip(outs, part):
            o[s:s + CHUNK] = v
    return tuple(o.reshape(leaves[0].shape) for o in outs)


def _per_leaf(upd, params, *trees):
    """upd over corresponding leaves -> a tree per output of upd."""
    outs = [_chunked(upd, leaves) for leaves in
            zip(tree_leaves(params), *map(tree_leaves, trees))]
    paths = tree_paths(params)
    return tuple(tree_unflatten(paths, list(col)) for col in zip(*outs))


def sgd(cfg: OptConfig, params, grads, state, lr):
    grads = _clip(grads, cfg.grad_clip)

    def upd(p, g):
        p32 = p.to(torch.float32)
        neg_lr = -torch.as_tensor(lr, dtype=torch.float32).to(p.device)
        return (fma_f32(_grad32(cfg, p32, g), neg_lr, p32).to(p.dtype),)
    return _per_leaf(upd, params, grads)[0], state


def momentum(cfg: OptConfig, params, grads, state, lr):
    grads = _clip(grads, cfg.grad_clip)

    def upd(p, g, m):
        p32 = p.to(torch.float32)
        g32 = _grad32(cfg, p32, g)
        b1 = _f32(cfg.beta1, p32)
        m_new = fma_f32(m, b1, g32)
        step = fma_f32(m_new, b1, g32) if cfg.nesterov else m_new
        neg_lr = -torch.as_tensor(lr, dtype=torch.float32).to(p.device)
        return fma_f32(step, neg_lr, p32).to(p.dtype), m_new
    new_p, new_m = _per_leaf(upd, params, grads, state["m"])
    return new_p, {"m": new_m}


def _bias_correction(beta: float, count: int) -> float:
    """1 - beta ** count in f32, the power rounded from f64 on the host."""
    pw = np.float32(float(np.float32(beta)) ** count)
    return float(np.float32(1) - pw)


def adam(cfg: OptConfig, params, grads, state, lr):
    grads = _clip(grads, cfg.grad_clip)
    count = state["count"] + 1
    c = int(count)
    b1c, b2c = (_bias_correction(b, c) for b in (cfg.beta1, cfg.beta2))

    def upd(p, g, m, v):
        p32 = p.to(torch.float32)
        g32 = _grad32(cfg, p32, g)
        m_new = fma_f32(m, _f32(cfg.beta1, p32),
                        _f32(1 - cfg.beta1, p32) * g32)
        v_new = fma_f32(v, _f32(cfg.beta2, p32),
                        (_f32(1 - cfg.beta2, p32) * g32) * g32)
        step = m_new / (_f32(b1c, p32) * (_sqrt(v_new / _f32(b2c, p32))
                                          + _f32(cfg.eps, p32)))
        neg_lr = -torch.as_tensor(lr, dtype=torch.float32).to(p.device)
        return fma_f32(step, neg_lr, p32).to(p.dtype), m_new, v_new
    new_p, new_m, new_v = _per_leaf(upd, params, grads, state["m"],
                                    state["v"])
    return new_p, {"m": new_m, "v": new_v, "count": count}


def apply_updates(cfg: OptConfig, params, grads, state, lr):
    """Dispatch on cfg.name. `lr` is the scheduled learning rate (an f32
    scalar tensor or a number)."""
    fn = {"sgd": sgd, "momentum": momentum, "adam": adam}[cfg.name]
    return fn(cfg, params, grads, state, lr)
