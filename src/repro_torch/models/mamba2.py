"""Mamba2 / SSD (state-space duality, arXiv:2405.21060) in plain torch (the
JAX package's models/mamba2.py), one device.

Chunked SSD: within a chunk the recurrence is a masked quadratic form;
across chunks a loop over the chunks (the reference's lax.scan) carries
the (heads, head_dim, state) SSM state. Every contraction is a
two-operand einsum, as the reference keeps them (a multi-operand form
materializes a 6-D outer product). Decode is the O(1) recurrent step on
the carried state; the port writes the decode states in place.

The gated output RMSNorm is per head (group size = head_dim).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.dist import (DistConfig, region_in, region_out,
                                     tp_region_in, tp_region_out, tp_shared)
from repro_torch.models.layers import rmsnorm, silu


def softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus, logaddexp(x, 0) (no threshold, unlike F.softplus)."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def _dt_f32(xw: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The step before its softplus: `(x @ w_dt + dt_bias).astype(f32)` as
    XLA computes it, the sum taken in f32 from the rounded product and
    never rounded to the model's dtype (the same in f32)."""
    return xw.to(torch.float32) + bias.to(torch.float32)[None, None, :]


def segsum(x: torch.Tensor) -> torch.Tensor:
    """x (..., Q) -> (..., Q, Q) with out[i, j] = sum_{l=j+1..i} x_l
    (i >= j), -inf above the diagonal."""
    Q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    d = cs[..., :, None] - cs[..., None, :]
    i = torch.arange(Q, device=x.device)
    return torch.where(i[:, None] >= i[None, :], d, float("-inf"))


def _causal_conv(x: torch.Tensor, w: torch.Tensor, state=None):
    """Depthwise causal conv along the sequence: x (B,S,C), w (C,K); state
    (B,K-1,C) is prepended (decode / prefill carry). The K products summed
    left to right from 0 in x's dtype, each product rounded first, as the
    reference. -> (y (B,S,C), new_state (B,K-1,C))."""
    K = w.shape[1]
    if state is None:
        state = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state, x], dim=1)
    S = x.shape[1]
    y = sum(xp[:, k:k + S, :] * w[:, k][None, None, :] for k in range(K))
    new_state = xp[:, -(K - 1):, :] if K > 1 else state
    return y, new_state


def ssd_chunked(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, D: torch.Tensor,
                chunk: int, init_state: torch.Tensor = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan. xh (B,S,H,P) values; dt (B,S,H) softplus'd step;
    A (H,) negative; Bm / Cm (B,S,N) group-shared projections; D (H,) skip.
    A sequence not a multiple of `chunk` is zero-padded (dt = 0 there, so
    the padding leaves the state alone). -> (y (B,S,H,P) in xh's dtype,
    final_state (B,H,P,N) f32)."""
    Bsz, S, H, P = xh.shape
    N = Bm.shape[-1]
    pad = (-S) % chunk
    dtype = xh.dtype
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    nc = xh.shape[1] // chunk
    f32 = torch.float32
    xc = xh.reshape(Bsz, nc, chunk, H, P).to(f32)
    dtc = dt.reshape(Bsz, nc, chunk, H).to(f32)
    Bc = Bm.reshape(Bsz, nc, chunk, N).to(f32)
    Cc = Cm.reshape(Bsz, nc, chunk, N).to(f32)

    dA = dtc * A[None, None, None, :]                     # (B,nc,Q,H) <= 0
    dA_h = dA.permute(0, 1, 3, 2)                         # (B,nc,H,Q)
    dA_cum = torch.cumsum(dA_h, dim=-1)
    dt_h = dtc.permute(0, 1, 3, 2)                        # (B,nc,H,Q)

    # 1) intra-chunk (quadratic, masked)
    L = torch.exp(segsum(dA_h))                           # (B,nc,H,Q,Q)
    CB = torch.einsum("bcqn,bckn->bcqk", Cc, Bc)          # (B,nc,Q,Q)
    M = CB[:, :, None, :, :] * L * dt_h[:, :, :, None, :]
    del L
    y = torch.einsum("bchqk,bckhp->bcqhp", M, xc)
    del M

    # 2) per-chunk input states
    decay_to_end = torch.exp(dA_cum[..., -1:] - dA_cum)   # (B,nc,H,Q)
    xw = xc * (decay_to_end.permute(0, 1, 3, 2) * dtc)[..., None]
    S_chunk = torch.einsum("bckn,bckhp->bchpn", Bc, xw)   # (B,nc,H,P,N)

    # 3) inter-chunk recurrence
    chunk_decay = torch.exp(dA_cum[..., -1])              # (B,nc,H)
    state = (torch.zeros((Bsz, H, P, N), dtype=f32, device=xh.device)
             if init_state is None else init_state.to(f32))
    prev = []
    for c in range(nc):
        prev.append(state)
        state = chunk_decay[:, c, :, None, None] * state + S_chunk[:, c]
    prev_states = torch.stack(prev, dim=1)                # (B,nc,H,P,N)

    # 4) inter-chunk output
    state_decay = torch.exp(dA_cum)                       # (B,nc,H,Q)
    y_inter = torch.einsum("bcqn,bchpn->bcqhp", Cc, prev_states) * \
        state_decay.permute(0, 1, 3, 2)[..., None]
    y = y + y_inter + D[None, None, None, :, None] * xc
    y = y.reshape(Bsz, nc * chunk, H, P)[:, :S]
    return y.to(dtype), state


def mamba2_block(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg,
                 dist: DistConfig, conv_state=None, ssm_state=None,
                 return_state: bool = False):
    """Full Mamba2 block (train / prefill). x (B,S,d) -> (B,S,d), and with
    return_state ((conv_x, conv_bc), ssm) for the decode cache."""
    N = cfg.ssm_state
    hd = cfg.ssm_head_dim
    xi = region_in(x, dist)
    z = xi @ p["w_z"]                                      # (B,S,d_in)
    xr = xi @ p["w_x"]
    bc = xi @ tp_shared(p["w_bc"], dist.tp)                # (B,S,2N)
    dt = softplus(_dt_f32(xi @ p["w_dt"], p["dt_bias"]))   # (B,S,H)

    cx0 = conv_state[0] if conv_state is not None else None
    cbc0 = conv_state[1] if conv_state is not None else None
    xr, new_cx = _causal_conv(xr, p["conv_x"], cx0)
    bc, new_cbc = _causal_conv(bc, tp_shared(p["conv_bc"], dist.tp), cbc0)
    xr = silu(xr)
    bc = silu(bc)
    Bm, Cm = bc[..., :N], bc[..., N:]

    H = p["A_log"].shape[0]
    xh = xr.reshape(*xr.shape[:2], H, hd)
    A = -torch.exp(p["A_log"].to(torch.float32))
    y, final_state = ssd_chunked(xh, dt, A, Bm, Cm,
                                 p["D"].to(torch.float32), cfg.ssm_chunk,
                                 init_state=ssm_state)
    y = rmsnorm(y, p["norm_g"].reshape(H, hd), cfg.norm_eps)
    y = y.reshape(xr.shape) * silu(z)
    out = region_out(y @ p["w_out"], dist)
    if return_state:
        return out, ((new_cx, new_cbc), final_state)
    return out


def mamba2_decode(p: Dict[str, torch.Tensor], x: torch.Tensor, conv_state,
                  ssm_state: torch.Tensor, cfg, dist: DistConfig):
    """One-token recurrent step. x (B,1,d); conv_state = (cx (B,K-1,d_in),
    cbc (B,K-1,2N)); ssm_state (B,H,P,N) f32. The three states are updated
    IN PLACE -> (out, ((cx, cbc), ssm_state)), the same tensors."""
    N = cfg.ssm_state
    hd = cfg.ssm_head_dim
    xi = tp_region_in(x, dist.tp)
    z = xi @ p["w_z"]
    xr = xi @ p["w_x"]
    bc = xi @ tp_shared(p["w_bc"], dist.tp)
    dt = softplus(_dt_f32(xi @ p["w_dt"], p["dt_bias"]))[:, 0]   # (B,H)

    cx, cbc = conv_state
    xr, new_cx = _causal_conv(xr, p["conv_x"], cx)
    bc, new_cbc = _causal_conv(bc, tp_shared(p["conv_bc"], dist.tp), cbc)
    cx.copy_(new_cx)
    cbc.copy_(new_cbc)
    xr = silu(xr)[:, 0]                                    # (B,d_in)
    bc = silu(bc)[:, 0]
    f32 = torch.float32
    Bm, Cm = bc[..., :N].to(f32), bc[..., N:].to(f32)      # (B,N)

    H = p["A_log"].shape[0]
    xh = xr.reshape(-1, H, hd).to(f32)                     # (B,H,P)
    A = -torch.exp(p["A_log"].to(f32))
    g = torch.exp(dt * A[None, :])                         # (B,H)
    upd = (dt[:, :, None] * xh)[..., None] * Bm[:, None, None, :]
    ssm_state.mul_(g[..., None, None]).add_(upd)           # (B,H,P,N)
    y = torch.einsum("bn,bhpn->bhp", Cm, ssm_state)
    y = y + p["D"].to(f32)[None, :, None] * xh
    y = rmsnorm(y.to(x.dtype), p["norm_g"].reshape(H, hd), cfg.norm_eps)
    y = y.reshape(x.shape[0], 1, -1) * silu(z)
    out = tp_region_out(y @ p["w_out"], dist.tp)
    return out, ((cx, cbc), ssm_state)
