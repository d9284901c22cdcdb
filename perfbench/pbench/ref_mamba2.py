"""Plain reference of Mamba-2 (arXiv:2405.21060), in float32 with plain
torch operations: each block's state-space mixer in its quadratic
(attention-like) form over the whole sequence, which does not depend on
the chunk length the program scans with.

Block: x + out_proj(norm(y) * silu(z)), where from the normed input
z = x W_z, the values x W_x and the B / C projections pass a causal
depthwise convolution and SiLU, dt = softplus(x W_dt + dt_bias), and
    y_t = sum_{s <= t} (C_t . B_s) exp(sum_{s < r <= t} dt_r A) dt_s x_s
          + D x_t
per head, A = -exp(A_log); the gated RMSNorm is per head. Parameters
follow ref_dense's layout ("blocks/" stacked leaves, matrices (in, out)).
"""
from __future__ import annotations

import math
from typing import Callable, Dict

import torch
import torch.nn.functional as F

from pbench.ref_common import (NORMAL, ONES, ZEROS, Leaf, padded_vocab,
                               plain_matmul, rmsnorm, xent_sum)


def _dims(c: dict):
    d_in = c["expand"] * c["d_model"]
    if (c["ngroups"] != 1 or c["conv_bias"] or not c["norm_before_gate"]
            or c["norm_group_size"] != c["headdim"]):
        raise ValueError("the reference holds one B / C group, bias-free "
                         "convolutions and a per-head norm before the gate")
    return d_in, d_in // c["headdim"], c["d_state"], c["d_conv"]


def program_fields(c: dict) -> dict:
    """The program's ModelConfig fields of the configuration file `c`."""
    return dict(arch_type="ssm", attention="none", n_layers=c["n_layer"],
                d_model=c["d_model"], vocab=c["vocab_size"], d_ff=0,
                tie_embeddings=c["tie_embeddings"], ssm_state=c["d_state"],
                ssm_expand=c["expand"], ssm_head_dim=c["headdim"],
                ssm_chunk=c["chunk_size"], ssm_conv=c["d_conv"],
                ssm_groups=c["ngroups"], norm_eps=c["norm_epsilon"],
                dtype=c["dtype"])


def leaves(c: dict) -> Dict[str, Leaf]:
    d, L = c["d_model"], c["n_layer"]
    d_in, nh, N, K = _dims(c)
    out = {"embed": Leaf((padded_vocab(c), d), NORMAL, 1 / math.sqrt(d)),
           "final_norm_g": Leaf((d,), ONES)}
    if not c["tie_embeddings"]:
        out["head"] = Leaf((d, padded_vocab(c)), NORMAL, 1 / math.sqrt(d))
    for name, leaf in (
            ("norm_in_g", Leaf((L, d), ONES)),
            ("w_z", Leaf((L, d, d_in), NORMAL, 1 / math.sqrt(d))),
            ("w_x", Leaf((L, d, d_in), NORMAL, 1 / math.sqrt(d))),
            ("w_bc", Leaf((L, d, 2 * N), NORMAL, 1 / math.sqrt(d))),
            ("w_dt", Leaf((L, d, nh), NORMAL, 1 / math.sqrt(d))),
            ("conv_x", Leaf((L, d_in, K), NORMAL, 0.5 / math.sqrt(K))),
            ("conv_bc", Leaf((L, 2 * N, K), NORMAL, 0.5 / math.sqrt(K))),
            ("A_log", Leaf((L, nh), ZEROS)), ("D", Leaf((L, nh), ONES)),
            ("dt_bias", Leaf((L, nh), ZEROS)),
            ("norm_g", Leaf((L, d_in), ONES)),
            ("w_out", Leaf((L, d_in, d), NORMAL, 1 / math.sqrt(d_in)))):
        out["blocks/" + name] = leaf
    return out


def _conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Causal depthwise convolution along the sequence: x (B, S, C), w
    (C, K); output t sees inputs t - K + 1 .. t, w[:, K - 1] weighting t."""
    K = w.shape[1]
    y = F.conv1d(x.transpose(1, 2), w[:, None, :], padding=K - 1,
                 groups=w.shape[0])
    return y[..., :x.shape[1]].transpose(1, 2)


def _mixer(xh, dt, A, Bm, Cm, D):
    """xh (B, S, H, P), dt (B, S, H), A (H,), Bm / Cm (B, S, N), D (H,)
    -> y (B, S, H, P)."""
    S = xh.shape[1]
    cs = torch.cumsum(dt * A, dim=1).permute(0, 2, 1)       # (B, H, S)
    seg = cs[..., :, None] - cs[..., None, :]                # (B, H, t, s)
    causal = torch.ones(S, S, dtype=torch.bool, device=xh.device).tril()
    decay = torch.exp(seg.masked_fill(~causal, float("-inf")))
    cb = torch.einsum("btn,bsn->bts", Cm, Bm)
    m = cb[:, None] * decay * dt.permute(0, 2, 1)[:, :, None, :]
    y = torch.einsum("bhts,bshp->bthp", m, xh)
    return y + D[None, None, :, None] * xh


def _layer(P: Dict[str, torch.Tensor], i: int, x: torch.Tensor, c: dict,
           mm: Callable) -> torch.Tensor:
    B, S, _ = x.shape
    d_in, nh, N, _ = _dims(c)
    eps = c["norm_epsilon"]
    h = rmsnorm(x, P["blocks/norm_in_g"][i], eps)
    z = mm(h, P["blocks/w_z"][i])
    xr = F.silu(_conv(mm(h, P["blocks/w_x"][i]), P["blocks/conv_x"][i]))
    bc = F.silu(_conv(mm(h, P["blocks/w_bc"][i]), P["blocks/conv_bc"][i]))
    dt = F.softplus(mm(h, P["blocks/w_dt"][i]) + P["blocks/dt_bias"][i])
    A = -torch.exp(P["blocks/A_log"][i])
    y = _mixer(xr.reshape(B, S, nh, -1), dt, A, bc[..., :N], bc[..., N:],
               P["blocks/D"][i])
    y = rmsnorm(y, P["blocks/norm_g"][i].reshape(nh, -1), eps)
    y = y.reshape(B, S, d_in) * F.silu(z)
    return x + mm(y, P["blocks/w_out"][i])


def loss(P: Dict[str, torch.Tensor], tokens: torch.Tensor,
         targets: torch.Tensor, c: dict,
         mm: Callable = plain_matmul) -> torch.Tensor:
    x = P["embed"][tokens]
    for i in range(c["n_layer"]):
        x = torch.utils.checkpoint.checkpoint(_layer, P, i, x, c, mm,
                                              use_reentrant=False)
    x = rmsnorm(x, P["final_norm_g"], c["norm_epsilon"])
    head = P["embed"].t() if c["tie_embeddings"] else P["head"]
    return xent_sum(x.reshape(-1, x.shape[-1]), head, targets.reshape(-1),
                    c["vocab_size"], mm) / targets.numel()


def flops_per_token(c: dict, seq: int) -> float:
    """Model FLOPs of one token's forward and backward: 6 x the matmul
    parameters it passes through (the tied output head included, the
    embedding lookup not) plus 3 x the forward products of the chunked
    state-space scan at chunk Q a token: the causal half of C B^T and of
    its (Q x Q) product with each head's values, and each head's chunk
    state (B^T x) and its read-out (C state)."""
    d, L = c["d_model"], c["n_layer"]
    d_in, nh, N, _ = _dims(c)
    P, Q = c["headdim"], c["chunk_size"]
    mm_params = L * (d * (2 * d_in + 2 * N + nh) + d_in * d)
    mm_params += d * c["vocab_size"]
    half = (Q + 1) / 2                  # keys a position sees in its chunk
    ssd = L * (2 * half * N + nh * 2 * half * P + nh * 4 * N * P)
    return 6.0 * mm_params + 3.0 * ssd
