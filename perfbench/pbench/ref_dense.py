"""Plain reference of a dense decoder-only LM (RoPE, grouped-query
attention, SwiGLU, RMSNorm; phi4-mini's family), in float32 with plain
torch operations and no kernel, cache or batching of the program's.

The parameter layout is the one the benchmark hands the program: a flat
dict of leaves keyed by "/"-joined paths, layer-stacked leaves under
"blocks/" with the layer count leading, matrices stored (in, out).
"""
from __future__ import annotations

import math
from typing import Callable, Dict

import torch
import torch.nn.functional as F

from pbench.ref_common import (NORMAL, ONES, Leaf, padded_vocab,
                               plain_matmul, rmsnorm, xent_sum)


def program_fields(c: dict) -> dict:
    """The program's ModelConfig fields of the configuration file `c`."""
    if c["partial_rotary_factor"] != 1.0 or c["rope_scaling"] is not None:
        raise ValueError("the reference rotates whole heads, unscaled")
    return dict(arch_type="dense", n_layers=c["num_hidden_layers"],
                d_model=c["hidden_size"], vocab=c["vocab_size"],
                n_heads=c["num_attention_heads"],
                n_kv_heads=c["num_key_value_heads"], d_head=c["head_dim"],
                rope_theta=float(c["rope_theta"]),
                d_ff=c["intermediate_size"], mlp="swiglu",
                norm_eps=c["rms_norm_eps"],
                tie_embeddings=c["tie_word_embeddings"], dtype=c["dtype"])


def leaves(c: dict) -> Dict[str, Leaf]:
    """Every parameter leaf: shape, init and standard deviation (normal
    leaves: 1 / sqrt(fan-in))."""
    d, L, ff = c["hidden_size"], c["num_hidden_layers"], c["intermediate_size"]
    dq = c["num_attention_heads"] * c["head_dim"]
    dkv = c["num_key_value_heads"] * c["head_dim"]
    V = padded_vocab(c)
    out = {"embed": Leaf((V, d), NORMAL, 1 / math.sqrt(d)),
           "final_norm_g": Leaf((d,), ONES)}
    if not c["tie_word_embeddings"]:
        out["head"] = Leaf((d, V), NORMAL, 1 / math.sqrt(d))
    for name, shape, std in (
            ("attn_norm_g", (L, d), None), ("mlp_norm_g", (L, d), None),
            ("wq", (L, d, dq), d), ("wk", (L, d, dkv), d),
            ("wv", (L, d, dkv), d), ("wo", (L, dq, d), dq),
            ("w_gate", (L, d, ff), d), ("w_in", (L, d, ff), d),
            ("w_out", (L, ff, d), ff)):
        out["blocks/" + name] = (Leaf(shape, ONES) if std is None else
                                 Leaf(shape, NORMAL, 1 / math.sqrt(std)))
    return out


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding, split-half convention: x (B, S, H, dh) at
    positions 0 .. S-1, frequencies theta ** (-i / (dh / 2))."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float64,
                                    device=x.device) / half)
    ang = torch.arange(x.shape[1], dtype=torch.float64,
                       device=x.device)[:, None] * freqs
    cos = torch.cos(ang).to(x.dtype)[None, :, None, :]
    sin = torch.sin(ang).to(x.dtype)[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _layer(P: Dict[str, torch.Tensor], i: int, x: torch.Tensor, c: dict,
           mm: Callable) -> torch.Tensor:
    B, S, _ = x.shape
    H, Hkv, dh = (c["num_attention_heads"], c["num_key_value_heads"],
                  c["head_dim"])
    eps = c["rms_norm_eps"]
    h = rmsnorm(x, P["blocks/attn_norm_g"][i], eps)
    q = mm(h, P["blocks/wq"][i]).reshape(B, S, H, dh)
    k = mm(h, P["blocks/wk"][i]).reshape(B, S, Hkv, dh)
    v = mm(h, P["blocks/wv"][i]).reshape(B, S, Hkv, dh)
    q = _rope(q, c["rope_theta"])
    k = _rope(k, c["rope_theta"])
    k = k.repeat_interleave(H // Hkv, dim=2)       # q head j reads kv j // g
    v = v.repeat_interleave(H // Hkv, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(dh)
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    p = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(B, S, H * dh)
    x = x + mm(o, P["blocks/wo"][i])
    h = rmsnorm(x, P["blocks/mlp_norm_g"][i], eps)
    a = F.silu(mm(h, P["blocks/w_gate"][i])) * mm(h, P["blocks/w_in"][i])
    return x + mm(a, P["blocks/w_out"][i])


def loss(P: Dict[str, torch.Tensor], tokens: torch.Tensor,
         targets: torch.Tensor, c: dict,
         mm: Callable = plain_matmul) -> torch.Tensor:
    """Mean next-token cross-entropy over every position of the rows."""
    x = P["embed"][tokens]
    for i in range(c["num_hidden_layers"]):
        x = torch.utils.checkpoint.checkpoint(_layer, P, i, x, c, mm,
                                              use_reentrant=False)
    x = rmsnorm(x, P["final_norm_g"], c["rms_norm_eps"])
    head = (P["embed"].t() if c["tie_word_embeddings"] else P["head"])
    return xent_sum(x.reshape(-1, x.shape[-1]), head, targets.reshape(-1),
                    c["vocab_size"], mm) / targets.numel()


def flops_per_token(c: dict, seq: int) -> float:
    """Model FLOPs of one token's forward and backward: 6 x the matmul
    parameters it passes through (the output head included, the embedding
    lookup not) plus the causal attention's score and value products
    (3 x forward)."""
    d, L, ff = c["hidden_size"], c["num_hidden_layers"], c["intermediate_size"]
    dq = c["num_attention_heads"] * c["head_dim"]
    dkv = c["num_key_value_heads"] * c["head_dim"]
    mm_params = L * (d * dq + 2 * d * dkv + dq * d + 3 * d * ff)
    mm_params += d * c["vocab_size"]
    # a token at position t attends to t + 1 keys: on average (S + 1) / 2
    attn = L * 2 * 2 * dq * (seq + 1) / 2
    return 6.0 * mm_params + 3.0 * attn
