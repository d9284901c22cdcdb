"""Transformer blocks of the train path (the JAX package's models/blocks.py:
gqa_attention, _mla_qkv, mla_attention and decoder_block). The decode
cache (`collect_cache > 0`) and the encoder-decoder cross-attention
(`memory=`) belong to the serving and audio paths (ROADMAP Queue 1, item
3b) and raise.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.core.wire import not_ported
from repro_torch.models.dist import (DistConfig, fdot, region_in, region_out,
                                     tp_shared)
from repro_torch.models.flash import flash_attention
from repro_torch.models.layers import (apply_norm, expand_kv, head_mask, mlp,
                                       rmsnorm, rope)
from repro_torch.models.moe import moe_ffn

ITEM_3B = "item 3b (SSM, hybrid, audio and serving)"


def _no_cache(collect_cache: int) -> None:
    if collect_cache:
        raise not_ported("the decode cache (collect_cache > 0)", ITEM_3B)


def gqa_attention(p: Dict, x: torch.Tensor, cfg, dist: DistConfig, *,
                  causal=True, window=0, pos_offset=0, use_rope=True,
                  prefix="", collect_cache: int = 0, tp_size: int = 1):
    """x (B,S,d) -> ((B,S,d) attention residual branch, norm included;
    None)."""
    _no_cache(collect_cache)
    dh = cfg.d_head
    h = apply_norm(p, f"{prefix}attn_norm", x, cfg, dist)
    hq = region_in(h, dist)
    B, S, _ = hq.shape
    q = hq @ p[f"{prefix}wq"]
    Hl = q.shape[-1] // dh
    q = q.reshape(B, S, Hl, dh)
    k = (hq @ tp_shared(p[f"{prefix}wk"], dist.tp)).reshape(B, S, -1, dh)
    v = (hq @ tp_shared(p[f"{prefix}wv"], dist.tp)).reshape(B, S, -1, dh)
    pos = pos_offset + torch.arange(S, device=x.device)
    if use_rope:
        q = rope(q, pos, cfg.rope_theta)
        k = rope(k, pos, cfg.rope_theta)
    ke = expand_kv(k, Hl, 0, cfg.n_heads, cfg.n_kv_heads)
    ve = expand_kv(v, Hl, 0, cfg.n_heads, cfg.n_kv_heads)
    o = flash_attention(q, ke, ve, window, causal, pos_offset)
    o = head_mask(o, cfg, dist, axis=2)
    return region_out(o.reshape(B, S, -1) @ p[f"{prefix}wo"], dist), None


def _mla_qkv(p, hq, cfg, dist, pos, fd=None):
    fd = fd or {}
    B, S, _ = hq.shape
    nope, rdim = cfg.qk_nope_dim, cfg.qk_rope_dim
    cq = rmsnorm(fdot(hq, tp_shared(p["wq_down"], dist.tp),
                      fd.get("wq_down"), dist),
                 tp_shared(p["q_norm_g"], dist.tp), cfg.norm_eps)
    qf = cq @ p["wq_up"]                               # (B,S,Hl*(nope+rdim))
    Hl = qf.shape[-1] // (nope + rdim)
    qf = qf.reshape(B, S, Hl, nope + rdim)
    q_nope, q_rope = qf[..., :nope], qf[..., nope:]
    q_rope = rope(q_rope, pos, cfg.rope_theta)
    kvd = fdot(hq, tp_shared(p["wkv_down"], dist.tp), fd.get("wkv_down"),
               dist)                                   # (B,S,r+rdim)
    c_kv = rmsnorm(kvd[..., :cfg.kv_lora_rank],
                   tp_shared(p["kv_norm_g"], dist.tp), cfg.norm_eps)
    k_rope = rope(kvd[..., None, cfg.kv_lora_rank:], pos, cfg.rope_theta)
    return q_nope, q_rope, c_kv, k_rope, Hl


def mla_attention(p: Dict, x: torch.Tensor, cfg, dist: DistConfig, *,
                  pos_offset=0, collect_cache: int = 0, tp_size: int = 1):
    """Multi-head latent attention (MiniCPM3 / DeepSeek style), causal:
    -> ((B,S,d), None)."""
    _no_cache(collect_cache)
    nope, rdim, vdim = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    h = apply_norm(p, "attn_norm", x, cfg, dist)
    hq = region_in(h, dist)
    B, S, _ = hq.shape
    pos = pos_offset + torch.arange(S, device=x.device)
    q_nope, q_rope, c_kv, k_rope, Hl = _mla_qkv(p, hq, cfg, dist, pos)
    k_nope = (c_kv @ p["wk_up"]).reshape(B, S, Hl, nope)
    vv = (c_kv @ p["wv_up"]).reshape(B, S, Hl, vdim)
    k = torch.cat([k_nope, k_rope.expand(B, S, Hl, rdim)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    o = flash_attention(q, k, vv, 0, True, pos_offset)
    o = head_mask(o, cfg, dist, axis=2)
    return region_out(o.reshape(B, S, -1) @ p["wo"], dist), None


def decoder_block(p: Dict, x: torch.Tensor, cfg, dist: DistConfig, *,
                  window=0, pos_offset=0, causal=True, use_rope=True,
                  memory: Optional[torch.Tensor] = None,
                  collect_cache: int = 0, tp_size: int = 1):
    """Generic transformer block -> (x, aux_loss f32 scalar, None)."""
    if memory is not None:
        raise not_ported("cross-attention to an encoder memory (memory=)",
                         ITEM_3B)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.attention == "mla":
        a, _ = mla_attention(p, x, cfg, dist, pos_offset=pos_offset,
                             collect_cache=collect_cache, tp_size=tp_size)
        x = x + a
    elif cfg.attention != "none":
        a, _ = gqa_attention(p, x, cfg, dist, causal=causal, window=window,
                             pos_offset=pos_offset, use_rope=use_rope,
                             collect_cache=collect_cache, tp_size=tp_size)
        x = x + a
    h = apply_norm(p, "mlp_norm", x, cfg, dist)
    if cfg.n_experts:
        B, S, d = h.shape
        out, aux = moe_ffn(p, h.reshape(B * S, d), cfg, dist)
        x = x + out.reshape(B, S, d)
    else:
        x = x + mlp(p, h, cfg, dist)
    return x, aux, None
