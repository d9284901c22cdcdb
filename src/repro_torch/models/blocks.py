"""Transformer blocks, the train / prefill path and the one-token decode
path (the JAX package's models/blocks.py), TP-aware through models.dist.

`collect_cache > 0` (prefill) also returns this rank's sequence shard of
the layer's decode cache of that total length: TP rank r holds the
collect_cache / tp_size slots from r * Ss of k / v (int8 with per-vector
scales when cfg.kv_cache_dtype == "int8"), or of MLA's latent c_kv and
shared rope key, with slot_pos (-1 past the prompt). As in the
reference, a pure sliding-window arch's ring cache is filled with
positions 0 .. window-1 even when the prompt is longer (ROADMAP Queue 3).
The decode functions write the new token into the cache they are given,
IN PLACE, and return it.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.dist import (DistConfig, all_gather, axis_index,
                                     fdot, pmax, psum, region_in, region_out,
                                     tp_region_in, tp_region_out, tp_shared)
from repro_torch.models.flash import flash_attention
from repro_torch.models.layers import (NEG_INF, apply_norm, cache_write,
                                       expand_kv, head_mask, inv_sqrt_f32,
                                       mlp, quantize_kv, rmsnorm, rope,
                                       splitkv_decode)
from repro_torch.models.moe import moe_ffn


def _collect(t: torch.Tensor, S: int, start: int, Ss: int) -> torch.Tensor:
    """(B,S,...) -> positions [start, start + Ss), zero-padded past S."""
    pad = [0, 0] * (t.dim() - 2) + [0, max(0, start + Ss - S)]
    return F.pad(t, pad)[:, start:start + Ss]


def _slot_pos(S: int, start: int, Ss: int, device) -> torch.Tensor:
    spos = start + torch.arange(Ss, dtype=torch.int32, device=device)
    return torch.where(spos < S, spos, -1)


def _pos_vec(pos: int, device) -> torch.Tensor:
    """The decode position as a (1, 1) tensor (a fill, no host copy)."""
    return torch.full((1, 1), pos, dtype=torch.int32, device=device)


def gqa_attention(p: Dict, x: torch.Tensor, cfg, dist: DistConfig, *,
                  causal=True, window=0, pos_offset=0, use_rope=True,
                  prefix="", collect_cache: int = 0, tp_size: int = 1):
    """x (B,S,d) -> ((B,S,d) attention residual branch, norm included;
    the layer's cache of length collect_cache, or None)."""
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
    r = axis_index(dist.tp)
    ke = expand_kv(k, Hl, r, cfg.n_heads, cfg.n_kv_heads)
    ve = expand_kv(v, Hl, r, cfg.n_heads, cfg.n_kv_heads)
    o = flash_attention(q, ke, ve, window, causal, pos_offset)
    o = head_mask(o, cfg, dist, axis=2)
    out = region_out(o.reshape(B, S, -1) @ p[f"{prefix}wo"], dist)
    cache = None
    if collect_cache:
        Ss = collect_cache // tp_size
        kt = _collect(k, S, r * Ss, Ss).transpose(1, 2)  # (B,Hkv,Ss,dh)
        vt = _collect(v, S, r * Ss, Ss).transpose(1, 2)
        spos = _slot_pos(S, r * Ss, Ss, x.device)
        if cfg.kv_cache_dtype == "int8":
            kq, ksc = quantize_kv(kt)
            vq, vsc = quantize_kv(vt)
            cache = {"k": kq, "v": vq, "k_scale": ksc, "v_scale": vsc,
                     "slot_pos": spos}
        else:
            cache = {"k": kt, "v": vt, "slot_pos": spos}
    return out, cache


def gqa_cross_attention(p: Dict, x: torch.Tensor, memory: torch.Tensor, cfg,
                        dist: DistConfig) -> torch.Tensor:
    """Cross-attention (whisper's decoder): q from x, k / v from the
    encoder memory (B,M,d), recomputed at every call as the reference
    does."""
    dh = cfg.d_head
    h = apply_norm(p, "cross_norm", x, cfg, dist)
    hq = region_in(h, dist)
    B, S, _ = hq.shape
    mq = tp_region_in(memory, dist.tp)
    q = hq @ p["cwq"]
    Hl = q.shape[-1] // dh
    q = q.reshape(B, S, Hl, dh)
    M = memory.shape[1]
    k = (mq @ tp_shared(p["cwk"], dist.tp)).reshape(B, M, -1, dh)
    v = (mq @ tp_shared(p["cwv"], dist.tp)).reshape(B, M, -1, dh)
    r = axis_index(dist.tp)
    ke = expand_kv(k, Hl, r, cfg.n_heads, cfg.n_kv_heads)
    ve = expand_kv(v, Hl, r, cfg.n_heads, cfg.n_kv_heads)
    o = flash_attention(q, ke, ve, 0, False, 0)
    o = head_mask(o, cfg, dist, axis=2)
    return region_out(o.reshape(B, S, -1) @ p["cwo"], dist)


def gqa_attention_decode(p: Dict, x: torch.Tensor, cache: Dict, pos: int,
                         cfg, dist: DistConfig, *, window=0, use_rope=True,
                         prefix="", fd=None):
    """One-token attention: x (B,1,d); cache {k, v (B,Hkv,Ss,dh), slot_pos
    (Ss,)} (+ k_scale / v_scale for int8), written in place -> (out, cache)."""
    fd = fd or {}
    B = x.shape[0]
    dh = cfg.d_head
    h = apply_norm(p, f"{prefix}attn_norm", x, cfg)
    hq = tp_region_in(h, dist.tp)
    q = fdot(hq, p[f"{prefix}wq"], fd.get(f"{prefix}wq"), dist)
    Hl = q.shape[-1] // dh
    q = q.reshape(B, 1, Hl, dh)
    k = fdot(hq, tp_shared(p[f"{prefix}wk"], dist.tp),
             fd.get(f"{prefix}wk"), dist).reshape(B, 1, -1, dh)
    v = fdot(hq, tp_shared(p[f"{prefix}wv"], dist.tp),
             fd.get(f"{prefix}wv"), dist).reshape(B, 1, -1, dh)
    if use_rope:
        pv = _pos_vec(pos, x.device)
        q = rope(q, pv, cfg.rope_theta)
        k = rope(k, pv, cfg.rope_theta)
    q1, k1, v1 = q[:, 0], k[:, 0], v[:, 0]
    ring = (cfg.sliding_window if (cfg.sliding_window > 0
                                   and cfg.swa_pattern == 0) else 0)
    spos = cache["slot_pos"]
    scales = {}
    if cfg.kv_cache_dtype == "int8":
        k1, k1s = quantize_kv(k1)
        v1, v1s = quantize_kv(v1)
        cache_write(cache["k_scale"], spos, k1s, pos, dist, ring_size=ring)
        cache_write(cache["v_scale"], spos, v1s, pos, dist, ring_size=ring)
        scales = {"k_scale": cache["k_scale"], "v_scale": cache["v_scale"]}
    cache_write(cache["k"], spos, k1, pos, dist, ring_size=ring)
    cache_write(cache["v"], spos, v1, pos, dist, ring_size=ring)
    o = splitkv_decode(q1, cache["k"], cache["v"], spos, pos, dist=dist,
                       n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                       window=window, **scales)
    o = head_mask(o, cfg, dist, axis=1)
    out = tp_region_out(
        fdot(o.reshape(B, 1, -1).to(x.dtype), p[f"{prefix}wo"],
             fd.get(f"{prefix}wo"), dist), dist.tp)
    return out, cache


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
    -> ((B,S,d), the latent cache of length collect_cache or None)."""
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
    out = region_out(o.reshape(B, S, -1) @ p["wo"], dist)
    cache = None
    if collect_cache:
        Ss = collect_cache // tp_size
        start = axis_index(dist.tp) * Ss
        cache = {"ckv": _collect(c_kv, S, start, Ss)[:, None],
                 "krope": _collect(k_rope[:, :, 0, :], S, start, Ss)[:, None],
                 "slot_pos": _slot_pos(S, start, Ss, x.device)}
    return out, cache


def mla_attention_decode(p: Dict, x: torch.Tensor, cache: Dict, pos: int,
                         cfg, dist: DistConfig, fd=None):
    """Absorbed MLA decode against the latent cache {ckv (B,1,Ss,r), krope
    (B,1,Ss,rdim), slot_pos (Ss,)}, written in place -> (out, cache). The
    score scale 1 / sqrt(nope + rdim) is a multiply by its f32 value, as
    XLA compiles the reference's divide."""
    B = x.shape[0]
    nope, rdim, vdim = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    r_lat = cfg.kv_lora_rank
    h = apply_norm(p, "attn_norm", x, cfg)
    hq = tp_region_in(h, dist.tp)
    q_nope, q_rope, c_kv, k_rope, Hl = _mla_qkv(
        p, hq, cfg, dist, _pos_vec(pos, x.device), fd=fd)
    # absorb k_up into q: q_eff_h = q_nope_h . W_kup_h^T, in latent space
    wk = p["wk_up"].reshape(r_lat, Hl, nope)
    q_eff = torch.einsum("bhn,rhn->bhr", q_nope[:, 0].to(torch.float32),
                         wk.to(torch.float32))           # (B,Hl,r)
    qr = q_rope[:, 0].to(torch.float32)                  # (B,Hl,rdim)
    spos = cache["slot_pos"]
    ck, _ = cache_write(cache["ckv"], spos, c_kv, pos, dist)
    kr, _ = cache_write(cache["krope"], spos, k_rope[:, 0], pos, dist)
    # gather every head's latent query (tiny), split-KV over the cache
    q_loc = torch.cat([q_eff, qr], dim=-1)
    q_all = all_gather(q_loc, dist.tp, gather_axis=1)    # (B,H,r+rdim)
    lat = torch.cat([ck[:, 0], kr[:, 0]], dim=-1)        # (B,Ss,r+rdim)
    s = torch.einsum("bhr,bsr->bhs", q_all, lat.to(torch.float32)) \
        * inv_sqrt_f32(nope + rdim)
    valid = (spos >= 0) & (spos <= pos)
    s = torch.where(valid[None, None, :], s, NEG_INF)
    m_l = torch.clamp_min(s.amax(dim=-1), 2 * NEG_INF)
    pr = torch.exp(s - m_l[..., None])
    den_l = pr.sum(dim=-1)
    num_l = torch.einsum("bhs,bsr->bhr", pr, ck[:, 0].to(torch.float32))
    if q_all is q_loc:                                   # one shard
        ctx = num_l / torch.clamp_min(den_l[..., None], 1e-30)
    else:
        m = pmax(m_l, dist.tp)
        corr = torch.exp(m_l - m)
        num = psum(num_l * corr[..., None], dist.tp)
        den = psum(den_l * corr, dist.tp)
        ctx = num / torch.clamp_min(den[..., None], 1e-30)
        rk = axis_index(dist.tp)
        ctx = ctx[:, rk * Hl:(rk + 1) * Hl]              # (B,Hl,r) latent
    wv = p["wv_up"].reshape(r_lat, Hl, vdim)
    o = torch.einsum("bhr,rhv->bhv", ctx, wv.to(torch.float32))
    o = head_mask(o, cfg, dist, axis=1)
    fd = fd or {}
    out = tp_region_out(
        fdot(o.reshape(B, 1, -1).to(x.dtype), p["wo"], fd.get("wo"), dist),
        dist.tp)
    return out, cache


def decoder_block(p: Dict, x: torch.Tensor, cfg, dist: DistConfig, *,
                  window=0, pos_offset=0, causal=True, use_rope=True,
                  memory: Optional[torch.Tensor] = None,
                  collect_cache: int = 0, tp_size: int = 1):
    """Generic transformer block -> (x, aux_loss f32 scalar, cache|None);
    `memory` (B,M,d) adds cross-attention to an encoder's output."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    cache = None
    if cfg.attention == "mla":
        a, cache = mla_attention(p, x, cfg, dist, pos_offset=pos_offset,
                                 collect_cache=collect_cache, tp_size=tp_size)
        x = x + a
    elif cfg.attention != "none":
        a, cache = gqa_attention(p, x, cfg, dist, causal=causal,
                                 window=window, pos_offset=pos_offset,
                                 use_rope=use_rope,
                                 collect_cache=collect_cache, tp_size=tp_size)
        x = x + a
    if memory is not None:
        x = x + gqa_cross_attention(p, x, memory, cfg, dist)
    h = apply_norm(p, "mlp_norm", x, cfg, dist)
    if cfg.n_experts:
        B, S, d = h.shape
        out, aux = moe_ffn(p, h.reshape(B * S, d), cfg, dist)
        x = x + out.reshape(B, S, d)
    else:
        x = x + mlp(p, h, cfg, dist)
    return x, aux, cache


def decoder_block_decode(p: Dict, x: torch.Tensor, cache: Dict, pos: int,
                         cfg, dist: DistConfig, *, window=0,
                         memory: Optional[torch.Tensor] = None, fd=None):
    """One-token decoder_block, the cache written in place -> (x, cache).
    MoE routes the B tokens of the step on their own, so its capacity is
    the step's, as in the reference."""
    if cfg.attention == "mla":
        a, cache = mla_attention_decode(p, x, cache, pos, cfg, dist, fd=fd)
        x = x + a
    elif cfg.attention != "none":
        a, cache = gqa_attention_decode(p, x, cache, pos, cfg, dist,
                                        window=window, use_rope=cfg.use_rope,
                                        fd=fd)
        x = x + a
    if memory is not None:
        x = x + gqa_cross_attention(p, x, memory, cfg, dist)
    h = apply_norm(p, "mlp_norm", x, cfg)
    if cfg.n_experts:
        B, S, d = h.shape
        out, _ = moe_ffn(p, h.reshape(B * S, d), cfg, dist, fd=fd)
        x = x + out.reshape(B, S, d)
    else:
        x = x + mlp(p, h, cfg, dist, fd=fd)
    return x, cache
