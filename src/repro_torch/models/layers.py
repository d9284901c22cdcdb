"""Shared neural layers (the JAX package's models/layers.py): norms, RoPE,
MLPs, the chunked-attention oracle, GQA head expansion, padding-head
masks, sinusoidal positions, and the decode cache's int8 quantization,
split-KV decode attention over a sequence-sharded cache and cache writes.
Every function is TP-aware through models.dist (an unbound axis is one
device).

Plain torch, as the reference is jnp: the model's norms round as the
reference's do (`rsqrt(ms + eps)` cast to x's dtype before both
multiplies), which in bf16 is another function than the RMSNorm kernel's
all-f32 arithmetic, so the kernel is not used here.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.ref import fma_f32
from repro_torch.models.dist import (NEG_INF, DistConfig, all_gather,
                                     axis_index, fdot, pmax, psum, region_in,
                                     region_out, tp_shared)


# ---- norms ----------------------------------------------------------------

def _mean_f32(x: torch.Tensor) -> torch.Tensor:
    """The f32 mean over the last dim as the reference's jitted jnp.mean
    gives it: the f32 sum times the f32 reciprocal of the count (a Python
    scalar meets an f32 tensor as an f32, and needs no host-to-device
    copy, which would wait for the card)."""
    return x.to(torch.float32).sum(dim=-1, keepdim=True) * (1.0 / x.shape[-1])


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """The mean of the f32 squares; the inverse root cast to x's dtype
    before x * inv * gamma, each product rounded to x's dtype."""
    ms = _mean_f32(torch.square(x.to(torch.float32)))
    inv = torch.rsqrt(ms + eps).to(x.dtype)
    return x * inv * gamma.to(x.dtype)


def layernorm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    mu = _mean_f32(x)
    var = _mean_f32(torch.square(x.to(torch.float32))) - torch.square(mu)
    inv = torch.rsqrt(torch.clamp_min(var, 0.0) + eps)
    out = (x - mu.to(x.dtype)) * inv.to(x.dtype)
    return out * gamma.to(x.dtype) + beta.to(x.dtype)


def apply_norm(p: dict, name: str, x: torch.Tensor, cfg,
               dist=None) -> torch.Tensor:
    """The norm `name` of params p (`{name}_g`, and `{name}_b` for
    layernorm) on x. `dist` with sp=True marks a norm inside the
    sequence-parallel region: each TP rank sees another sequence shard, so
    the replicated norm params take their gradients summed over tp."""
    g = p[f"{name}_g"]
    sp = dist is not None and dist.sp
    if sp:
        g = tp_shared(g, dist.tp)
    if cfg.norm == "layernorm":
        b = p[f"{name}_b"]
        if sp:
            b = tp_shared(b, dist.tp)
        return layernorm(x, g, b, cfg.norm_eps)
    return rmsnorm(x, g, cfg.norm_eps)


# ---- RoPE (split-half convention) -------------------------------------------

def rope_freqs(half: int, theta: float, device=None) -> torch.Tensor:
    """(half,) f32 frequencies theta ** (-i / half) as the reference's
    jitted code gives them: XLA turns the divide by the constant into a
    multiply by the f32 reciprocal, then takes the power, which equals the
    f64 power rounded to f32 (bitwise for theta 1e4, 5e5, 1e6 at half 8,
    12, 16, 24, 56 and 64; tests/test_torch_lm_model.py)."""
    e = -torch.arange(half, dtype=torch.float32, device=device) * (1.0 / half)
    return torch.pow(float(theta), e.to(torch.float64)).to(torch.float32)


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, dh) with pos broadcastable to (..., S)."""
    half = x.shape[-1] // 2
    freqs = rope_freqs(half, theta, x.device)
    ang = pos[..., None].to(torch.float32) * freqs      # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                  # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half].to(torch.float32), x[..., half:].to(torch.float32)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


# ---- MLP ------------------------------------------------------------------

def silu(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.silu as the reference's jitted code computes it. XLA expands
    the logistic into exp(-x), 1 + e, 1 / d and x * s, and below f32 rounds
    each step to x's dtype; F.silu rounds once, up to a few bf16 ulps
    away. In f32 the two agree within an ulp, and F.silu stays."""
    if x.dtype == torch.float32:
        return F.silu(x)
    return x * torch.reciprocal(1.0 + torch.exp(-x))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.gelu (tanh form) as the reference's jitted code computes it.
    Below f32, XLA expands x * 0.5 * (1 + tanh(c (x + a x^3))) with a and
    c rounded to x's dtype, x^3 as (x * x) * x, and rounds each step to
    that dtype; F.gelu rounds once (and where the rounded tanh is -1, for
    x below about -3, XLA's product is -0.0, F.gelu's is not). In f32
    F.gelu stays."""
    if x.dtype == torch.float32:
        return F.gelu(x, approximate="tanh")
    a = torch.tensor(0.044715, dtype=x.dtype, device=x.device)
    c = torch.tensor(math.sqrt(2.0 / math.pi), dtype=x.dtype,
                     device=x.device)
    t = torch.tanh((x + (x * x) * x * a) * c)
    return x * ((t + 1.0) * 0.5)


def mlp(p: dict, x: torch.Tensor, cfg, dist: DistConfig,
        fd=None) -> torch.Tensor:
    fd = fd or {}
    xi = region_in(x, dist)
    if cfg.mlp == "swiglu":
        h = silu(fdot(xi, p["w_gate"], fd.get("w_gate"), dist)) * \
            fdot(xi, p["w_in"], fd.get("w_in"), dist)
    else:
        h = gelu(fdot(xi, p["w_in"], fd.get("w_in"), dist))
    return region_out(fdot(h, p["w_out"], fd.get("w_out"), dist), dist)


# ---- memory-bounded attention: the pure-torch oracle -------------------------

def attention_mask(qpos: torch.Tensor, kpos: torch.Tensor, Sk: int,
                   causal: bool, window) -> torch.Tensor:
    """(qc, kc) bool: key valid (< Sk), causal, and within a window > 0
    (a window <= 0 disables it; it may be a number or a tensor)."""
    m = kpos[None, :] < Sk
    if causal:
        m = m & (kpos[None, :] <= qpos[:, None])
    diff = qpos[:, None] - kpos[None, :]
    if isinstance(window, torch.Tensor):
        return m & ((diff < window) | (window <= 0))
    return m & (diff < window) if window > 0 else m


def chunked_attention(q, k, v, *, causal: bool, window=0, q_offset: int = 0,
                      q_chunk: int = 1024, kv_chunk: int = 1024):
    """q (B,Sq,H,dh); k,v (B,Sk,H,dh|dv), heads already matched. A running
    softmax over kv chunks (masked scores -1e30), per q chunk; the oracle
    that flash_attention is tested against."""
    B, Sq, H, dh = q.shape
    dv = v.shape[-1]
    Sk = k.shape[1]
    qc, kc = min(q_chunk, Sq), min(kv_chunk, Sk)
    scale = 1.0 / torch.sqrt(torch.tensor(float(dh)))
    outs = []
    for qs in range(0, Sq + (-Sq) % qc, qc):
        qi = q[:, qs:qs + qc].to(torch.float32).transpose(1, 2)
        qi = F.pad(qi, (0, 0, 0, qc - qi.shape[2]))          # (B,H,qc,dh)
        qpos = q_offset + qs + torch.arange(qc, device=q.device)
        m = torch.full((B, H, qc), NEG_INF, device=q.device)
        l = torch.zeros((B, H, qc), device=q.device)
        acc = torch.zeros((B, H, qc, dv), device=q.device)
        for ks in range(0, Sk + (-Sk) % kc, kc):
            ki = F.pad(k[:, ks:ks + kc].to(torch.float32).transpose(1, 2),
                       (0, 0, 0, kc - min(kc, Sk - ks)))
            vi = F.pad(v[:, ks:ks + kc].to(torch.float32).transpose(1, 2),
                       (0, 0, 0, kc - min(kc, Sk - ks)))
            kpos = ks + torch.arange(kc, device=q.device)
            s = torch.einsum("bhqd,bhkd->bhqk", qi, ki) * scale
            s = torch.where(attention_mask(qpos, kpos, Sk, causal, window),
                            s, NEG_INF)
            m_new = torch.maximum(m, s.max(dim=-1).values)
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bhqk,bhkd->bhqd",
                                                       p, vi)
            m = m_new
        outs.append(acc / torch.clamp_min(l[..., None], 1e-30))
    out = torch.cat(outs, dim=2).transpose(1, 2)[:, :Sq]
    return out.to(q.dtype)


def expand_kv(k: torch.Tensor, n_q_heads_local: int, tp_rank: int,
              n_heads: int, n_kv: int) -> torch.Tensor:
    """Full kv heads (B,S,Hkv,dh) -> the local q heads' kv (B,S,Hl,dh) by
    GQA grouping, tp_rank the rank's TP index; padded q heads (global id
    >= n_heads) clip to the last kv head, and head_mask zeroes them."""
    group = max(1, n_heads // max(1, n_kv))
    q_global = tp_rank * n_q_heads_local + torch.arange(n_q_heads_local,
                                                        device=k.device)
    kv_idx = torch.clamp(q_global // group, 0, n_kv - 1)
    return k.index_select(2, kv_idx)


def head_mask(o: torch.Tensor, cfg, dist: DistConfig,
              axis: int) -> torch.Tensor:
    """Zero the outputs of TP-padding heads (n_heads rounded up to a
    multiple of the TP size; global id >= n_heads)."""
    Hl = o.shape[axis]
    gid = axis_index(dist.tp) * Hl + torch.arange(Hl, device=o.device)
    m = (gid < cfg.n_heads).to(o.dtype)
    shape = [1] * o.dim()
    shape[axis] = Hl
    return o * m.reshape(shape)


def sinusoid_positions(pos: torch.Tensor, d: int) -> torch.Tensor:
    """Sinusoidal absolute position embeddings, (...,) -> (..., d) f32."""
    half = d // 2
    freqs = torch.exp(-torch.arange(half, dtype=torch.float32,
                                    device=pos.device)
                      * (torch.log(torch.tensor(10000.0)) / max(1, half - 1)))
    ang = pos[..., None].to(torch.float32) * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---- the decode cache: int8 quantization, split-KV attention, writes ---------

# f32(1 / 127), the multiplier XLA makes of quantize_kv's divide by 127
_INV_127 = float(torch.tensor(1.0 / 127.0, dtype=torch.float32))


def quantize_kv(x: torch.Tensor):
    """Per-vector int8 quantization over the last dim (one token's k or v
    (B,Hkv,dh), or a prefill's (B,Hkv,S,dh)) -> (q int8, scale f32). As the
    reference's jitted code: max |x| / 127 + 1e-12 is one fma of max |x|,
    f32(1 / 127) and 1e-12, then round half to even."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=-1)
    scale = fma_f32(amax, _INV_127, torch.full_like(amax, 1e-12))
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def inv_sqrt_f32(n: int) -> float:
    """The f32 value of 1 / sqrt(f32(n)), each step rounded to f32."""
    return float(1.0 / torch.sqrt(torch.tensor(float(n))))


def splitkv_decode(q_local: torch.Tensor, k_cache: torch.Tensor,
                   v_cache: torch.Tensor, slot_pos: torch.Tensor, pos: int, *,
                   dist: DistConfig, n_heads: int, n_kv: int, window: int = 0,
                   k_scale: torch.Tensor = None,
                   v_scale: torch.Tensor = None) -> torch.Tensor:
    """One-token attention against a cache whose sequence dim is sharded
    over dist.tp.

    q_local (B,Hl,dh) this rank's q heads; k_cache / v_cache (B,Hkv,Ss,dh)
    this rank's slots, all kv heads (int8 with k_scale / v_scale
    (B,Hkv,Ss)); slot_pos (Ss,) int32, -1 empty; pos the current position
    (int). -> this rank's q heads' output (B,Hl,dh).

    Every q head is gathered (one token: a few KB), each rank takes the
    partial softmax over its slots, the partials merge by pmax / psum, and
    the rank keeps its own heads. A q head's group of the kv heads is a
    reshape, not the reference's gather of every q head's kv copy (the same
    products, without an (B,H,Ss,dh) f32 copy of the cache), so the real q
    heads must be a multiple of the kv heads, as in every config. TP
    padding heads (global id >= n_heads) get zeros, which head_mask keeps;
    the reference's gather reads past the kv heads there and its jnp.take
    fills NaN (ROADMAP Queue 3 item 18)."""
    B, Hl, dh = q_local.shape
    q_all = all_gather(q_local, dist.tp, gather_axis=1)     # (B,H,dh)
    H = q_all.shape[1]
    Hr = min(H, n_heads)                                    # real heads
    Hkv = k_cache.shape[1]
    group = max(1, n_heads // max(1, n_kv))
    if Hr != Hkv * group:
        raise ValueError(f"{Hr} q heads are not {group} for each of {Hkv} "
                         f"kv heads")
    k = k_cache.to(torch.float32)
    v = v_cache.to(torch.float32)
    if k_scale is not None:          # int8 cache: per-vector scales
        k = k * k_scale[..., None]
        v = v * v_scale[..., None]
    q = q_all[:, :Hr].to(torch.float32).reshape(B, Hkv, group, dh)
    s = torch.matmul(q, k.transpose(-1, -2)) * inv_sqrt_f32(dh)
    valid = (slot_pos >= 0) & (slot_pos <= pos)
    if window > 0:
        valid = valid & (slot_pos > pos - window)
    s = torch.where(valid, s, NEG_INF)
    m_l = torch.clamp_min(s.amax(dim=-1), 2 * NEG_INF)
    p = torch.exp(s - m_l[..., None])
    den_l = p.sum(dim=-1)
    num_l = torch.matmul(p, v)
    if q_all is q_local:                                # one shard
        o = num_l / torch.clamp_min(den_l[..., None], 1e-30)
    else:
        m = pmax(m_l, dist.tp)
        corr = torch.exp(m_l - m)
        num = psum(num_l * corr[..., None], dist.tp)
        den = psum(den_l * corr, dist.tp)
        o = num / torch.clamp_min(den[..., None], 1e-30)
    o = o.reshape(B, Hr, dh)
    if H > Hr:
        o = F.pad(o, (0, 0, 0, H - Hr))
    r = axis_index(dist.tp)
    return o[:, r * Hl:(r + 1) * Hl].to(q_local.dtype)


def cache_write(cache: torch.Tensor, slot_pos: torch.Tensor,
                new: torch.Tensor, pos: int, dist: DistConfig,
                ring_size: int = 0):
    """Write one token's entry `new` (the cache without its slot dim 2)
    into the sequence-sharded cache IN PLACE, and slot_pos[slot] = pos;
    -> (cache, slot_pos), the same tensors. ring_size=0: contiguous, rank
    r owns global slots [r Ss, (r + 1) Ss); ring_size > 0 (pure
    sliding-window archs): global slot pos % ring_size on rank slot // Ss.
    Only the owner writes; as in the reference, a slot past the cache's
    end is written by no rank."""
    Ss = cache.shape[2]
    g = pos % ring_size if ring_size > 0 else pos
    owner, local = divmod(g, Ss)
    if owner == axis_index(dist.tp):
        cache.select(2, local).copy_(new)
        slot_pos[local] = pos
    return cache, slot_pos
