"""Flash attention in plain torch with a recompute backward (the JAX
package's models/flash.py, a custom_vjp there, a torch.autograd.Function
here).

The forward keeps a running softmax over kv chunks of each q chunk and
saves only q, k, v, the output and the per-row log-sum-exp; the backward
recomputes each score block (FlashAttention-2), so no S x S block of
probabilities outlives its step. Masked scores are -1e30, not -inf: a
fully masked row gets uniform weights, never NaN. Masking: causal, a
sliding window (a number or tensor; <= 0 disables it) and the global
position of q[0] (`q_offset`); S need not be a multiple of the chunk
(rows and keys are zero-padded to it, padded keys masked). Queries and
keys are blocked by min(chunk, Sq) and min(chunk, Sk): the reference takes
one block size, min(chunk, Sq, Sk), which for one decode query against a
1,500-frame encoder memory would be 1,500 blocks of one key, cheap in a
lax.scan and not in a Python loop (the online softmax's rounding differs,
its function does not). All
arithmetic in f32; the output, dq, dk and dv in the inputs' dtypes.
layers.chunked_attention is the oracle the tests hold it against.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import NEG_INF, attention_mask


def _blocks(x: torch.Tensor, c: int) -> torch.Tensor:
    """(B, S, H, D) -> (n, B, H, c, D) f32, S zero-padded to n * c."""
    B, S, H, D = x.shape
    x = F.pad(x.to(torch.float32), (0, 0, 0, 0, 0, (-S) % c))
    return x.reshape(B, -1, c, H, D).permute(1, 0, 3, 2, 4)


def _unblocks(xb: torch.Tensor, S: int) -> torch.Tensor:
    n, B, H, c, D = xb.shape
    return xb.permute(1, 0, 3, 2, 4).reshape(B, n * c, H, D)[:, :S]


def _positions(n: int, c: int, offset: int, device) -> torch.Tensor:
    return offset + torch.arange(n * c, device=device).reshape(n, c)


class FlashAttention(torch.autograd.Function):
    """apply(q, k, v, window, causal, q_offset, chunk)."""

    @staticmethod
    def forward(ctx, q, k, v, window, causal, q_offset, chunk):
        B, Sq, H, dh = q.shape
        Sk = k.shape[1]
        cq, ck = min(chunk, Sq), min(chunk, Sk)
        scale = 1.0 / torch.sqrt(torch.tensor(float(dh)))
        qb, kb, vb = _blocks(q, cq), _blocks(k, ck), _blocks(v, ck)
        qpos = _positions(qb.shape[0], cq, q_offset, q.device)
        kpos = _positions(kb.shape[0], ck, 0, q.device)
        obs, lses = [], []
        for qi, qp in zip(qb, qpos):
            m = torch.full(qi.shape[:-1], NEG_INF, device=q.device)
            l = torch.zeros_like(m)
            acc = torch.zeros(qi.shape[:-1] + (v.shape[-1],),
                              device=q.device)
            for ki, vi, kp in zip(kb, vb, kpos):
                s = torch.einsum("bhqd,bhkd->bhqk", qi, ki) * scale
                s = torch.where(attention_mask(qp, kp, Sk, causal, window),
                                s, NEG_INF)
                m_new = torch.maximum(m, s.max(dim=-1).values)
                p = torch.exp(s - m_new[..., None])
                corr = torch.exp(m - m_new)
                l = l * corr + p.sum(dim=-1)
                acc = acc * corr[..., None] + torch.einsum(
                    "bhqk,bhkd->bhqd", p, vi)
                m = m_new
            l_safe = torch.clamp_min(l, 1e-30)
            obs.append(acc / l_safe[..., None])
            lses.append(m + torch.log(l_safe))
        ob, lse = torch.stack(obs), torch.stack(lses)
        out = _unblocks(ob, Sq).to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.window, ctx.causal, ctx.q_offset = window, causal, q_offset
        ctx.cq, ctx.ck = cq, ck
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        window, causal, cq, ck = ctx.window, ctx.causal, ctx.cq, ctx.ck
        dh = q.shape[-1]
        Sq, Sk = q.shape[1], k.shape[1]
        scale = 1.0 / torch.sqrt(torch.tensor(float(dh)))
        qb, kb, vb = _blocks(q, cq), _blocks(k, ck), _blocks(v, ck)
        gb, ob = _blocks(g, cq), _blocks(out, cq)
        qpos = _positions(qb.shape[0], cq, ctx.q_offset, q.device)
        kpos = _positions(kb.shape[0], ck, 0, q.device)
        delta = (gb * ob).sum(dim=-1)                    # (nq,B,H,c)
        dk = torch.zeros_like(kb)
        dv = torch.zeros_like(vb)
        dqs = []
        for qi, gi, li, di, qp in zip(qb, gb, lse, delta, qpos):
            dq = torch.zeros_like(qi)
            for j, (ki, vi, kp) in enumerate(zip(kb, vb, kpos)):
                s = torch.einsum("bhqd,bhkd->bhqk", qi, ki) * scale
                s = torch.where(attention_mask(qp, kp, Sk, causal, window),
                                s, NEG_INF)
                p = torch.exp(s - li[..., None])
                dv[j] += torch.einsum("bhqk,bhqd->bhkd", p, gi)
                dp = torch.einsum("bhqd,bhkd->bhqk", gi, vi)
                ds = p * (dp - di[..., None]) * scale
                dq = dq + torch.einsum("bhqk,bhkd->bhqd", ds, ki)
                dk[j] += torch.einsum("bhqk,bhqd->bhkd", ds, qi)
            dqs.append(dq)
        return (_unblocks(torch.stack(dqs), Sq).to(q.dtype),
                _unblocks(dk, Sk).to(k.dtype), _unblocks(dv, Sk).to(v.dtype),
                None, None, None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    window=0, causal: bool = True, q_offset: int = 0,
                    chunk: int = 1024) -> torch.Tensor:
    """q (B,Sq,H,dh), k/v (B,Sk,H,dk/dv), heads already GQA-expanded;
    window a number or tensor (<= 0 disables). Returns (B,Sq,H,dv)."""
    return FlashAttention.apply(q, k, v, window, causal, q_offset, chunk)
