"""Distribution primitives of the model code, their one-device part (the
JAX package's models/dist.py).

The reference's helpers take a mesh axis and degrade to single-device
semantics when it is None. The port has the None case only: a DistConfig
naming a tensor-parallel, FSDP or sequence-parallel axis raises (ROADMAP
Queue 1, item 4b), and the boundary ops below are identities, kept so the
model code reads as the reference's. Vocab-parallel embedding and
cross-entropy are the one-shard case: offset 0, the padded vocab columns
masked with -1e30 before the log-sum-exp.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.utils.checkpoint as checkpoint

from repro_torch.core.wire import not_ported

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class DistConfig:
    """Logical-to-mesh axis mapping (the reference's fields).

    tp    : tensor/expert-parallel axis name or None
    fsdp  : parameter-sharding axis or None; when set it must be dp[-1]
    dp    : gradient-aggregation (data-parallel) axes
    sp    : sequence parallelism over tp
    """
    tp: Optional[str] = None
    fsdp: Optional[str] = None
    dp: Tuple[str, ...] = ()
    sp: bool = False

    def __post_init__(self):
        if self.fsdp is not None and (not self.dp or self.dp[-1] != self.fsdp):
            raise ValueError("fsdp axis must be the last dp axis")
        for name in ("tp", "fsdp", "sp"):
            if getattr(self, name):
                raise not_ported(f"DistConfig({name}=...): the sharded LM "
                                 f"path", "item 4b (models/dist.py)")

    @property
    def extra_dp(self) -> Tuple[str, ...]:
        """DP axes other than the fsdp axis."""
        if self.fsdp is None:
            return tuple(self.dp)
        return tuple(self.dp[:-1])


# ---- the boundary ops, one device: identities --------------------------------

def region_in(x, dist: DistConfig, axis: int = 1):
    return x


def region_out(x, dist: DistConfig, axis: int = 1):
    return x


def tp_region_in(x, axis):
    return x


def tp_region_out(x, axis):
    return x


def tp_shared(w, axis):
    return w


def fdot(x: torch.Tensor, w: torch.Tensor, fsdp_dim,
         dist: DistConfig) -> torch.Tensor:
    """x @ w: the reference's matmul against an FSDP-sharded weight when
    there is no fsdp axis (DistConfig refuses one)."""
    return x @ w


def key_to_bits(key: torch.Tensor) -> torch.Tensor:
    """A key's two uint32 words as f32 bit patterns (the reference's
    bit-cast, which carries a key through custom_vjp)."""
    return key.to(torch.int32).view(torch.float32)


# ---- vocab-parallel embedding & cross-entropy, one shard ---------------------

def vp_embed(table: torch.Tensor, ids: torch.Tensor, tp_axis,
             vocab_global: int) -> torch.Tensor:
    """Embedding lookup: table (V, d), ids (...) -> (..., d). Ids out of
    range give zero rows, as the reference's masked take."""
    v = table.shape[0]
    ok = (ids >= 0) & (ids < v)
    return torch.where(ok[..., None], table[ids.clamp(0, v - 1)], 0.0)


def _nll(t: torch.Tensor, targets: torch.Tensor,
         vocab: Optional[int]) -> torch.Tensor:
    """Per-row negative log-likelihood of f32 logits t (T, V): the padded
    columns at or past `vocab` masked to -1e30, the max a stabilizer
    without gradient."""
    if vocab is not None:
        col = torch.arange(t.shape[-1], device=t.device)
        t = torch.where(col[None, :] < vocab, t, NEG_INF)
    m = t.max(dim=-1).values.detach()
    se = torch.exp(t - m[:, None]).sum(dim=-1)
    v = t.shape[-1]
    ok = (targets >= 0) & (targets < v)
    tl = t.gather(1, targets.clamp(0, v - 1).long()[:, None])[:, 0]
    tgt = torch.where(ok, tl, 0.0)
    return torch.log(se) + m - tgt


def vp_xent(logits: torch.Tensor, targets: torch.Tensor, tp_axis,
            valid: Optional[torch.Tensor] = None,
            vocab: Optional[int] = None) -> torch.Tensor:
    """Mean cross-entropy of logits (T, V) against targets (T,); `valid`
    weights the mean, `vocab` masks the padding columns."""
    nll = _nll(logits.to(torch.float32), targets, vocab)
    if valid is None:
        return nll.mean()
    w = valid.to(torch.float32)
    return (nll * w).sum() / torch.clamp_min(w.sum(), 1.0)


def vp_xent_chunked(x: torch.Tensor, w: torch.Tensor, targets: torch.Tensor,
                    tp_axis, vocab: int, chunk: int = 8192) -> torch.Tensor:
    """Fused head matmul + cross-entropy over token chunks, each chunk
    recomputed in the backward (torch.utils.checkpoint), so at most one
    chunk's (chunk, V) f32 logits live at a time.

    x (T, d); w (d, V); targets (T,), < 0 is padding. Returns the SUM of
    the per-token NLL; the caller normalizes. The logits round to x's
    dtype before the f32 cast, as the reference's (xc @ w).astype(f32)."""
    T = x.shape[0]
    c = min(chunk, T)

    def chunk_nll(xc, tc):
        nll = _nll((xc @ w).to(torch.float32), tc, vocab)
        return torch.where(tc >= 0, nll, 0.0).sum()

    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for s in range(0, T, c):
        xc, tc = x[s:s + c], targets[s:s + c]
        if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
            total = total + checkpoint.checkpoint(chunk_nll, xc, tc,
                                                  use_reentrant=False)
        else:
            total = total + chunk_nll(xc, tc)
    return total
