"""Distribution primitives of the model code (the JAX package's
models/dist.py): Megatron-style tensor parallelism (column / row parallel
matmuls with the f / g conjugate boundary ops), sequence parallelism,
FSDP parameter gathering with the paper's Q_W in the backward pass, and
the vocab-parallel embedding and cross-entropy.

The reference runs its model code inside shard_map, where a mesh axis
name stands for the devices along it. Here every rank is a process and an
axis name stands for a torch.distributed process group: `bind_axes`
(called by `Mesh.bind`) maps each axis to its group, its size and this
rank's index along it. An axis that is not bound, or bound with size 1,
degrades to single-device semantics, as the reference's axis=None does, so
the same model code runs on one device and across ranks.

Every sum the reference takes with psum / psum_scatter is a rank-order sum
((x_0 + x_1) + x_2) + ... built on core.collectives (all_gather,
reduce_scatter, rank_sum) over the axis' group, so a rank's result does
not depend on a backend's reduction order (XLA's CPU psum sums in device
order; gloo has no reduce_scatter). The boundary ops are
torch.autograd.Functions with the reference's custom forward and backward
rules; the plain all_gather and psum_scatter carry jax's transposes
(reduce-scatter and all-gather) as their backward.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.utils.checkpoint as checkpoint

from repro_torch.core import collectives as C

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class DistConfig:
    """Logical-to-mesh axis mapping (the reference's fields).

    tp    : tensor/expert-parallel axis name ("model") or None
    fsdp  : parameter-sharding axis ("data") or None; when set it must be
            dp[-1]
    dp    : gradient-aggregation (data-parallel) axes, e.g. ("data",)
    sp    : sequence parallelism (Korthikanti et al.): the residual stream
            between blocks is sharded over tp on the sequence dim; block
            entry all-gathers it, block exit reduce-scatters. Train and
            prefill only.
    """
    tp: Optional[str] = None
    fsdp: Optional[str] = None
    dp: Tuple[str, ...] = ()
    sp: bool = False

    def __post_init__(self):
        if self.fsdp is not None and (not self.dp or self.dp[-1] != self.fsdp):
            raise ValueError("fsdp axis must be the last dp axis")

    @property
    def extra_dp(self) -> Tuple[str, ...]:
        """DP axes other than the fsdp axis."""
        if self.fsdp is None:
            return tuple(self.dp)
        return tuple(self.dp[:-1])


# ---- axes: name -> (process group, size, this rank's index) ------------------

@dataclasses.dataclass(frozen=True)
class Axis:
    group: object
    size: int
    index: int


_AXES: Dict[str, Axis] = {}


def bind_axes(axes: Dict[object, Axis]) -> None:
    """Bind mesh axis names (and tuples of names: a flattened group such
    as the pod mesh's ("pod", "data")) to this rank's process groups
    (replaces every earlier binding)."""
    _AXES.clear()
    _AXES.update(axes)


def _axis(axis) -> Optional[Axis]:
    """The bound Axis of a name or a tuple of names, or None when it spans
    one rank. A tuple whose axes span more than one rank each resolves to
    its flattened group, bound under the tuple of those names (the
    reference's psum over ("pod", "data"), in pod-major rank order)."""
    if axis is None:
        return None
    names = tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)
    real = tuple(a for a in names if a in _AXES and _AXES[a].size > 1)
    if len(real) > 1:
        if real not in _AXES:
            raise ValueError(f"a reduction over mesh axes {real} needs their "
                             f"flattened group; the bound mesh has none")
        return _AXES[real]
    return _AXES[real[0]] if real else None


def axis_size(axis) -> int:
    a = _axis(axis)
    return 1 if a is None else a.size


def axis_index(axis) -> int:
    """This rank's index along `axis` (0 when it spans one rank)."""
    a = _axis(axis)
    return 0 if a is None else a.index


# ---- the collectives, forward only -------------------------------------------

def _psum(x: torch.Tensor, a: Axis) -> torch.Tensor:
    return C.all_reduce(x, a.group)


def _gather(x: torch.Tensor, a: Axis, dim: int) -> torch.Tensor:
    """Tiled all_gather: the ranks' x concatenated along dim in rank
    order."""
    return torch.cat(list(C.all_gather(x, a.group).unbind(0)), dim=dim)


def _scatter_sum(x: torch.Tensor, a: Axis, dim: int) -> torch.Tensor:
    """Tiled psum_scatter: this rank's slice along dim of the rank-order
    sum."""
    d = dim % x.dim()
    return C.reduce_scatter(x.movedim(d, -1), a.group).movedim(-1, d)


def _slice(x: torch.Tensor, a: Axis, dim: int) -> torch.Tensor:
    local = x.shape[dim] // a.size
    return x.narrow(dim, a.index * local, local)


def pmax(x, axis):
    a = _axis(axis)
    if a is None:
        return x
    return C.all_reduce(x, a.group, lambda g: g.amax(dim=0))


# ---- autograd Functions ------------------------------------------------------

class _Psum(torch.autograd.Function):
    """psum, backward psum (jax's transpose)."""
    @staticmethod
    def forward(ctx, x, a):
        ctx.a = a
        return _psum(x, a)

    @staticmethod
    def backward(ctx, g):
        return _psum(g, ctx.a), None


class _AllGather(torch.autograd.Function):
    """Tiled all_gather, backward the reduce-scatter (jax's transpose)."""
    @staticmethod
    def forward(ctx, x, a, dim):
        ctx.a, ctx.dim = a, dim
        return _gather(x, a, dim)

    @staticmethod
    def backward(ctx, g):
        return _scatter_sum(g, ctx.a, ctx.dim), None, None


class _PsumScatter(torch.autograd.Function):
    """Tiled psum_scatter, backward the all_gather (jax's transpose)."""
    @staticmethod
    def forward(ctx, x, a, dim):
        ctx.a, ctx.dim = a, dim
        return _scatter_sum(x, a, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.a, ctx.dim), None, None


class _IdentityPsumBwd(torch.autograd.Function):
    """Identity forward, psum backward: tp_region_in and tp_shared."""
    @staticmethod
    def forward(ctx, x, a):
        ctx.a = a
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _psum(g, ctx.a), None


class _PsumIdentityBwd(torch.autograd.Function):
    """psum forward, identity backward: tp_region_out."""
    @staticmethod
    def forward(ctx, x, a):
        return _psum(x, a)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherReplicated(torch.autograd.Function):
    """all_gather whose output is consumed replicated-identically on every
    rank: the adjoint takes this rank's slice."""
    @staticmethod
    def forward(ctx, x, a, dim):
        ctx.a, ctx.dim = a, dim
        return _gather(x, a, dim)

    @staticmethod
    def backward(ctx, g):
        return _slice(g, ctx.a, ctx.dim).contiguous(), None, None


class _SliceReplicated(torch.autograd.Function):
    """This rank's slice, backward the all_gather."""
    @staticmethod
    def forward(ctx, x, a, dim):
        ctx.a, ctx.dim = a, dim
        return _slice(x, a, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.a, ctx.dim), None, None


# ---- axis-optional helpers ----------------------------------------------------

def psum(x, axis):
    a = _axis(axis)
    return x if a is None else _Psum.apply(x, a)


def pmean(x, axis):
    a = _axis(axis)
    return x if a is None else _Psum.apply(x, a) / a.size


def all_gather(x, axis, gather_axis=0):
    """The ranks' x concatenated along gather_axis (jax's tiled
    all_gather)."""
    a = _axis(axis)
    return x if a is None else _AllGather.apply(x, a, gather_axis)


def psum_scatter(x, axis, scatter_dimension=0):
    """This rank's slice along scatter_dimension of the rank-order sum
    (jax's tiled psum_scatter)."""
    a = _axis(axis)
    return x if a is None else _PsumScatter.apply(x, a, scatter_dimension)


def pmax_sg(x, axis):
    """pmax with zero gradient (the reference's custom_vjp; jax has no pmax
    derivative): the max of the detached values, a softmax stabilizer."""
    return pmax(x.detach(), axis)


# ---- Megatron f / g boundary ops ----------------------------------------------

def tp_region_in(x, axis):
    """Identity forward / psum backward: enter a column-parallel region."""
    a = _axis(axis)
    return x if a is None else _IdentityPsumBwd.apply(x, a)


def tp_region_out(x, axis):
    """psum forward / identity backward: exit a row-parallel region (a
    plain psum's transpose would double-count a value every rank consumes
    identically)."""
    a = _axis(axis)
    return x if a is None else _PsumIdentityBwd.apply(x, a)


def gather_replicated(x, axis, dim):
    """all_gather consumed replicated on every rank; adjoint: my slice."""
    a = _axis(axis)
    return x if a is None else _GatherReplicated.apply(x, a, dim)


def make_slice_replicated(n_shards: int):
    """The reference's factory of a slice with an all_gather adjoint for a
    static shard count (the axis' bound size)."""
    def slice_rep(x, axis, dim):
        a = _axis(axis)
        if a is None:
            return x
        if a.size != n_shards:
            raise ValueError(f"axis {axis!r} has {a.size} ranks, the model "
                             f"was built for {n_shards}")
        return _SliceReplicated.apply(x, a, dim)
    return slice_rep


def region_in(x, dist: DistConfig, axis: int = 1):
    """Enter a column-parallel region: identity forward / psum backward
    (sp=False), or all-gather the sequence-sharded residual (sp=True)."""
    if dist.tp is None:
        return x
    if dist.sp:
        return all_gather(x, dist.tp, gather_axis=axis)
    return tp_region_in(x, dist.tp)


def region_out(x, dist: DistConfig, axis: int = 1):
    """Exit a row-parallel region: psum (sp=False) or reduce-scatter back to
    the sequence-sharded residual (sp=True)."""
    if dist.tp is None:
        return x
    if dist.sp:
        return psum_scatter(x, dist.tp, scatter_dimension=axis)
    return tp_region_out(x, dist.tp)


def tp_shared(w, axis):
    """Identity forward / psum backward on a parameter replicated over TP
    but used differently by each rank (GQA kv projections, routers)."""
    return tp_region_in(w, axis)


# ---- FSDP parameter gather with the compressed-gradient backward --------------

def key_to_bits(key: torch.Tensor) -> torch.Tensor:
    """A key's two uint32 words as f32 bit patterns (the reference's
    bit-cast, which carries a key through custom_vjp)."""
    return key.to(torch.int32).view(torch.float32)


def bits_to_key(bits: torch.Tensor) -> torch.Tensor:
    """key_to_bits' inverse -> the (2,) int64 key data."""
    return bits.reshape(2).view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def _hook_compress(g: torch.Tensor, key_bits: torch.Tensor, cfg,
                   dist: DistConfig) -> torch.Tensor:
    """Worker-side Q_W on the local (pre-reduction) gradient of one leaf,
    the layer-wise unit of the FSDP path: the key folded in by this rank's
    index along each dp axis, then qw.sim on the flat f32 leaf."""
    from repro_torch.random import fold_in
    if cfg is None or cfg.strategy in ("dense",):
        return g
    # a dry run's key bits are meta tensors (no values to read): any key
    # gives the same shapes
    key = (bits_to_key(key_bits.cpu()) if not key_bits.is_meta
           else torch.zeros((2,), dtype=torch.int64))
    for ax in dist.dp:
        key = fold_in(key, axis_index(ax))
    flat = g.reshape(1, -1).to(torch.float32)
    out = cfg.qw.sim(flat, key[None].to(g.device))
    return out.reshape(g.shape).to(g.dtype)


class _FsdpParam(torch.autograd.Function):
    """forward : all_gather over dist.fsdp along `dim`
    backward: Q_W(local grad) -> reduce-scatter over fsdp -> sum over the
              other dp axes -> mean over the dp group"""
    @staticmethod
    def forward(ctx, w, key_bits, dim, dist, comp):
        ctx.dim, ctx.dist, ctx.comp = dim, dist, comp
        ctx.save_for_backward(key_bits)
        a = _axis(dist.fsdp)
        return w if a is None else _gather(w, a, dim)

    @staticmethod
    def backward(ctx, g):
        (key_bits,) = ctx.saved_tensors
        dist = ctx.dist
        g = _hook_compress(g, key_bits, ctx.comp, dist)
        a = _axis(dist.fsdp)
        if a is not None:
            g = _scatter_sum(g, a, ctx.dim)
        e = _axis(dist.extra_dp)
        if e is not None:
            g = _psum(g, e)
        n = axis_size(dist.dp)
        if dist.dp:
            g = g / torch.tensor(float(n), dtype=g.dtype, device=g.device)
        return g, None, None, None, None


def fsdp_param(w: torch.Tensor, key_bits: torch.Tensor, dim: int,
               dist: DistConfig, comp) -> torch.Tensor:
    """Gather an FSDP-sharded parameter leaf for compute; its gradient
    arrives compressed per Algorithm 1 and already scattered to the shard
    (ZeRO-style). See _FsdpParam."""
    return _FsdpParam.apply(w, key_bits, dim, dist, comp)


def fdot(x: torch.Tensor, w: torch.Tensor, fsdp_dim,
         dist: DistConfig) -> torch.Tensor:
    """Matmul against a weight that stays FSDP-sharded (2D tensor parallel,
    the decode path of the FSDP archs):
      fsdp_dim == w.ndim-2 (input dim sharded): this rank's slice of x's
          features @ w, summed over fsdp;
      fsdp_dim == w.ndim-1 (output dim sharded): x @ w, the output
          features all-gathered."""
    a = _axis(dist.fsdp)
    if fsdp_dim is None or dist.fsdp is None or a is None:
        return x @ w
    if fsdp_dim == w.dim() - 2:
        d_local = w.shape[-2]
        xs = x.narrow(-1, a.index * d_local, d_local)
        return _psum(xs @ w, a)
    if fsdp_dim == w.dim() - 1:
        return _gather(x @ w, a, x.dim() - 1)
    raise ValueError(f"unsupported fsdp_dim {fsdp_dim} for w rank {w.dim()}")


# ---- vocab-parallel embedding & cross-entropy ---------------------------------

def vp_embed(table_local: torch.Tensor, ids: torch.Tensor, tp_axis,
             vocab_global: int) -> torch.Tensor:
    """Embedding lookup with the vocab dim sharded over tp_axis:
    table_local (V_local, d), ids (...) global ids -> (..., d). Ids outside
    this rank's rows give zero rows; the psum over the axis has an identity
    backward."""
    v_local = table_local.shape[0]
    local = ids - axis_index(tp_axis) * v_local
    ok = (local >= 0) & (local < v_local)
    emb = torch.where(ok[..., None], table_local[local.clamp(0, v_local - 1)],
                      0.0)
    return tp_region_out(emb, tp_axis)


def _nll(t: torch.Tensor, targets: torch.Tensor, vocab: Optional[int],
         tp_axis) -> torch.Tensor:
    """Per-row negative log-likelihood of f32 logits t (T, V_local) of this
    rank's vocab shard: columns at or past `vocab` masked to -1e30, the
    global max a stabilizer without gradient, the sum of exponentials and
    the target logit summed over the shards."""
    v_local = t.shape[-1]
    offset = axis_index(tp_axis) * v_local
    if vocab is not None:
        col = offset + torch.arange(v_local, device=t.device)
        t = torch.where(col[None, :] < vocab, t, NEG_INF)
    m = pmax_sg(t.max(dim=-1).values, tp_axis)
    se = tp_region_out(torch.exp(t - m[:, None]).sum(dim=-1), tp_axis)
    lt = targets - offset
    ok = (lt >= 0) & (lt < v_local)
    tl = t.gather(1, lt.clamp(0, v_local - 1).long()[:, None])[:, 0]
    tgt = tp_region_out(torch.where(ok, tl, 0.0), tp_axis)
    return torch.log(se) + m - tgt


def vp_xent(logits_local: torch.Tensor, targets: torch.Tensor, tp_axis,
            valid: Optional[torch.Tensor] = None,
            vocab: Optional[int] = None) -> torch.Tensor:
    """Mean cross-entropy of vocab-sharded logits (T, V_local) against
    targets (T,); `valid` weights the mean, `vocab` masks the padding
    columns."""
    nll = _nll(logits_local.to(torch.float32), targets, vocab, tp_axis)
    if valid is None:
        return nll.mean()
    w = valid.to(torch.float32)
    return (nll * w).sum() / torch.clamp_min(w.sum(), 1.0)


def vp_xent_chunked(x: torch.Tensor, w: torch.Tensor, targets: torch.Tensor,
                    tp_axis, vocab: int, chunk: int = 8192) -> torch.Tensor:
    """Fused head matmul + vocab-parallel cross-entropy over token chunks,
    each chunk recomputed in the backward (torch.utils.checkpoint), so at
    most one chunk's (chunk, V_local) f32 logits live at a time.

    x (T, d); w (d, V_local); targets (T,), < 0 is padding. Returns the SUM
    of the per-token NLL over the local tokens; the caller normalizes. The
    logits round to x's dtype before the f32 cast, as the reference's
    (xc @ w).astype(f32)."""
    T = x.shape[0]
    c = min(chunk, T)

    def chunk_nll(xc, tc):
        nll = _nll((xc @ w).to(torch.float32), tc, vocab, tp_axis)
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
