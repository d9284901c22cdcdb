"""UnitPlan: the static bucketed compression-execution plan (the JAX
package's core/plan.py).

Plan construction is pure Python on static shapes and is identical to the
reference: per-unit tables (offset, dim, leaf), buckets of same-size units
in first-occurrence order, contiguous runs, backward-readiness ranks and
the PRNG fold tables (single fold for loose leaves, double fold for
layer-stacked ones). Leaves are taken in JAX's sorted-key order
(convert.py), so unit ids and keys match the reference.

Execution maps a batched fn(x2d, keys2d) -> y2d over every bucket: the
rows of x2d are the bucket's units, keys2d their (n, 2) key data — the
reference's vmap over units written out as a batch dimension.

A leading WORKER axis is the same idea one level up: when `key` is a
(B, 2) batch of keys, every leaf of `grads` carries a leading axis of B
workers, worker w's units are keyed from key[w], and one dispatch per
bucket covers all B workers (rows ordered worker-major). This is how
core/aggregation.py runs Algorithm 1's per-worker pass, the counterpart
of the reference's jax.vmap over workers. A (2,) key runs one tree.
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
import functools
import math
from typing import Callable, List, Sequence, Tuple

import torch

from repro_torch.convert import tree_leaves, tree_paths, tree_unflatten
from repro_torch.core.granularity import Granularity
from repro_torch.random import fold_in


@dataclasses.dataclass(frozen=True)
class Bucket:
    """One size class: all units of dimension `dim`, as rows of a matrix.
    `runs` are maximal contiguous segments (start_offset, n_units,
    leaf_index); leaf_index >= 0 means the run covers exactly that leaf,
    -1 that it stages through the flat vector. `ready` is the bucket's
    backward-readiness rank (lower = its gradients exist earlier)."""
    dim: int
    unit_ids: Tuple[int, ...]
    offsets: Tuple[int, ...]
    runs: Tuple[Tuple[int, int, int], ...]
    ready: int = 0

    @property
    def n(self) -> int:
        return len(self.unit_ids)

    @property
    def contiguous(self) -> bool:
        """True when the bucket's units tile one contiguous run."""
        return len(self.runs) == 1

    @property
    def nbytes(self) -> int:
        """Dense f32 bytes of the bucket's units."""
        return 4 * self.n * self.dim


@dataclasses.dataclass(frozen=True)
class UnitPlan:
    """Static compression-execution plan for one (tree, granularity)."""
    granularity: Granularity
    paths: Tuple[Tuple[str, ...], ...]
    leaf_shapes: Tuple[Tuple[int, ...], ...]
    leaf_dtypes: Tuple[torch.dtype, ...]
    total: int
    exec_total: int
    unit_dims: Tuple[int, ...]
    exec_dims: Tuple[int, ...]
    unit_offsets: Tuple[int, ...]
    unit_leaf: Tuple[int, ...]
    buckets: Tuple[Bucket, ...]
    fold_base: Tuple[int, ...]
    fold_inner: Tuple[int, ...]
    fold_double: Tuple[bool, ...]

    # ---- introspection ----------------------------------------------------
    @property
    def num_units(self) -> int:
        return len(self.unit_dims)

    @property
    def num_exec_units(self) -> int:
        return len(self.exec_dims)

    @property
    def num_dispatches(self) -> int:
        return len(self.buckets)

    @property
    def num_leaves(self) -> int:
        return len(self.leaf_shapes)

    def readiness_order(self) -> Tuple[int, ...]:
        return tuple(sorted(range(len(self.buckets)),
                            key=lambda i: (self.buckets[i].ready, i)))

    def summary(self) -> str:
        bs = ", ".join(f"{b.n}x{b.dim}" for b in self.buckets)
        return (f"UnitPlan({self.granularity.kind}: {self.num_units} units, "
                f"{self.num_dispatches} dispatches [{bs}])")

    @property
    def needs_flat(self) -> bool:
        """True when some run spans leaves (entire-model / blockwise)."""
        return any(r[2] < 0 for b in self.buckets for r in b.runs)

    # ---- PRNG -------------------------------------------------------------
    def unit_keys(self, key: torch.Tensor) -> torch.Tensor:
        """Per-exec-unit key data (..., U, 2) from key (..., 2): the
        reference's fold tables (fold_in(key, base), then fold_in(., inner)
        for layer-stacked units)."""
        base = torch.tensor(self.fold_base, dtype=torch.int64,
                            device=key.device)
        inner = torch.tensor(self.fold_inner, dtype=torch.int64,
                             device=key.device)
        dbl = torch.tensor(self.fold_double, device=key.device)
        k1 = fold_in(key[..., None, :], base)
        k2 = fold_in(k1, inner)
        return torch.where(dbl[:, None], k2, k1)

    # ---- batched gather / scatter (leading worker axis B) -----------------
    def _inputs(self, tree, key: torch.Tensor):
        """-> (leaves with a leading worker axis, batched?)."""
        if key.dim() not in (1, 2) or key.shape[-1] != 2:
            raise ValueError(f"key must be (2,) or (B, 2), got "
                             f"{tuple(key.shape)}")
        batched = key.dim() == 2
        leaves = tree_leaves(tree)
        if not batched:
            leaves = [l[None] for l in leaves]
        elif any(l.shape[0] != key.shape[0] for l in leaves):
            raise ValueError("every leaf needs the leading worker axis of "
                             "the key batch")
        return leaves, batched

    def _keys(self, key: torch.Tensor, device) -> torch.Tensor:
        """(B, U, 2) unit keys on `device`."""
        return self.unit_keys(key.reshape(-1, 2)).to(device)

    def _flat(self, leaves) -> torch.Tensor:
        """(B, exec_total) f32: the leaves cast into their slices (no f32
        copy of a leaf beside the vector), the padding zero."""
        B = leaves[0].shape[0]
        flat = torch.empty((B, self.exec_total), dtype=torch.float32,
                           device=leaves[0].device)
        off = 0
        for l in leaves:
            n = l[0].numel()
            flat[:, off:off + n].copy_(l.reshape(B, -1))
            off += n
        flat[:, off:].zero_()
        return flat

    def _new_flat(self, leaves):
        return torch.zeros((leaves[0].shape[0], self.exec_total),
                           dtype=torch.float32, device=leaves[0].device)

    @staticmethod
    def _bucket_keys(keys: torch.Tensor, b: Bucket) -> torch.Tensor:
        """(B, U, 2) -> (B * b.n, 2), worker-major like the gathered rows."""
        return keys[:, list(b.unit_ids)].reshape(-1, 2)

    def _gather_runs(self, leaves, flat, b: Bucket) -> torch.Tensor:
        """-> (B * b.n, dim): worker-major rows of the bucket's units."""
        B = (flat if flat is not None else leaves[0]).shape[0]

        def run(start, k, li):
            if li >= 0 and leaves is not None:
                return leaves[li].reshape(B, k, b.dim)
            return flat[:, start:start + k * b.dim].reshape(B, k, b.dim)
        if len(b.runs) == 1:
            x = run(*b.runs[0]).to(torch.float32)
        else:           # each run cast into its rows: no f32 copy beside
            x = torch.empty((B, b.n, b.dim), dtype=torch.float32,
                            device=(flat if flat is not None
                                    else leaves[0]).device)
            row = 0
            for start, k, li in b.runs:
                x[:, row:row + k].copy_(run(start, k, li))
                row += k
        return x.reshape(B * b.n, b.dim)

    def _scatter_runs(self, out_leaves, out_flat, b: Bucket,
                      y: torch.Tensor) -> None:
        """Write bucket rows y (B * b.n, dim) into out_leaves / out_flat
        (with out_leaves None, every run into out_flat)."""
        y = y.reshape(-1, b.n, b.dim)
        B = y.shape[0]
        row = 0
        for start, k, li in b.runs:
            seg = y[:, row:row + k]
            if li >= 0 and out_leaves is not None:
                out_leaves[li] = seg.reshape((B,) + self.leaf_shapes[li]).to(
                    self.leaf_dtypes[li])
            else:
                out_flat[:, start:start + k * b.dim] = seg.reshape(B, -1)
            row += k

    def _assemble(self, out_leaves, out_flat, batched: bool):
        outs, off = [], 0
        for i, (shape, dtype) in enumerate(zip(self.leaf_shapes,
                                               self.leaf_dtypes)):
            size = math.prod(shape)
            leaf = out_leaves[i]
            if leaf is None:
                leaf = out_flat[:, off:off + size].reshape(
                    (out_flat.shape[0],) + shape).to(dtype)
            outs.append(leaf if batched else leaf[0])
            off += size
        return tree_unflatten(self.paths, outs)

    # ---- flat <-> tree, one bucket at a time (ops.plan_compress) ----------
    def flatten(self, tree) -> torch.Tensor:
        """Tree -> f32 flat vector of length exec_total (zero-padded)."""
        return self._flat([l[None] for l in tree_leaves(tree)])[0]

    def unflatten(self, flat: torch.Tensor):
        """f32 flat vector -> tree with the plan's shapes and dtypes."""
        return self._assemble([None] * len(self.leaf_shapes), flat[None],
                              batched=False)

    def gather_bucket(self, flat: torch.Tensor, b: Bucket) -> torch.Tensor:
        """(exec_total,) -> (b.n, b.dim) matrix of the bucket's units."""
        return self._gather_runs(None, flat[None], b)

    def scatter_bucket(self, out: torch.Tensor, b: Bucket,
                       y: torch.Tensor) -> torch.Tensor:
        """Write the bucket's rows y (b.n, b.dim) into the flat vector `out`
        IN PLACE (the reference returns an updated copy) and return it."""
        self._scatter_runs(None, out[None], b, y)
        return out

    # ---- execution --------------------------------------------------------
    def execute(self, fn: Callable, grads, key: torch.Tensor, *,
                recorder=None):
        """Map fn(x2d, keys2d) -> y2d over every bucket, one dispatch per
        bucket. Returns a tree shaped/dtyped like `grads`. `recorder`
        (duck-typed, obs.trace.TraceRecorder) marks each dispatch with a
        scope and an end-of-stage stamp; None or a disabled recorder runs
        the uninstrumented ops."""
        return self._execute(fn, grads, key, self._dispatch_groups(),
                             recorder)

    def execute_with_state(self, fn: Callable, grads, state,
                           key: torch.Tensor, *, recorder=None):
        """Like execute, but fn(x2d, m2d, keys2d) -> (y2d, m2d_new) threads
        a same-shaped per-unit state (error-feedback memory)."""
        return self._execute_with_state(fn, grads, state, key,
                                        self._dispatch_groups(), recorder)

    def _dispatch_groups(self):
        return [(bi,) for bi in range(self.num_dispatches)]

    def _span(self, kind: str, gi: int, group) -> Tuple[str, dict]:
        """(scope name, mark keywords) of group `gi` (its bucket ids
        `group`): a bare-plan dispatch or a schedule message."""
        kw = dict(bucket_ids=group,
                  dims=tuple(self.buckets[bi].dim for bi in group),
                  n_units=sum(self.buckets[bi].n for bi in group))
        if kind == "dispatch":
            return f"repro/dispatch/b{gi}", dict(
                stage="dispatch", cat="dispatch", label=f"dispatch b{gi}",
                **kw)
        return f"repro/msg{gi}", dict(stage="message", cat="message",
                                      message=gi, **kw)

    def _execute(self, fn, grads, key, groups, recorder=None,
                 kind="dispatch"):
        """execute over `groups` of bucket ids in order (core/schedule.py
        passes its messages; every bucket writes a disjoint region); an
        active recorder marks each group as a `kind` span."""
        rec = _active(recorder)
        leaves, batched = self._inputs(grads, key)
        flat = self._flat(leaves) if self.needs_flat else None
        keys = self._keys(key, leaves[0].device)
        out_leaves = [None] * len(leaves)
        out_flat = self._new_flat(leaves) if flat is not None else None
        if rec is not None:
            rec.begin(leaves[0], label="grads_ready")
        for gi, group in enumerate(groups):
            name, kw = (self._span(kind, gi, group) if rec is not None
                        else ("", None))
            ys = []
            with _scope(rec, name):
                for bi in group:
                    b = self.buckets[bi]
                    y = fn(self._gather_runs(leaves, flat, b),
                           self._bucket_keys(keys, b))
                    self._scatter_runs(out_leaves, out_flat, b, y)
                    if rec is not None:
                        ys.append(y)
            if rec is not None:
                rec.mark(ys, **kw)
        return self._assemble(out_leaves, out_flat, batched)

    def _execute_with_state(self, fn, grads, state, key, groups,
                            recorder=None, kind="dispatch"):
        rec = _active(recorder)
        leaves, batched = self._inputs(grads, key)
        sleaves, _ = self._inputs(state, key)
        need = self.needs_flat
        flat = self._flat(leaves) if need else None
        mflat = self._flat(sleaves) if need else None
        keys = self._keys(key, leaves[0].device)
        out_leaves = [None] * len(leaves)
        mout_leaves = [None] * len(leaves)
        out_flat = self._new_flat(leaves) if need else None
        mout_flat = self._new_flat(leaves) if need else None
        if rec is not None:
            rec.begin(leaves[0], label="grads_ready")
        for gi, group in enumerate(groups):
            name, kw = (self._span(kind, gi, group) if rec is not None
                        else ("", None))
            ys = []
            with _scope(rec, name):
                for bi in group:
                    b = self.buckets[bi]
                    y, mn = fn(self._gather_runs(leaves, flat, b),
                               self._gather_runs(sleaves, mflat, b),
                               self._bucket_keys(keys, b))
                    self._scatter_runs(out_leaves, out_flat, b, y)
                    self._scatter_runs(mout_leaves, mout_flat, b, mn)
                    if rec is not None:
                        ys += [y, mn]
            if rec is not None:
                rec.mark(ys, **kw)
        return (self._assemble(out_leaves, out_flat, batched),
                self._assemble(mout_leaves, mout_flat, batched))


def _active(recorder):
    """The duck-typed zero-overhead guard (obs.trace.active, which core
    does not import): the recorder when enabled, else None."""
    if recorder is not None and getattr(recorder, "enabled", False):
        return recorder
    return None


def _scope(rec, name: str):
    """The recorder's profiler scope, or nothing without a recorder."""
    return rec.scope(name) if rec is not None else contextlib.nullcontext()


# ==========================================================================
# plan construction (identical to the reference)
# ==========================================================================

def _first_touched_leaf(offset: int, unit_leaf_idx: int,
                        leaf_offsets: Sequence[int]) -> int:
    if unit_leaf_idx >= 0:
        return unit_leaf_idx
    if not leaf_offsets:
        return 0
    return max(0, bisect.bisect_right(leaf_offsets, offset) - 1)


def _make_buckets(dims, offsets, unit_leaf, leaf_offsets,
                  leaf_sizes) -> Tuple[Bucket, ...]:
    """Group units by dim (first-occurrence order) and split each group
    into contiguous runs that never merge across leaves."""
    n_leaves = len(leaf_sizes)
    by_dim: dict = {}
    for uid, d in enumerate(dims):
        by_dim.setdefault(d, []).append(uid)
    buckets = []
    for d, ids in by_dim.items():
        offs = [offsets[u] for u in ids]
        runs: List[List[int]] = []   # [start, count, leaf]
        for u, o in zip(ids, offs):
            li = unit_leaf[u]
            contiguous = bool(runs) and o == runs[-1][0] + runs[-1][1] * d
            if contiguous and ((li >= 0 and li == runs[-1][2])
                               or (li < 0 and runs[-1][2] < 0)):
                runs[-1][1] += 1
            else:
                runs.append([o, 1, li])
        frozen = []
        for start, k, li in runs:
            whole = (li >= 0 and start == leaf_offsets[li]
                     and k * d == leaf_sizes[li])
            frozen.append((start, k, li if whole else -1))
        first = min((_first_touched_leaf(o, unit_leaf[u], leaf_offsets)
                     for u, o in zip(ids, offs)), default=0)
        buckets.append(Bucket(dim=d, unit_ids=tuple(ids),
                              offsets=tuple(offs), runs=tuple(frozen),
                              ready=max(0, n_leaves - 1 - first)))
    return tuple(buckets)


@functools.lru_cache(maxsize=256)
def _build_plan(paths, shapes, dtypes, marks, gran: Granularity) -> UnitPlan:
    sizes = [math.prod(s) for s in shapes]
    total = sum(sizes)
    leaf_offsets = [sum(sizes[:i]) for i in range(len(sizes))]
    exec_dims: List[int] = []
    offsets: List[int] = []
    unit_leaf: List[int] = []
    fold_base: List[int] = []
    fold_inner: List[int] = []
    fold_double: List[bool] = []

    if gran.kind == "entire_model":
        exec_dims, offsets, unit_leaf = [total], [0], [-1]
        fold_base, fold_inner, fold_double = [0], [0], [False]
        acct_dims = [total]
        exec_total = total
    elif gran.kind == "blockwise":
        b = gran.block_size
        nb = -(-total // b) if total else 0
        exec_dims = [b] * nb
        offsets = [i * b for i in range(nb)]
        unit_leaf = [-1] * nb
        fold_base = list(range(nb))
        fold_inner = [0] * nb
        fold_double = [False] * nb
        n_full, rem = divmod(total, b)
        acct_dims = [b] * n_full + ([rem] if rem else [])
        exec_total = nb * b
    else:  # layerwise
        uid = 0
        for li, (shape, size, stacked) in enumerate(zip(shapes, sizes,
                                                        marks)):
            off = leaf_offsets[li]
            if stacked and len(shape) >= 1 and shape[0] > 0:
                L = shape[0]
                d = size // L
                for i in range(L):
                    exec_dims.append(d)
                    offsets.append(off + i * d)
                    unit_leaf.append(li)
                    fold_base.append(uid)   # base folded at the leaf's
                    fold_inner.append(i)    # FIRST uid, then by row
                    fold_double.append(True)
                uid += L
            else:
                exec_dims.append(size)
                offsets.append(off)
                unit_leaf.append(li)
                fold_base.append(uid)
                fold_inner.append(0)
                fold_double.append(False)
                uid += 1
        acct_dims = list(exec_dims)
        exec_total = total

    return UnitPlan(
        granularity=gran, paths=paths, leaf_shapes=shapes,
        leaf_dtypes=dtypes, total=total, exec_total=exec_total,
        unit_dims=tuple(acct_dims), exec_dims=tuple(exec_dims),
        unit_offsets=tuple(offsets), unit_leaf=tuple(unit_leaf),
        buckets=_make_buckets(exec_dims, offsets, unit_leaf, leaf_offsets,
                              sizes),
        fold_base=tuple(fold_base), fold_inner=tuple(fold_inner),
        fold_double=tuple(fold_double))


def build_plan(tree, stacked, gran: Granularity) -> UnitPlan:
    """Build (or fetch the cached) UnitPlan for a gradient tree. Only the
    static shapes/dtypes are read (meta tensors are fine)."""
    leaves = tree_leaves(tree)
    shapes = tuple(tuple(int(s) for s in l.shape) for l in leaves)
    dtypes = tuple(l.dtype for l in leaves)
    marks = tuple(bool(m) for m in tree_leaves(stacked))
    if gran.kind == "layerwise" and len(marks) != len(leaves):
        raise ValueError(
            f"stacked mask has {len(marks)} leaves, tree has {len(leaves)}")
    if gran.kind != "layerwise":
        marks = (False,) * len(leaves)  # irrelevant: canonicalize cache key
    return _build_plan(tuple(tree_paths(tree)), shapes, dtypes, marks, gran)


def plan_unit_dims(tree, stacked, gran: Granularity) -> List[int]:
    """Accounting dims via the plan (== granularity.unit_dims)."""
    return list(build_plan(tree, stacked, gran).unit_dims)
