"""Compression granularity: entire-model vs layer-wise vs block-wise (the
JAX package's core/granularity.py).

  entire_model : every gradient leaf flattened and concatenated -> ONE unit
  layerwise    : one unit per logical layer tensor; layer-stacked leaves
                 (leading dim L under a 'blocks'-like key) give L units
  blockwise    : fixed-size blocks of the flattened gradient

`apply_unitwise` maps a function over the units through a UnitPlan
(core/plan.py); `apply_unitwise_reference` is the per-leaf path that is the
plan's oracle. In both, `fn` takes the port's batched form
fn(x2d, keys2d) -> y2d: the rows of x2d are units of one size, keys2d their
(n, 2) key data (a compressor's `sim` is such a function). The reference's
fn(x, key) on one unit, vmapped, is the same map.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.convert import tree_leaves, tree_paths, tree_unflatten
from repro_torch.random import fold_in

_STACK_NAMES = ("blocks", "layers", "encoder_blocks", "decoder_blocks")


@dataclasses.dataclass(frozen=True)
class Granularity:
    kind: str = "layerwise"  # entire_model | layerwise | blockwise
    block_size: int = 65536  # only for blockwise

    def __post_init__(self):
        if self.kind not in ("entire_model", "layerwise", "blockwise"):
            raise ValueError(f"unknown granularity kind {self.kind!r}")


def stacked_mask(params, is_stacked_path: Optional[Callable[[Tuple], bool]]
                 = None):
    """Tree of bools marking leaves whose leading axis is a layer stack.
    Default predicate: any path key named 'blocks' / 'layers' /
    'encoder_blocks' / 'decoder_blocks'."""
    pred = is_stacked_path or (lambda path: any(k in _STACK_NAMES
                                                for k in path))

    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        return pred(path)
    return walk(params, ())


def unit_dims(grads, stacked, gran: Granularity) -> List[int]:
    """Static per-unit dimensions d_j."""
    leaves = tree_leaves(grads)
    marks = tree_leaves(stacked)
    total = sum(int(l.numel()) for l in leaves)
    if gran.kind == "entire_model":
        return [total]
    if gran.kind == "blockwise":
        b = gran.block_size
        n_full, rem = divmod(total, b)
        return [b] * n_full + ([rem] if rem else [])
    dims: List[int] = []
    for leaf, s in zip(leaves, marks):
        if s and leaf.dim() >= 1 and leaf.shape[0] > 0:
            L = leaf.shape[0]
            dims.extend([int(leaf.numel()) // L] * L)
        else:
            dims.append(int(leaf.numel()))
    return dims


def num_units(grads, stacked, gran: Granularity) -> int:
    return len(unit_dims(grads, stacked, gran))


def apply_unitwise(fn, gran: Granularity, grads, stacked, key, plan=None):
    """Map fn(x2d, keys2d) -> y2d over every compression unit through a
    (cached) UnitPlan: one call per bucket. Returns a tree shaped and typed
    like `grads`. Pass `plan` to reuse one."""
    from repro_torch.core.plan import build_plan
    if plan is None:
        plan = build_plan(grads, stacked, gran)
    return plan.execute(fn, grads, key)


def apply_unitwise_with_state(fn, gran: Granularity, grads, state, stacked,
                              key, plan=None):
    """Like apply_unitwise, but fn(x2d, m2d, keys2d) -> (y2d, m2d_new)
    threads a same-shaped per-unit state (error-feedback memory)."""
    from repro_torch.core.plan import build_plan
    if plan is None:
        plan = build_plan(grads, stacked, gran)
    return plan.execute_with_state(fn, grads, state, key)


def _unit_batches(gran: Granularity, trees, stacked, key):
    """The per-leaf path's units: yields (f32 (n, d) matrices, one per tree
    in `trees`, (n, 2) keys, the leaf indices they cover or None for the
    flat vector). Keys as the reference derives them: fold_in(key, uid),
    fold_in(fold_in(key, uid), i) for row i of a stacked leaf, fold_in(key,
    i) for block i."""
    leaves = [tree_leaves(t) for t in trees]
    first = leaves[0]
    if gran.kind != "layerwise":
        flats = [torch.cat([l.reshape(-1).to(torch.float32) for l in ls])
                 for ls in leaves]
        if gran.kind == "entire_model":
            yield [f[None] for f in flats], fold_in(key, 0)[None], None
            return
        b = gran.block_size
        pad = (-flats[0].numel()) % b
        blocks = [F.pad(f, (0, pad)).reshape(-1, b)
                  for f in flats]
        ids = torch.arange(blocks[0].shape[0], device=key.device)
        yield blocks, fold_in(key, ids), None
        return
    uid = 0
    for li, (leaf, s) in enumerate(zip(first, tree_leaves(stacked))):
        if s and leaf.dim() >= 1 and leaf.shape[0] > 0:
            L = leaf.shape[0]
            ids = torch.arange(L, device=key.device)
            keys = fold_in(fold_in(key, uid), ids)
            uid += L
        else:
            L = 1
            keys = fold_in(key, uid)[None]
            uid += 1
        yield ([ls[li].reshape(L, -1).to(torch.float32) for ls in leaves],
               keys, li)


def _assemble_reference(grads, outs) -> dict:
    """Per-unit outputs of _unit_batches, in order -> a tree like grads."""
    leaves = tree_leaves(grads)
    if len(outs) == 1 and outs[0][1] is None:      # one flat vector
        flat = outs[0][0].reshape(-1)
        res, off = [], 0
        for l in leaves:
            res.append(flat[off:off + l.numel()].reshape(l.shape)
                       .to(l.dtype))
            off += l.numel()
    else:
        res = [y.reshape(leaves[li].shape).to(leaves[li].dtype)
               for y, li in outs]
    return tree_unflatten(tree_paths(grads), res)


def apply_unitwise_reference(fn, gran: Granularity, grads, stacked, key):
    """The per-leaf execution path (the plan's numerical oracle): one call
    of fn per leaf (layerwise) or on the flat vector."""
    outs = [(fn(xs[0], keys), li)
            for xs, keys, li in _unit_batches(gran, [grads], stacked, key)]
    return _assemble_reference(grads, outs)


def apply_unitwise_with_state_reference(fn, gran: Granularity, grads, state,
                                        stacked, key):
    """The per-leaf stateful path (the plan's numerical oracle)."""
    ys, ms = [], []
    for (x, m), keys, li in _unit_batches(gran, [grads, state], stacked,
                                          key):
        y, mn = fn(x, m, keys)
        ys.append((y, li))
        ms.append((mn, li))
    return (_assemble_reference(grads, ys), _assemble_reference(grads, ms))
