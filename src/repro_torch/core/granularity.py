"""Compression granularity: entire-model vs layer-wise vs block-wise (the
JAX package's core/granularity.py:39-89).

  entire_model : every gradient leaf flattened and concatenated -> ONE unit
  layerwise    : one unit per logical layer tensor; layer-stacked leaves
                 (leading dim L under a 'blocks'-like key) give L units
  blockwise    : fixed-size blocks of the flattened gradient
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

from repro_torch.convert import tree_leaves

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
