"""Parameter and cache trees: JAX-layout numpy arrays -> the port's
tensors, and the dict flatten order JAX uses.

JAX flattens a dict in SORTED key order, and that order is part of the
wire contract: it fixes unit ids, PRNG fold tables and bucket order
(core/plan.py). The port's trees are plain (nested) dicts of tensors and
flatten the same way. Leaves keep the JAX layout: conv weights stay HWIO,
images NHWC (models/cnn.py permutes internally).
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

import numpy as np
import torch

from repro_torch import resolve_device

Path = Tuple[str, ...]


def tree_paths(tree) -> List[Path]:
    """Key paths of every leaf, in JAX's sorted-key flatten order."""
    if isinstance(tree, dict):
        return [(k,) + p for k in sorted(tree) for p in tree_paths(tree[k])]
    return [()]


def tree_leaves(tree) -> List[Any]:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(paths, leaves) -> dict:
    """Inverse of (tree_paths, tree_leaves)."""
    out: dict = {}
    for path, leaf in zip(paths, leaves):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def tree_map(fn: Callable, tree, *rest):
    """fn over corresponding leaves of same-structured trees."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)


def tensor_from_numpy(a) -> torch.Tensor:
    """A numpy array -> a CPU tensor of the same dtype and bits. A bf16
    array (ml_dtypes.bfloat16, which torch.from_numpy refuses) goes
    through its uint16 bit patterns."""
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_jax(np_tree, device="cuda") -> dict:
    """A JAX parameter tree (leaves as numpy arrays, e.g. via
    jax.tree_util.tree_map(np.asarray, params)) -> the port's dict of
    tensors in the SAME layout and dtype (bf16 included), on `device`."""
    dev = resolve_device(device)
    return tree_map(lambda a: tensor_from_numpy(a).to(dev), np_tree)


def map_tree(fn: Callable, tree, *rest):
    """fn over corresponding leaves of same-structured trees of dicts,
    tuples and None (a decode cache: interleaved MoE's pair of half-depth
    caches, a hybrid without a tail)."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, tuple):
        return tuple(map_tree(fn, t, *(r[i] for r in rest))
                     for i, t in enumerate(tree))
    if tree is None:
        return None
    return fn(tree, *rest)


def cache_from_jax(np_tree, device="cuda"):
    """A reference decode cache (Model.prefill's or decode_step's, leaves
    as numpy arrays) -> the port's cache: the same tree, layout, dtypes
    and bits, on `device`."""
    dev = resolve_device(device)
    return map_tree(lambda a: tensor_from_numpy(a).to(dev), np_tree)
