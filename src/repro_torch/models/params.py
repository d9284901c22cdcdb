"""Parameter trees with per-leaf metadata (the JAX package's
models/params.py).

Every architecture declares its parameters through ParamBuilder, attaching
per-leaf logical axes: "tp" (the tensor/expert-parallel mesh axis), "fsdp"
(the parameter-sharding axis) or None (replicated). From one declaration
come the shapes (meta tensors), the partition specs (one mesh axis name or
None per dim, the reference's PartitionSpecs as tuples), the init, the
stacked-layer mask (compression granularity) and the tp_grad_sync mask.
Leaves are (nested) dicts of tensors in the JAX layout; a stacked leaf
carries the layer count L as its leading dim.

`shard(leaf, spec, sizes, index)` gives a rank the block of a global leaf
that shard_map's in_specs give its device (each named dim cut into
equal blocks, the block at the rank's index along that axis);
`unshard(local, spec, sizes, gather)` reassembles the global leaf from
every rank's block.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.random import fold_in, generator

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    """A config's dtype string -> torch dtype."""
    if name not in DTYPES:
        raise ValueError(f"unknown dtype {name!r}; have {sorted(DTYPES)}")
    return DTYPES[name]


@dataclasses.dataclass(frozen=True)
class LeafMeta:
    axes: Tuple[Optional[str], ...]   # logical axis per GLOBAL dim
    stacked: bool = False             # leading dim is a layer stack
    tp_grad_sync: bool = False        # needs grad psum over dist.tp
    init: str = "normal"              # normal | zeros | ones
    fan_in_dim: Optional[int] = None  # dim index used for 1/sqrt(fan_in) scale
    scale: float = 1.0

    def fsdp_dim(self) -> Optional[int]:
        return self.axes.index("fsdp") if "fsdp" in self.axes else None

    def pspec(self, dist) -> Tuple[Optional[str], ...]:
        """One mesh axis name or None per dim: "tp" -> dist.tp, "fsdp" ->
        dist.fsdp."""
        return tuple(dist.tp if a == "tp" else dist.fsdp if a == "fsdp"
                     else None for a in self.axes)


def shard(leaf: torch.Tensor, spec, sizes: Dict[str, int],
          index: Dict[str, int]) -> torch.Tensor:
    """This rank's block of a global leaf under partition `spec`: dim i
    cut into sizes[spec[i]] equal blocks, the block index[spec[i]] kept.
    Axes missing from `sizes` count as size 1."""
    out = leaf
    for dim, ax in enumerate(spec):
        n = sizes.get(ax, 1) if ax is not None else 1
        if n == 1:
            continue
        if out.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(leaf.shape)} does not "
                             f"split over {n} ranks of axis {ax!r}")
        local = out.shape[dim] // n
        out = out.narrow(dim, index[ax] * local, local)
    return out.contiguous()


def unshard(local: torch.Tensor, spec, sizes: Dict[str, int],
            gather) -> torch.Tensor:
    """The global leaf from every rank's block: for each named dim (last
    first), `gather(t, axis)` returns the blocks of the ranks along that
    axis in index order, which are concatenated along the dim."""
    out = local
    for dim in reversed(range(len(spec))):
        ax = spec[dim]
        if ax is None or sizes.get(ax, 1) == 1:
            continue
        out = torch.cat(list(gather(out.contiguous(), ax)), dim=dim)
    return out


def _nested_set(d: Dict, path: str, value: Any):
    keys = path.split("/")
    for k in keys[:-1]:
        d = d.setdefault(k, {})
    d[keys[-1]] = value


class ParamBuilder:
    def __init__(self, dtype: str = "bfloat16"):
        self.dtype = torch_dtype(dtype)
        self._shapes: Dict[str, Tuple[int, ...]] = {}
        self._meta: Dict[str, LeafMeta] = {}

    def add(self, path: str, shape: Tuple[int, ...],
            axes: Tuple[Optional[str], ...], *, stacked: bool = False,
            tp_grad_sync: bool = False, init: str = "normal",
            fan_in_dim: Optional[int] = None, scale: float = 1.0):
        if len(axes) != len(shape):
            raise ValueError(f"{path}: {len(axes)} axes for shape {shape}")
        self._shapes[path] = tuple(int(s) for s in shape)
        self._meta[path] = LeafMeta(tuple(axes), stacked, tp_grad_sync, init,
                                    fan_in_dim, scale)
        return self

    def _tree(self, value) -> Dict:
        out: Dict = {}
        for p in self._shapes:
            _nested_set(out, p, value(p))
        return out

    def shapes(self) -> Dict:
        """Meta-device tensors of every leaf's shape and dtype."""
        return self._tree(lambda p: torch.empty(
            self._shapes[p], dtype=self.dtype, device="meta"))

    def meta(self) -> Dict:
        return self._tree(lambda p: self._meta[p])

    def pspecs(self, dist) -> Dict:
        return self._tree(lambda p: self._meta[p].pspec(dist))

    def stacked_mask(self) -> Dict:
        return self._tree(lambda p: self._meta[p].stacked)

    def tp_sync_mask(self) -> Dict:
        return self._tree(lambda p: self._meta[p].tp_grad_sync)

    def init(self, key: torch.Tensor, device="cuda") -> Dict:
        """Materialize every leaf on `device`: leaf i (declaration order)
        drawn from a generator on the device seeded by fold_in(key, i),
        std = scale / sqrt(fan_in), in f32 then cast. Not bitwise the
        reference's draws (tests convert JAX params)."""
        dev = resolve_device(device)
        out: Dict = {}
        for i, (p, shape) in enumerate(self._shapes.items()):
            m = self._meta[p]
            if m.init == "zeros":
                val = torch.zeros(shape, dtype=self.dtype, device=dev)
            elif m.init == "ones":
                val = torch.ones(shape, dtype=self.dtype, device=dev)
            else:
                fan_dim = m.fan_in_dim
                if fan_dim is None:
                    fan_dim = len(shape) - 2 if len(shape) >= 2 else 0
                std = m.scale / math.sqrt(max(1, shape[fan_dim]))
                g = generator(fold_in(key, i), dev)
                val = torch.randn(shape, generator=g, device=dev).mul_(
                    std).to(self.dtype)
            _nested_set(out, p, val)
        return out
