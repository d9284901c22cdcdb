"""Flat-npz checkpoints of parameter / optimizer trees, in the JAX
package's file format (its ckpt/checkpoint.py), so a file written by
either package loads bit for bit in the other.

Leaves are keyed by their tree path, "/".join of the dict keys (sorted,
as JAX flattens a dict) and list / tuple indices. The file holds arrays
a0, a1, ... in sorted key order and a `__meta__` JSON entry: step, the
keys, the dtypes that are not numpy's own (bf16 is stored as its uint16
bit patterns) and a CRC32 digest over every stored array's name, dtype,
shape and bytes plus the key list. Writes are atomic (`<path>.tmp.npz`,
then os.replace in the same directory), so a kill mid-save never leaves a
half-written file where `latest_checkpoint` looks. `load_checkpoint`
turns a truncated or altered file into a ValueError naming the path and
puts every leaf on the device of the matching leaf of `like`.

Data-parallel ranks hold identical state, so one process (rank 0) writes
shard 0 and every rank reads it. A state sharded over a (data, model)
mesh (tensor parallelism, FSDP) is saved as the reference's global file:
`save_sharded_checkpoint` gathers every leaf to its global array (a
collective: every rank calls it) and rank 0 writes, so the file holds
what an unsharded run with the same params writes;
`load_sharded_checkpoint` reads the global file and cuts each rank's
shards.
"""
from __future__ import annotations

import json
import os
import re
import zlib
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.convert import tensor_from_numpy


def _walk(tree, prefix=()):
    """(path, leaf) pairs in JAX's flatten order: dict keys sorted, list
    and tuple items by index; None is an empty subtree."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, prefix + (str(i),))
    elif tree is not None:
        yield prefix, tree


def _flatten_with_paths(tree) -> Dict[str, Any]:
    return {"/".join(p): leaf for p, leaf in _walk(tree)}


def _rebuild(tree, leaves):
    """`tree`'s structure with its leaves taken in order from `leaves`."""
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaves) for v in tree)
    if tree is None:
        return None
    return next(leaves)


def _to_numpy(v) -> Tuple[np.ndarray, Optional[str]]:
    """A leaf as stored: (array, "bfloat16" or None)."""
    if isinstance(v, torch.Tensor):
        t = v.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), None
    a = np.asarray(v)
    if a.dtype.name == "bfloat16":
        return a.view(np.uint16), "bfloat16"
    return a, None


def host_state(tree) -> Dict[str, np.ndarray]:
    """{path: numpy array} of a state tree on the host, each leaf as a
    checkpoint stores it (bf16 as its uint16 bit patterns)."""
    return {k: _to_numpy(v)[0] for k, v in _flatten_with_paths(tree).items()}


def _digest(arrays: Dict[str, np.ndarray], keys) -> int:
    """CRC32 over every stored array's (name, dtype, shape, bytes) plus
    the key list, on the AS-STORED views (bf16 already uint16), so save
    and load hash identical bytes."""
    crc = zlib.crc32(json.dumps(list(keys)).encode())
    for name in sorted(arrays):
        a = np.ascontiguousarray(arrays[name])
        crc = zlib.crc32(f"{name}|{a.dtype.str}|{a.shape}".encode(), crc)
        crc = zlib.crc32(a.tobytes(), crc)
    return crc & 0xFFFFFFFF


def save_checkpoint(directory: str, step: int, tree, *, tag: str = "ckpt",
                    shard: int = 0) -> str:
    """Atomically write one checkpoint of `tree` (tensors on any device,
    or numpy arrays) -> its final path `{tag}_{step:08d}_s{shard}.npz`."""
    os.makedirs(directory, exist_ok=True)
    flat = _flatten_with_paths(tree)
    arrays = {}
    meta = {"step": int(step), "keys": [], "dtypes": {}}
    for i, (k, v) in enumerate(sorted(flat.items())):
        name = f"a{i}"
        arr, special = _to_numpy(v)
        if special is not None:
            meta["dtypes"][name] = special
        arrays[name] = arr
        meta["keys"].append(k)
    meta["digest"] = _digest(arrays, meta["keys"])
    path = os.path.join(directory, f"{tag}_{step:08d}_s{shard}.npz")
    # np.savez appends ".npz" when missing: keep it on the staged name so
    # the file os.replace moves is exactly the one written
    tmp = path + ".tmp.npz"
    np.savez(tmp, __meta__=json.dumps(meta), **arrays)
    os.replace(tmp, path)
    return path


def latest_checkpoint(directory: str, tag: str = "ckpt") -> Optional[str]:
    """The shard-0 file of the highest step under `directory`, or None."""
    if not os.path.isdir(directory):
        return None
    pat = re.compile(rf"{tag}_(\d+)_s0\.npz$")
    best, best_step = None, -1
    for f in os.listdir(directory):
        m = pat.match(f)
        if m and int(m.group(1)) > best_step:
            best, best_step = os.path.join(directory, f), int(m.group(1))
    return best


def _device_of(leaf) -> torch.device:
    if isinstance(leaf, torch.Tensor) and leaf.device.type != "meta":
        return leaf.device
    return torch.device("cpu")


def load_checkpoint(path: str, like) -> Tuple[int, Any]:
    """Restore into the structure of `like` (a tree of tensors; meta
    tensors and non-tensors give CPU leaves) -> (step, tree). Each leaf
    keeps its stored dtype and bits and goes to the device of `like`'s
    leaf. A truncated, overwritten or otherwise corrupt file raises
    ValueError: the npz structure, the metadata and (when present, as in
    every file either package writes) the digest are checked first."""
    try:
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(str(z["__meta__"]))
            raw = {f"a{i}": np.asarray(z[f"a{i}"])
                   for i in range(len(meta["keys"]))}
    except Exception as e:
        raise ValueError(f"corrupt or truncated checkpoint {path!r}: "
                         f"{type(e).__name__}: {e}") from e
    want = meta.get("digest")
    if want is not None:
        got = _digest(raw, meta["keys"])
        if got != want:
            raise ValueError(
                f"corrupt checkpoint {path!r}: content digest mismatch "
                f"(stored {want:#010x}, recomputed {got:#010x})")
    flat = {}
    for i, k in enumerate(meta["keys"]):
        arr = raw[f"a{i}"]
        if meta["dtypes"].get(f"a{i}") == "bfloat16":
            flat[k] = torch.from_numpy(arr.view(np.int16)).view(
                torch.bfloat16)
        else:
            flat[k] = tensor_from_numpy(arr)
    ref = _flatten_with_paths(like)
    missing = set(ref) - set(flat)
    if missing:
        raise ValueError(f"checkpoint missing keys: {sorted(missing)[:5]}...")
    vals = iter([flat[k].to(_device_of(leaf)) for k, leaf in ref.items()])
    return meta["step"], _rebuild(like, vals)


def save_sharded_checkpoint(directory: str, step: int, state, engine, *,
                            tag: str = "ckpt") -> Optional[str]:
    """Gather the sharded {"params", "opt"} `state` of `engine` (a
    launch.engine.Engine) to global arrays on every rank, then write them
    from global rank 0 -> the path written there, None elsewhere."""
    import torch.distributed as dist
    full = engine.global_tree(state, engine.state_pspecs())
    if dist.is_available() and dist.is_initialized() and dist.get_rank():
        return None
    return save_checkpoint(directory, step, full, tag=tag)


def load_sharded_checkpoint(path: str, engine) -> Tuple[int, Any]:
    """Restore a global checkpoint into this rank's shards of `engine`'s
    {"params", "opt"} state, on the engine's device -> (step, state)."""
    step, full = load_checkpoint(path, engine.global_like())
    return step, engine.shard_tree(full, engine.state_pspecs())
