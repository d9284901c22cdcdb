"""The port's checkpoints (ckpt/checkpoint.py) against the JAX package's
file format.

Held, bitwise: a file written by either package loads in the other with
every leaf's dtype and bits (f32, bf16 stored as uint16 views, int32),
both packages write the same keys, metadata and arrays; a truncated or
bit-flipped file raises ValueError; latest_checkpoint skips staged
`.tmp.npz` files; leaves go to the devices of `like`. The train CLI's
checkpointing and its bitwise kill-and-resume on 2 gloo CPU ranks are
held in tests/test_torch_engine.py, beside the CLI's run.
"""
import json
import pathlib
import zipfile

import numpy as np
import pytest
import torch

from test_torch_ref import reference


def _tree(rng):
    """A nested params / optimizer tree with f32, bf16 and int32 leaves,
    as numpy (ml_dtypes bf16)."""
    import ml_dtypes
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    bf16 = ml_dtypes.bfloat16
    return {"params": {"blocks": {"wq": f(2, 3, 4),
                                  "norm_g": f(2, 4).astype(bf16)},
                       "embed": f(7, 4)},
            "opt": {"m": {"blocks": {"wq": f(2, 3, 4), "norm_g": f(2, 4)},
                          "embed": f(7, 4)},
                    "count": np.array(3, np.int32)}}


def _torch(tree):
    from repro_torch.convert import map_tree, tensor_from_numpy
    return map_tree(lambda a: tensor_from_numpy(a), tree)


def _bits(x) -> bytes:
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().tobytes()
        return x.numpy().tobytes()
    return np.asarray(x).tobytes()


def _same(a, b, path=""):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _same(a[k], b[k], f"{path}/{k}")
        return
    assert _bits(a) == _bits(b), path
    da = str(a.dtype).replace("torch.", "")
    db = str(b.dtype).replace("torch.", "")
    assert da == db, (path, da, db)


def _contents(path):
    with np.load(path) as z:
        meta = json.loads(str(z["__meta__"]))
        return meta, {k: z[k].tobytes() for k in z.files if k != "__meta__"}


def test_files_load_bitwise_across_packages(tmp_path):
    from repro_torch.ckpt import load_checkpoint, save_checkpoint
    rng = np.random.default_rng(0)
    tree = _tree(rng)
    with reference("repro.ckpt.checkpoint") as ref:
        import jax
        import jax.numpy as jnp
        jtree = jax.tree_util.tree_map(jnp.asarray, tree)
        ref_path = ref.checkpoint.save_checkpoint(str(tmp_path / "ref"), 5,
                                                  jtree)
        port_path = save_checkpoint(str(tmp_path / "port"), 5, _torch(tree))
        step, back = ref.checkpoint.load_checkpoint(port_path, jtree)
        assert step == 5
        _same(jax.tree_util.tree_map(np.asarray, back), tree)
    assert pathlib.Path(ref_path).name == pathlib.Path(port_path).name \
        == "ckpt_00000005_s0.npz"
    like = _torch(jax.tree_util.tree_map(np.zeros_like, tree))
    step, got = load_checkpoint(ref_path, like)
    assert step == 5
    _same(got, _torch(tree))
    assert _contents(ref_path) == _contents(port_path)


def test_corrupt_files_raise(tmp_path):
    from repro_torch.ckpt import (latest_checkpoint, load_checkpoint,
                                  save_checkpoint)
    tree = _torch(_tree(np.random.default_rng(1)))
    path = pathlib.Path(save_checkpoint(str(tmp_path), 2, tree))
    raw = path.read_bytes()
    cut = tmp_path / "cut.npz"
    cut.write_bytes(raw[:len(raw) // 2])
    with pytest.raises(ValueError, match="corrupt or truncated"):
        load_checkpoint(str(cut), tree)
    # flip one bit of an array's bytes and rewrite the zip's CRCs, so
    # only the checkpoint's own digest can see it
    flipped = tmp_path / "flip.npz"
    with zipfile.ZipFile(path) as zin, zipfile.ZipFile(flipped, "w") as zo:
        for item in zin.infolist():
            data = bytearray(zin.read(item.filename))
            if item.filename == "a0.npy":
                data[-1] ^= 0x01
            zo.writestr(item, bytes(data))
    with pytest.raises(ValueError, match="digest mismatch"):
        load_checkpoint(str(flipped), tree)
    with pytest.raises(ValueError, match="missing keys"):
        load_checkpoint(str(path), {**tree, "extra": torch.zeros(1)})
    # a staged write never counts as a checkpoint
    (tmp_path / "ckpt_00000009_s0.npz.tmp.npz").write_bytes(raw)
    assert latest_checkpoint(str(tmp_path)) == str(path)
    assert latest_checkpoint(str(tmp_path / "none")) is None


def test_leaves_go_to_the_devices_of_like(tmp_path):
    from repro_torch.ckpt import load_checkpoint, save_checkpoint
    tree = _torch(_tree(np.random.default_rng(2)))
    path = save_checkpoint(str(tmp_path), 1, tree)
    like = {"params": {"blocks": {"wq": torch.empty((2, 3, 4),
                                                     device="meta"),
                                  "norm_g": tree["params"]["blocks"]
                                  ["norm_g"]},
                       "embed": tree["params"]["embed"]},
            "opt": tree["opt"]}
    _, got = load_checkpoint(path, like)
    assert got["params"]["blocks"]["wq"].device.type == "cpu"
    _same(got, tree)
