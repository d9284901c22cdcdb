"""Harness of the port's differential tests, the port-only checks, and the
PRNG held against jax.random.

The JAX package is the reference. `reference()` imports it at TEST time,
never at collection: under jax 0.9 `repro.core` only imports with a
shim for the `primitive_batchers` proxy (core/schedule.py:74 tests
membership, which the proxy does not support). The shim is set for the
import and removed again, so other test modules collect exactly as they
would without this file. Every comparison runs inside a function-scoped
`jax.threefry_partitionable(False)` — the layout the reference's
in-kernel threefry reproduces — so no flag outlives its test.

Inputs are made with numpy from a seed and handed to both sides.
"""
import ast
import contextlib
import dataclasses
import importlib
import pathlib
import types

import jax
import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]

_REF_MODULES = ("repro.core", "repro.core.wire", "repro.core.plan",
                "repro.core.compressors", "repro.core.granularity",
                "repro.core.theory", "repro.kernels.ops",
                "repro.kernels.prng", "repro.kernels.ref",
                "repro.kernels.qsgd", "repro.kernels.terngrad",
                "repro.kernels.sign", "repro.kernels.pack",
                "repro.kernels.topk_mask", "repro.kernels.rmsnorm",
                "repro.models.cnn", "repro.configs.resnet9_cifar",
                "repro.data.synthetic")


@contextlib.contextmanager
def reference(*extra):
    """The JAX package's modules (attribute names: the last dotted part),
    those of _REF_MODULES and the `extra` dotted names, usable inside the
    block under jax.threefry_partitionable(False)."""
    from jax.interpreters import batching
    cls = type(batching.primitive_batchers)
    had = "__contains__" in cls.__dict__
    old = cls.__dict__.get("__contains__")
    cls.__contains__ = lambda self, p: True
    try:
        mods = {m.rsplit(".", 1)[-1]: importlib.import_module(m)
                for m in _REF_MODULES + extra}
    finally:
        if had:
            cls.__contains__ = old
        else:
            del cls.__contains__
    with jax.threefry_partitionable(False):
        yield types.SimpleNamespace(**mods)


def jkey(seed):
    return jax.random.key(seed)


def key_data(k) -> np.ndarray:
    """jax key (typed or raw) -> uint32 numpy key data."""
    if jax.numpy.issubdtype(k.dtype, jax.dtypes.prng_key):
        k = jax.random.key_data(k)
    return np.asarray(k, dtype=np.uint32)


def tkeys(np_u32) -> torch.Tensor:
    """uint32 numpy key data -> the port's int64 key tensor."""
    return torch.from_numpy(np.asarray(np_u32, np.uint32).astype(np.int64))


def np_bits(t: torch.Tensor) -> np.ndarray:
    """int32 word tensor -> uint32 numpy (same bits)."""
    return t.numpy().view(np.uint32)


# ---- port-only: imports, device, routing ------------------------------------

def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    [p.relative_to(ROOT).as_posix()
     for p in (ROOT / "src" / "repro_torch").rglob("*.py")]
    + ["chip_smoke.py"]))
def test_port_imports_no_jax_and_no_reference(path):
    for name in _imports(ROOT / path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (path, name)


def test_train_cnn_refuses_cuda_without_a_card():
    from repro_torch.experiment import train_cnn
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cnn("resnet9", None, steps=1, device="cuda")


def test_wrappers_route_cpu_tensors_to_plain_versions():
    from repro_torch import kernels
    from repro_torch.kernels import ops
    kernels.reset_launch_counts()
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((3, 70)).astype(np.float32))
    keys = tkeys(rng.integers(0, 2**32, (3, 2), dtype=np.uint64))
    w, nrm = ops.qsgd_pack_units(x, keys, 16, 6)
    assert ops.qsgd_unpack_units(w, nrm, 70, 16, 6).shape == (3, 70)
    w, s = ops.terngrad_pack_units(x, keys)
    assert ops.terngrad_unpack_units(w, s, 70).shape == (3, 70)
    w = ops.sign_pack_units(x)
    assert ops.sign_unpack_units(w, 70).shape == (3, 70)
    w = ops.fields_pack_units(torch.arange(210).reshape(3, 70), 8)
    assert ops.fields_unpack_units(w, 70, 8).shape == (3, 70)
    w = ops.pack_words(x >= 0)
    assert ops.unpack_words(w, 70).shape == (3, 70)
    assert ops.majority_words(w).shape == (3,)
    assert kernels.launch_counts() == {
        "qsgd_pack": 0, "qsgd_unpack": 0, "terngrad_pack": 0,
        "terngrad_unpack": 0, "sign_pack": 0, "sign_unpack": 0,
        "fields_pack": 0, "fields_unpack": 0, "bits_pack": 0,
        "bits_unpack": 0, "majority": 0, "qsgd_compress_rows": 0,
        "terngrad_compress_rows": 0, "topk_mask": 0, "rmsnorm": 0}


def test_wrapper_rejects_a_device_without_a_kernel():
    """A wrapper launches on CUDA, takes the plain version on the CPU and
    its shape function on meta (a dry run; tests/test_torch_dryrun.py
    holds its shapes); any other device raises before anything runs. This
    CPU build makes tensors on no other device, so stand-ins carrying an
    XPU device are what the wrappers see."""
    import types
    from repro_torch.kernels.pack import (bits_pack, bits_unpack,
                                          fields_pack, fields_unpack)
    from repro_torch.kernels.qsgd import qsgd_pack
    from repro_torch.kernels.sign import majority, sign_pack, sign_unpack
    x = k = w = types.SimpleNamespace(device=torch.device("xpu"),
                                      shape=(1, 4), dim=lambda: 2)
    calls = [lambda: qsgd_pack(x, k, k, x, 16, 6),
             lambda: sign_pack(x), lambda: sign_unpack(w, 4),
             lambda: fields_pack(w, 9), lambda: fields_unpack(w, 4, 9),
             lambda: bits_pack(w), lambda: bits_unpack(w, 4),
             lambda: majority(w)]
    for call in calls:
        with pytest.raises(ValueError, match="no kernel for device xpu"):
            call()
    launched = bits_pack.launches
    words = bits_pack(torch.zeros((1, 4), dtype=torch.int32, device="meta"))
    assert words.is_meta and words.shape == (1, 1)
    assert bits_pack.launches == launched


# ---- PRNG against jax.random -------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 12345, -7, 2**31 - 1])
def test_key_and_fold_in(seed):
    from repro_torch import random as R
    with reference():
        k = jkey(seed)
        assert np.array_equal(key_data(k), R.key(seed).numpy())
        for data in (0, 1, 0x5EED, 10_000, 999_999, 2**31 - 1):
            want = key_data(jax.random.fold_in(k, data))
            got = R.fold_in(R.key(seed), data).numpy()
            assert np.array_equal(want, got), (seed, data)


@pytest.mark.parametrize("num", [1, 2, 3, 32])
def test_split(num):
    from repro_torch import random as R
    with reference():
        want = key_data(jax.random.split(jkey(5), num))
        assert np.array_equal(want, R.split(R.key(5), num).numpy())


@pytest.mark.parametrize("n", [1, 2, 7, 64, 513, 4608])
def test_uniform_bernoulli_and_uniform_at(n):
    from repro_torch import random as R
    from repro_torch.kernels import prng
    with reference() as ref:
        k = jax.random.fold_in(jkey(11), n)
        tk = tkeys(key_data(k))
        want = np.asarray(jax.random.uniform(k, (n,)))
        got = R.uniform(tk, (n,)).numpy()
        assert np.array_equal(want.view(np.uint32), got.view(np.uint32))
        pos = np.arange(n)[::-1].copy()
        at = prng.uniform_at(tk[0], tk[1], torch.from_numpy(pos), n).numpy()
        assert np.array_equal(want[pos].view(np.uint32), at.view(np.uint32))
        kd = key_data(k)
        jat = np.asarray(ref.prng.uniform_at(
            jax.numpy.uint32(kd[0]), jax.numpy.uint32(kd[1]),
            jax.numpy.asarray(pos, jax.numpy.int32), n))
        assert np.array_equal(jat.view(np.uint32), at.view(np.uint32))
        p = np.random.default_rng(n).random(n).astype(np.float32)
        wb = np.asarray(jax.random.bernoulli(k, p))
        assert np.array_equal(wb, R.bernoulli(tk, torch.from_numpy(p)).numpy())


def buckets(plan):
    """Bucket tables as plain tuples (the two packages' Bucket classes
    differ, their fields must not)."""
    return [dataclasses.astuple(b) for b in plan.buckets]


def _resnet9_pair(ref, seed=0):
    """(JAX resnet9 params, the port's converted copy on the CPU)."""
    from repro_torch.convert import params_from_jax
    p = ref.cnn.init_cnn(ref.resnet9_cifar.RESNET9, jkey(seed))
    return p, params_from_jax(jax.tree_util.tree_map(np.asarray, p),
                              device="cpu")


@pytest.mark.parametrize("gran", ["layerwise", "entire_model"])
def test_resnet9_plan_and_unit_keys(gran):
    from repro_torch import random as R
    from repro_torch.core.granularity import (Granularity, stacked_mask,
                                              unit_dims)
    from repro_torch.core.plan import build_plan
    with reference() as ref:
        jp, tp = _resnet9_pair(ref)
        jplan = ref.core.build_plan(jp, ref.core.stacked_mask(jp),
                                    ref.core.Granularity(gran))
        plan = build_plan(tp, stacked_mask(tp), Granularity(gran))
        assert plan.summary() == jplan.summary()
        assert unit_dims(tp, stacked_mask(tp), Granularity(gran)) == list(
            jplan.unit_dims)
        assert buckets(plan) == buckets(jplan)
        assert plan.readiness_order() == jplan.readiness_order()
        for seed in (0, 3):
            want = key_data(jplan.unit_keys(jkey(seed)))
            assert np.array_equal(want, plan.unit_keys(R.key(seed)).numpy())
    expect = ("UnitPlan(layerwise: 14 units, 11 dispatches [1x16, 1x432, "
              "1x32, 1x4608, 1x64, 1x18432, 1x10, 1x640, 2x2304, 2x9216, "
              "2x36864])" if gran == "layerwise" else
              "UnitPlan(entire_model: 1 units, 1 dispatches [1x121002])")
    assert plan.summary() == expect


def test_stacked_plan_double_fold_keys():
    """Layer-stacked leaves fold twice (plan.py fold tables)."""
    from repro_torch import random as R
    from repro_torch.core.granularity import Granularity, stacked_mask
    from repro_torch.core.plan import build_plan
    shapes = {"blocks": {"w": (3, 4, 5), "b": (3, 5)}, "head": (7,)}
    with reference() as ref:
        jt = jax.tree_util.tree_map(lambda s: jax.numpy.zeros(s), shapes,
                                    is_leaf=lambda s: isinstance(s, tuple))
        tt = {"blocks": {"w": torch.zeros(3, 4, 5), "b": torch.zeros(3, 5)},
              "head": torch.zeros(7)}
        jplan = ref.core.build_plan(jt, ref.core.stacked_mask(jt),
                                    ref.core.Granularity("layerwise"))
        plan = build_plan(tt, stacked_mask(tt), Granularity("layerwise"))
        assert buckets(plan) == buckets(jplan)
        assert plan.unit_dims == jplan.unit_dims == (5, 5, 5, 20, 20, 20, 7)
        assert np.array_equal(key_data(jplan.unit_keys(jkey(9))),
                              plan.unit_keys(R.key(9)).numpy())
