"""The port's compress-only QSGD / TernGrad path against the JAX package:

  ref.qsgd_ref / terngrad_ref          vs kernels/ref.py:16, :28 (jitted)
  ops.qsgd_compress / terngrad_compress vs kernels/ops.py:53, :69
  ops.*_compress_units                  vs kernels/ops.py:131, :152
  ops.plan_compress                     vs kernels/ops.py:178

The reference side runs its Pallas kernels in interpret mode at small
shapes and its plain path (use_pallas=False, bitwise equal to interpret
mode) at d = 121,002. The oracles are held against the reference's
oracles under jax.jit, the only way the reference runs them: XLA then
turns n / levels into n * f32(1 / levels), and a multiply by a 0/1 mask
into a select.

Tolerances: bitwise everywhere, given equal statistics. QSGD's l2 norm is
summed in another order by torch and jnp, so QSGD is bitwise on dyadic
inputs (every sum of squares exact) and otherwise holds ROADMAP Queue 3
item 1: entries within 1e-4 relative, except at most 0.1% one level
(norm / levels) apart.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_ref import jkey, key_data, reference, tkeys

DYADIC = np.float32([0, 0.25, -0.25, 0.5, -0.5, 1, -1, 2, -2])
SHAPES = [(37,), (512,), (4096,), (3, 700), (8, 8, 33)]
LEVELS = [4, 5, 7, 16, 64]
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _x(shape, seed, dyadic=False):
    """Seeded f32 input with some -0.0 entries (sign(-0.0) is -0.0)."""
    rng = np.random.default_rng(seed)
    x = (rng.choice(DYADIC, shape) if dyadic
         else rng.standard_normal(shape).astype(np.float32))
    x.reshape(-1)[3::17] = -0.0
    return x


def _pair(x, dtype):
    """The same input for both sides, cast to `dtype` (round to nearest
    even on both)."""
    jd, td = DTYPES[dtype]
    return jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td)


def _bits(a) -> np.ndarray:
    """jax or torch array of any float dtype -> its f32 values' bits."""
    if isinstance(a, torch.Tensor):
        a = a.to(torch.float32).numpy()
    return np.asarray(a, dtype=np.float32).view(np.uint32)


def assert_bitwise(want, got):
    assert np.array_equal(_bits(want), _bits(got)), (
        int((_bits(want) != _bits(got)).sum()), "entries differ")


def assert_qsgd_close(want, got, x, levels, axis=None):
    """Queue 3 item 1 on QSGD outputs: within 1e-4 relative, except at
    most 0.1% of entries one level (norm / levels) apart."""
    want = np.asarray(want, np.float64)
    got = got.to(torch.float64).numpy()
    norm = np.linalg.norm(np.asarray(x, np.float64), axis=axis,
                          keepdims=axis is not None)
    err = np.abs(want - got)
    off = err > 1e-4 * np.abs(want)
    assert off.mean() <= 1e-3, off.mean()
    assert np.all(err <= np.broadcast_to(norm / levels * 1.0001, err.shape))


# ---- oracles ----------------------------------------------------------------

@pytest.mark.parametrize("levels", LEVELS)
@pytest.mark.parametrize("per_row", [False, True], ids=["scalar", "rows"])
def test_qsgd_ref_matches_reference_oracle(levels, per_row):
    from repro_torch.kernels import ref as P
    rng = np.random.default_rng(levels)
    x = _x((16, 512), levels)
    u = rng.random((16, 512), dtype=np.float32)
    norm = (np.linalg.norm(x, axis=1, keepdims=True).astype(np.float32)
            if per_row else np.float32(np.linalg.norm(x)))
    norm = np.asarray(norm)
    if per_row:
        norm[0] = 0.0                             # max(norm, 1e-12)
    with reference() as ref:
        want = jax.jit(ref.ref.qsgd_ref, static_argnums=3)(
            jnp.asarray(x), jnp.asarray(u), jnp.asarray(norm), levels)
    got = P.qsgd_ref(torch.from_numpy(x), torch.from_numpy(u),
                     torch.from_numpy(norm), levels)
    assert_bitwise(want, got)


@pytest.mark.parametrize("per_row", [False, True], ids=["scalar", "rows"])
def test_terngrad_ref_matches_reference_oracle(per_row):
    from repro_torch.kernels import ref as P
    rng = np.random.default_rng(1)
    x = _x((16, 512), 1)
    u = rng.random((16, 512), dtype=np.float32)
    scale = np.asarray(np.abs(x).max(axis=1, keepdims=True) if per_row
                       else np.abs(x).max())
    if per_row:
        scale[0] = 0.0
    with reference() as ref:
        want = jax.jit(ref.ref.terngrad_ref)(
            jnp.asarray(x), jnp.asarray(u), jnp.asarray(scale))
    got = P.terngrad_ref(torch.from_numpy(x), torch.from_numpy(u),
                         torch.from_numpy(scale))
    assert_bitwise(want, got)


def _round_f32(q) -> np.float32:
    """The f32 nearest to the rational q, ties to even."""
    from fractions import Fraction
    r = np.float32(float(q))
    cands = [np.nextafter(r, np.float32(-np.inf)), r,
             np.nextafter(r, np.float32(np.inf))]
    dist = [abs(Fraction(float(c)) - q) for c in cands]
    best = min(dist)
    ties = [c for c, e in zip(cands, dist) if e == best]
    return min(ties, key=lambda c: int(np.float32(c).view(np.uint32)) & 1)


def test_fma_f32_rounds_once():
    """ref.fma_f32 (the plain version of the kernels' fmaf) against the
    exactly rounded a * b + c, with the double-rounding traps: a * b an f32
    midpoint and c far below the f64 ulp."""
    from fractions import Fraction
    from repro_torch.kernels import ref as P
    rng = np.random.default_rng(0)
    a = (rng.standard_normal(400) * 2.0 ** rng.integers(-30, 30, 400))
    c = (rng.standard_normal(400) * 2.0 ** rng.integers(-60, 30, 400))
    a, c = a.astype(np.float32), c.astype(np.float32)
    mid = np.float32(1 + 2.0**-23)                # 3 * mid: an f32 midpoint
    a = np.concatenate([a, [mid] * 4]).astype(np.float32)
    c = np.concatenate([c, [-2.0**-60, 2.0**-60, -2.0**-80, 0.0]])
    c = c.astype(np.float32)
    for b in (3, 7, 16):
        got = P.fma_f32(torch.from_numpy(a), b, torch.from_numpy(c)).numpy()
        want = np.array([_round_f32(Fraction(float(x)) * b + Fraction(float(y)))
                         for x, y in zip(a, c)], np.float32)
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


# ---- whole inputs ------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("levels", LEVELS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_qsgd_compress_bitwise_on_dyadic_inputs(shape, levels, dtype):
    from repro_torch.kernels import ops
    jx, tx = _pair(_x(shape, levels, dyadic=True), dtype)
    with reference() as ref:
        k = jkey(levels)
        want = ref.ops.qsgd_compress(jx, k, levels, use_pallas=True)
    got = ops.qsgd_compress(tx, tkeys(key_data(k)), levels)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    assert_bitwise(want, got)


@pytest.mark.parametrize("levels", [5, 7])
def test_qsgd_compress_reciprocal_factor_at_full_width(levels):
    """d = 121,002 (resnet9's entire model): n / levels is a multiply by
    the rounded reciprocal in the reference (1,990 entries one ulp off at
    levels 7 with an IEEE divide)."""
    from repro_torch.kernels import ops
    x = _x((121002,), 7, dyadic=True)
    with reference() as ref:
        k = jkey(11)
        want = ref.ops.qsgd_compress(jnp.asarray(x), k, levels,
                                     use_pallas=False)
    assert_bitwise(want, ops.qsgd_compress(torch.from_numpy(x),
                                           tkeys(key_data(k)), levels))


@pytest.mark.parametrize("levels", [7, 16])
def test_qsgd_compress_random_inputs_within_tolerance(levels):
    from repro_torch.kernels import ops
    x = _x((121002,), 3)
    with reference() as ref:
        k = jkey(12)
        want = ref.ops.qsgd_compress(jnp.asarray(x), k, levels,
                                     use_pallas=False)
    got = ops.qsgd_compress(torch.from_numpy(x), tkeys(key_data(k)), levels)
    assert_qsgd_close(want, got, x, levels)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES + [(121002,)], ids=str)
def test_terngrad_compress_bitwise(shape, dtype):
    from repro_torch.kernels import ops
    jx, tx = _pair(_x(shape, 5), dtype)
    with reference() as ref:
        k = jkey(6)
        want = ref.ops.terngrad_compress(jx, k,
                                         use_pallas=jx.size <= 4096)
    got = ops.terngrad_compress(tx, tkeys(key_data(k)))
    assert got.dtype == tx.dtype and got.shape == tx.shape
    assert_bitwise(want, got)


# ---- UnitPlan buckets --------------------------------------------------------

UNIT_SHAPES = [(1, 37), (5, 64), (3, 700), (2, 4608)]


def _unit_keys(n, seed):
    keys = jax.random.split(jkey(seed), n)
    return keys, tkeys(key_data(keys))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("levels", [4, 7, 16])
@pytest.mark.parametrize("shape", UNIT_SHAPES, ids=str)
def test_qsgd_compress_units_bitwise_on_dyadic_inputs(shape, levels, dtype):
    from repro_torch.kernels import ops
    jx, tx = _pair(_x(shape, levels, dyadic=True), dtype)
    jk, tk = _unit_keys(shape[0], levels)
    with reference() as ref:
        want = ref.ops.qsgd_compress_units(jx, jk, levels, use_pallas=True)
    got = ops.qsgd_compress_units(tx, tk, levels)
    assert got.dtype == tx.dtype
    assert_bitwise(want, got)


def test_qsgd_compress_units_random_inputs_within_tolerance():
    from repro_torch.kernels import ops
    x = _x((4, 36864), 8)
    jk, tk = _unit_keys(4, 8)
    with reference() as ref:
        want = ref.ops.qsgd_compress_units(jnp.asarray(x), jk, 16,
                                           use_pallas=False)
    got = ops.qsgd_compress_units(torch.from_numpy(x), tk, 16)
    assert_qsgd_close(want, got, x, 16, axis=1)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", UNIT_SHAPES, ids=str)
def test_terngrad_compress_units_bitwise(shape, dtype):
    from repro_torch.kernels import ops
    jx, tx = _pair(_x(shape, 9), dtype)
    jk, tk = _unit_keys(shape[0], 9)
    with reference() as ref:
        want = ref.ops.terngrad_compress_units(jx, jk, use_pallas=True)
    assert_bitwise(want, ops.terngrad_compress_units(tx, tk))


def _tree(dyadic, seed=0):
    """A small tree with a layer-stacked leaf: numpy leaves."""
    return {"blocks": {"w": _x((4, 16, 32), seed, dyadic),
                       "b": _x((4, 40), seed + 1, dyadic)},
            "emb": _x((10, 8), seed + 2, dyadic),
            "head": _x((33,), seed + 3, dyadic)}


GRANULARITIES = [("layerwise", 65536), ("entire_model", 65536),
                 ("blockwise", 300)]


@pytest.mark.parametrize("kind", ["qsgd", "terngrad"])
@pytest.mark.parametrize("gran,block", GRANULARITIES,
                         ids=[g for g, _ in GRANULARITIES])
def test_plan_compress_bitwise(gran, block, kind):
    from repro_torch import random as R
    from repro_torch.convert import tree_leaves, tree_map
    from repro_torch.core.granularity import Granularity, stacked_mask
    from repro_torch.core.plan import build_plan
    from repro_torch.kernels import ops
    t = _tree(dyadic=kind == "qsgd")
    tt = tree_map(torch.from_numpy, t)
    with reference() as ref:
        jt = jax.tree_util.tree_map(jnp.asarray, t)
        jplan = ref.core.build_plan(jt, ref.core.stacked_mask(jt),
                                    ref.core.Granularity(gran, block))
        want = ref.ops.plan_compress(jplan, jt, jkey(5), kind=kind, levels=7)
    plan = build_plan(tt, stacked_mask(tt), Granularity(gran, block))
    got = ops.plan_compress(plan, tt, R.key(5), kind=kind, levels=7)
    for w, g in zip(jax.tree_util.tree_leaves(want), tree_leaves(got)):
        assert tuple(w.shape) == tuple(g.shape)
        assert_bitwise(w, g)
    with pytest.raises(ValueError, match="no bucket kernel"):
        ops.plan_compress(plan, tt, R.key(5), kind="nope")


# ---- plan flat <-> tree ------------------------------------------------------

@pytest.mark.parametrize("gran,block", GRANULARITIES,
                         ids=[g for g, _ in GRANULARITIES])
def test_plan_flatten_gather_scatter_match_reference(gran, block):
    from repro_torch.convert import tree_leaves, tree_map
    from repro_torch.core.granularity import Granularity, stacked_mask
    from repro_torch.core.plan import build_plan
    t = _tree(dyadic=False, seed=4)
    tt = tree_map(torch.from_numpy, t)
    plan = build_plan(tt, stacked_mask(tt), Granularity(gran, block))
    with reference() as ref:
        jt = jax.tree_util.tree_map(jnp.asarray, t)
        jplan = ref.core.build_plan(jt, ref.core.stacked_mask(jt),
                                    ref.core.Granularity(gran, block))
        jflat = jplan.flatten(jt)
        flat = plan.flatten(tt)
        assert_bitwise(jflat, flat)
        jout = jnp.zeros_like(jflat)
        out = torch.zeros_like(flat)
        for jb, b in zip(jplan.buckets, plan.buckets):
            jy = jplan.gather_bucket(jflat, jb)
            y = plan.gather_bucket(flat, b)
            assert_bitwise(jy, y)
            jout = jplan.scatter_bucket(jout, jb, -2.0 * jy)
            assert plan.scatter_bucket(out, b, -2.0 * y) is out
        assert_bitwise(jout, out)
        for w, g in zip(jax.tree_util.tree_leaves(jplan.unflatten(jout)),
                        tree_leaves(plan.unflatten(out))):
            assert tuple(w.shape) == tuple(g.shape)
            assert_bitwise(w, g)


# ---- routing ----------------------------------------------------------------

def test_compress_wrappers_route_cpu_tensors_to_plain_versions():
    from repro_torch import kernels, random as R
    from repro_torch.kernels import ops
    kernels.reset_launch_counts()
    x = torch.from_numpy(_x((3, 700), 0))
    keys = R.split(R.key(0), 3)
    assert ops.qsgd_compress(x, R.key(1), 16).shape == (3, 700)
    assert ops.terngrad_compress(x, R.key(1)).shape == (3, 700)
    assert ops.blockwise_topk(x, 5).shape == (3, 700)
    assert ops.qsgd_compress_units(x, keys, 16).shape == (3, 700)
    assert ops.terngrad_compress_units(x, keys).shape == (3, 700)
    assert ops.rmsnorm(x[:, :640].bfloat16(),
                       torch.ones(640)).dtype == torch.bfloat16
    assert all(v == 0 for v in kernels.launch_counts().values())
    assert set(kernels.launch_counts()) >= {
        "qsgd_compress_rows", "terngrad_compress_rows", "topk_mask",
        "rmsnorm"}


def test_compress_wrappers_reject_a_device_without_a_kernel():
    """Any device but the card (a kernel), the CPU (the plain version) and
    meta (the dry run's shape function) raises; this CPU build makes
    tensors on no other device, so the wrappers see XPU stand-ins."""
    import types
    from repro_torch.kernels.qsgd import qsgd_compress_rows
    from repro_torch.kernels.rmsnorm import rmsnorm
    from repro_torch.kernels.terngrad import terngrad_compress_rows
    from repro_torch.kernels.topk_mask import topk_mask
    x = s = k = types.SimpleNamespace(device=torch.device("xpu"),
                                      shape=(2, 512), dim=lambda: 2)
    calls = [lambda: qsgd_compress_rows(x, k, k, s, 512, 16),
             lambda: terngrad_compress_rows(x, k, k, s, 512),
             lambda: topk_mask(x, 5), lambda: rmsnorm(x, s)]
    for call in calls:
        with pytest.raises(ValueError, match="no kernel"):
            call()
