"""The port's core/theory.py against the JAX package's core/theory.py.

Closed-form bounds (trace_A, entire_model_bound, layerwise_tighter,
noise_bounds_from_plan) are Python float arithmetic on the same omegas and
dims, so they are held EQUAL. The Monte-Carlo estimates (empirical_omega,
empirical_descent_alignment, check_unbiasedness, lemma1_check) draw the
same keys and the compressors' sim gives the same numbers (QSGD on dyadic
inputs), but torch and jnp sum over the trials in other orders: within
1e-5 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_compress import DYADIC
from test_torch_ref import _resnet9_pair, jkey, reference

OPERATORS = [("qsgd", {"levels": 4}), ("terngrad", {}),
             ("randomk", {"ratio": 0.25})]


def _vec(d, seed, dyadic):
    rng = np.random.default_rng(seed)
    if dyadic:
        return rng.choice(DYADIC, d)
    return rng.standard_normal(d).astype(np.float32)


def _close(want, got):
    assert got == pytest.approx(float(want), rel=1e-5, abs=1e-12)


@pytest.mark.parametrize("gran", ["layerwise", "entire_model", "blockwise"])
def test_noise_bounds_from_plan_equal_on_resnet9(gran):
    from repro_torch.core import theory
    from repro_torch.core.compressors import QSGD, TernGrad
    from repro_torch.core.granularity import Granularity, stacked_mask
    from repro_torch.core.plan import build_plan
    with reference() as ref:
        jp, tp = _resnet9_pair(ref)
        jplan = ref.core.build_plan(jp, ref.core.stacked_mask(jp),
                                    ref.core.Granularity(gran))
        plan = build_plan(tp, stacked_mask(tp), Granularity(gran))
        for w, m in ((16, None), (16, 4), (2, 64)):
            want = ref.theory.noise_bounds_from_plan(
                jplan, ref.core.make_compressor("qsgd", levels=w),
                None if m is None else ref.core.make_compressor(
                    "qsgd", levels=m))
            got = theory.noise_bounds_from_plan(
                plan, QSGD(levels=w), None if m is None else QSGD(levels=m))
            assert got == want
        measured = [0.5 + 0.25 * i for i in range(plan.num_units)]
        assert theory.noise_bounds_from_plan(
            plan, measured_w=measured, measured_m=measured[::-1]) == \
            ref.theory.noise_bounds_from_plan(
                jplan, measured_w=measured, measured_m=measured[::-1])
        with pytest.raises(ValueError, match="closed-form"):
            theory.noise_bounds_from_plan(plan, TernGrad())
        with pytest.raises(ValueError, match="comp_w or measured_w"):
            theory.noise_bounds_from_plan(plan)
        with pytest.raises(ValueError, match="omegas, plan has"):
            theory.noise_bounds_from_plan(plan, measured_w=[1.0] * 99)


def test_noise_bounds_from_plan_equal_on_a_stacked_tree():
    from repro_torch.core import theory
    from repro_torch.core.compressors import QSGD
    from repro_torch.core.granularity import Granularity, stacked_mask
    from repro_torch.core.plan import build_plan
    shapes = {"blocks": {"w": (3, 40, 5), "b": (3, 5)}, "head": (700,)}
    tt = {"blocks": {"w": torch.zeros(3, 40, 5), "b": torch.zeros(3, 5)},
          "head": torch.zeros(700)}
    with reference() as ref:
        jt = jax.tree_util.tree_map(lambda s: jnp.zeros(s), shapes,
                                    is_leaf=lambda s: isinstance(s, tuple))
        for gran, block in (("layerwise", 0), ("entire_model", 0),
                            ("blockwise", 64)):
            kw = {"block_size": block} if block else {}
            jplan = ref.core.build_plan(jt, ref.core.stacked_mask(jt),
                                        ref.core.Granularity(gran, **kw))
            plan = build_plan(tt, stacked_mask(tt), Granularity(gran, **kw))
            want = ref.theory.noise_bounds_from_plan(
                jplan, ref.core.make_compressor("qsgd", levels=3),
                ref.core.make_compressor("qsgd", levels=8))
            got = theory.noise_bounds_from_plan(plan, QSGD(levels=3),
                                                QSGD(levels=8))
            assert got == want
            assert got[0] <= got[1]


def test_closed_form_bounds_equal():
    from repro_torch.core import theory
    with reference() as ref:
        rng = np.random.default_rng(0)
        for L in (1, 3, 14):
            ow = rng.uniform(0, 50, L).tolist()
            om = rng.uniform(0, 5, L).tolist()
            dims = rng.integers(1, 40000, L).tolist()
            for f in ("trace_A", "entire_model_bound", "layerwise_tighter"):
                assert getattr(theory, f)(ow, om, dims) == getattr(
                    ref.theory, f)(ow, om, dims), f
            assert theory.layerwise_tighter(ow, om, dims)


@pytest.mark.parametrize("name,kw", OPERATORS, ids=[n for n, _ in OPERATORS])
def test_monte_carlo_estimates_match_reference(name, kw):
    from repro_torch import random as R
    from repro_torch.core import theory
    from repro_torch.core.compressors import make_compressor
    x = _vec(700, 1, dyadic=name == "qsgd")
    comp = make_compressor(name, **kw)
    with reference() as ref:
        jcomp = ref.core.make_compressor(name, **kw)
        jx, tx = jnp.asarray(x), torch.from_numpy(x)
        _close(ref.theory.empirical_omega(jcomp, jx, jkey(2), 64),
               theory.empirical_omega(comp, tx, R.key(2), 64))
        _close(ref.theory.empirical_descent_alignment(jcomp, jx, jkey(3),
                                                      64),
               theory.empirical_descent_alignment(comp, tx, R.key(3), 64))
        _close(ref.theory.check_unbiasedness(jcomp, jx, jkey(4), 128),
               theory.check_unbiasedness(comp, tx, R.key(4), 128))


@pytest.mark.parametrize("name,kw", OPERATORS, ids=[n for n, _ in OPERATORS])
def test_lemma1_check_matches_reference(name, kw):
    from repro_torch import random as R
    from repro_torch.core import theory
    from repro_torch.core.compressors import make_compressor
    parts = [_vec(64 * (j + 1), 10 + j, dyadic=name == "qsgd")
             for j in range(4)]
    with reference() as ref:
        want = ref.theory.lemma1_check(
            ref.core.make_compressor(name, **kw),
            [jnp.asarray(p) for p in parts], jkey(3), trials=48)
        got = theory.lemma1_check(make_compressor(name, **kw),
                                  [torch.from_numpy(p) for p in parts],
                                  R.key(3), trials=48)
    for w, g in zip(want, got):
        _close(w, g)
    lhs, mid, rhs = got
    assert lhs <= mid * 1.15 and mid <= rhs + 1e-6     # Lemma 1
