"""The port's granularity API against the JAX package's
core/granularity.py:88-231: num_units, apply_unitwise and
apply_unitwise_with_state (through the UnitPlan) and the per-leaf oracles
apply_unitwise_reference / apply_unitwise_with_state_reference, at the
paper's three granularities, for QSGD, top-k and signSGD `sim` (QSGD on
dyadic inputs, whose l2 norms are exact in any summation order). All
bitwise. The port's fn is batched, fn(x2d, keys2d); the reference's
fn(x, key) is the same map on one unit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_compress import GRANULARITIES, _tree, assert_bitwise
from test_torch_ref import jkey, reference

COMPRESSORS = [("qsgd", {"levels": 16}), ("topk", {"ratio": 0.1}),
               ("signsgd", {})]


def _trees(ref, seed):
    from repro_torch.convert import tree_map
    t = _tree(dyadic=True, seed=seed)
    return jax.tree_util.tree_map(jnp.asarray, t), tree_map(torch.from_numpy,
                                                            t)


def _assert_trees_bitwise(jt, tt):
    from repro_torch.convert import tree_leaves
    for w, g in zip(jax.tree_util.tree_leaves(jt), tree_leaves(tt)):
        assert tuple(w.shape) == tuple(g.shape)
        assert_bitwise(w, g)


def _ef(sim):
    """Error feedback around a batched sim: (x + m) -> (Q, x + m - Q)."""
    def fn(x, m, k):
        e = x + m
        q = sim(e, k)
        return q, e - q
    return fn


@pytest.mark.parametrize("name,kw", COMPRESSORS, ids=[c for c, _ in
                                                      COMPRESSORS])
@pytest.mark.parametrize("gran,block", GRANULARITIES,
                         ids=[g for g, _ in GRANULARITIES])
def test_apply_unitwise_matches_reference(gran, block, name, kw):
    from repro_torch import random as R
    from repro_torch.core import granularity as G
    from repro_torch.core.compressors import make_compressor
    comp = make_compressor(name, **kw)
    with reference() as ref:
        jt, tt = _trees(ref, 1)
        jg = ref.core.Granularity(gran, block)
        jsm = ref.core.stacked_mask(jt)
        jcomp = ref.core.make_compressor(name, **kw)
        want = ref.granularity.apply_unitwise(
            lambda v, k: jcomp.sim(v, k), jg, jt, jsm, jkey(3))
        gr = G.Granularity(gran, block)
        sm = G.stacked_mask(tt)
        assert G.num_units(tt, sm, gr) == ref.granularity.num_units(jt, jsm,
                                                                    jg)
        got = G.apply_unitwise(comp.sim, gr, tt, sm, R.key(3))
        _assert_trees_bitwise(want, got)
        _assert_trees_bitwise(want, G.apply_unitwise_reference(
            comp.sim, gr, tt, sm, R.key(3)))


@pytest.mark.parametrize("name,kw", COMPRESSORS, ids=[c for c, _ in
                                                      COMPRESSORS])
@pytest.mark.parametrize("gran,block", GRANULARITIES,
                         ids=[g for g, _ in GRANULARITIES])
def test_apply_unitwise_with_state_matches_reference(gran, block, name, kw):
    from repro_torch import random as R
    from repro_torch.convert import tree_map
    from repro_torch.core import granularity as G
    from repro_torch.core.compressors import make_compressor
    comp = make_compressor(name, **kw)
    with reference() as ref:
        jt, tt = _trees(ref, 2)
        jm, tm = _trees(ref, 7)
        jm = jax.tree_util.tree_map(lambda a: 0.25 * a, jm)
        tm = tree_map(lambda a: 0.25 * a, tm)
        jg = ref.core.Granularity(gran, block)
        jcomp = ref.core.make_compressor(name, **kw)
        want_y, want_m = ref.granularity.apply_unitwise_with_state(
            _ef(jcomp.sim), jg, jt, jm, ref.core.stacked_mask(jt), jkey(4))
        gr = G.Granularity(gran, block)
        sm = G.stacked_mask(tt)
        for run in (G.apply_unitwise_with_state,
                    G.apply_unitwise_with_state_reference):
            y, m = run(_ef(comp.sim), gr, tt, tm, sm, R.key(4))
            _assert_trees_bitwise(want_y, y)
            _assert_trees_bitwise(want_m, m)


def test_apply_unitwise_reuses_a_given_plan():
    from repro_torch import random as R
    from repro_torch.core import granularity as G
    from repro_torch.core.compressors import SignSGD
    from repro_torch.core.plan import build_plan
    from repro_torch.convert import tree_map
    tt = tree_map(torch.from_numpy, _tree(dyadic=False, seed=3))
    sm = G.stacked_mask(tt)
    gr = G.Granularity("layerwise")
    plan = build_plan(tt, sm, gr)
    calls = []

    def fn(x, k):
        calls.append(x.shape)
        return SignSGD().sim(x, k)
    a = G.apply_unitwise(fn, gr, tt, sm, R.key(0), plan=plan)
    assert len(calls) == plan.num_dispatches
    b = G.apply_unitwise_reference(SignSGD().sim, gr, tt, sm, R.key(0))
    _assert_trees_bitwise_torch(a, b)


def _assert_trees_bitwise_torch(a, b):
    from repro_torch.convert import tree_leaves
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert x.dtype == y.dtype and torch.equal(x.view(torch.int32),
                                                  y.view(torch.int32))
