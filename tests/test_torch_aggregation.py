"""aggregate_simulated_workers (the paper's Algorithm 1 on n=4 simulated
workers) against the reference, bitwise, with and without error feedback
over 3 chained steps, on the sim path and the real-wire path.

Input families (the l2 norm is in the QSGD payload, and torch and jnp sum
squares in different orders, so QSGD is bitwise only where the norms are
equal):
  * TernGrad, signSGD, top-k, random-k: random normal gradients (no
    statistic, or an order-free max|x|).
  * QSGD: "norm-exact" gradients — every unit the compressor sees has
    entries in {0, ±1, ±2, ±w}·2^-3 with a sum of squares t² exactly
    representable, so both frameworks compute the same norm t·2^-3. Under
    error feedback the gradient of step k is chosen as e_k - m_{k-1}, so
    the encoded e = x + m is again norm-exact; that keeps every step
    bitwise while the residual m still threads through all three steps.
Random normal QSGD is held to the stated tolerance instead (see
test_qsgd_random_normal_tolerance).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_ref import jkey, reference, tkeys
from test_torch_wire import MIXED_SHAPES, _to_jax, _to_torch

N_WORKERS = 4
SCALE = np.float32(0.125)


def _port_plan(gran):
    from repro_torch.core.granularity import Granularity, stacked_mask
    from repro_torch.core.plan import build_plan
    tree = {k: ({kk: torch.zeros(s) for kk, s in v.items()}
                if isinstance(v, dict) else torch.zeros(v))
            for k, v in MIXED_SHAPES.items()}
    return build_plan(tree, stacked_mask(tree), Granularity(gran))


def _unflatten(plan, flat):
    """(n, total) numpy -> nested dict of (n, *shape) arrays (sorted
    leaves, the plan's flat order)."""
    from repro_torch.convert import tree_unflatten
    leaves, off = [], 0
    for shape in plan.leaf_shapes:
        size = math.prod(shape)
        leaves.append(flat[:, off:off + size].reshape((-1,) + shape))
        off += size
    return tree_unflatten(plan.paths, leaves)


def _flatten(plan, tree):
    from repro_torch.convert import tree_leaves
    return np.concatenate([np.asarray(l).reshape(N_WORKERS, -1)
                           for l in tree_leaves(tree)], axis=1)


def _norm_exact_flat(plan, rng) -> np.ndarray:
    """(n_workers, total) gradients whose every unit has an exactly
    representable l2 norm (see the module docstring)."""
    out = np.zeros((N_WORKERS, plan.total), np.float32)
    for wi in range(N_WORKERS):
        for off, d in zip(plan.unit_offsets, plan.exec_dims):
            t = max(1, int(math.isqrt(d)))
            w = int(rng.integers(0, t + 1))  # t^2 = c1 + 4 c2 + w^2
            rest = t * t - w * w             # <= d - 1 whenever w > 0
            c2 = int(rng.integers(0, rest // 4 + 1))
            c1 = rest - 4 * c2
            vals = np.zeros(d, np.float32)
            pos = rng.permutation(d)
            vals[pos[:c1]] = 1
            vals[pos[c1:c1 + c2]] = 2
            if w:
                vals[pos[c1 + c2]] = w
            vals *= rng.choice(np.float32([-1, 1]), d)
            out[wi, off:off + d] = vals * SCALE
    return out


def _normal_flat(plan, rng):
    return rng.standard_normal((N_WORKERS, plan.total)).astype(np.float32)


def _configs(ref, comp, gran, ef, fusion=None):
    from repro_torch.core.aggregation import CompressionConfig
    from repro_torch.core.compressors import make_compressor
    from repro_torch.core.granularity import Granularity
    kw = {"levels": 16} if comp == "qsgd" else {}
    mine = CompressionConfig(qw=make_compressor(comp, **kw),
                             granularity=Granularity(gran),
                             error_feedback=ef, fusion_bytes=fusion)
    theirs = ref.core.CompressionConfig(
        qw=ref.core.make_compressor(comp, **kw),
        granularity=ref.core.Granularity(gran), error_feedback=ef,
        fusion_bytes=fusion)
    return mine, theirs


def _bitwise(a: np.ndarray, b: np.ndarray):
    assert a.shape == b.shape
    assert np.array_equal(a.view(np.uint32), b.view(np.uint32)), \
        float(np.max(np.abs(a.astype(np.float64) - b)))


def _flat_mean(tree) -> np.ndarray:
    """Aggregated (worker-free) tree -> flat numpy, sorted-leaf order."""
    from repro_torch.convert import tree_leaves
    return np.concatenate([np.asarray(l).reshape(-1)
                           for l in tree_leaves(tree)])


@pytest.mark.parametrize("wire", [False, True])
@pytest.mark.parametrize("ef", [False, True])
@pytest.mark.parametrize("gran", ["layerwise", "entire_model"])
@pytest.mark.parametrize("comp", ["qsgd", "terngrad", "signsgd", "topk",
                                  "randomk"])
def test_aggregate_simulated_workers_bitwise(comp, gran, ef, wire):
    from repro_torch import random as R
    from repro_torch.core.aggregation import aggregate_simulated_workers
    from repro_torch.core.granularity import stacked_mask
    plan = _port_plan(gran)
    rng = np.random.default_rng(len(comp) * 10 + len(gran) + ef + 2 * wire)
    m_np = np.zeros((N_WORKERS, plan.total), np.float32)
    with reference() as ref:
        cfg, jcfg = _configs(ref, comp, gran, ef)
        jagg = jax.jit(lambda g, m, k: ref.core.aggregate_simulated_workers(
            g, ref.core.stacked_mask(g), jcfg, k, ef_state=m, wire=wire))
        for step in range(3):
            if comp == "qsgd":
                x_np = _norm_exact_flat(plan, rng) - m_np
            else:
                x_np = _normal_flat(plan, rng)
            wg, wm = _unflatten(plan, x_np), _unflatten(plan, m_np)
            tg = _to_torch(wg)
            out, new_m = aggregate_simulated_workers(
                tg, stacked_mask(tg), cfg, R.fold_in(R.key(8), step),
                ef_state=_to_torch(wm) if ef else None, wire=wire)
            jout, jnew_m = jagg(_to_jax(wg), _to_jax(wm) if ef else None,
                                jax.random.fold_in(jkey(8), step))
            _bitwise(_flat_mean(jout), _flat_mean(out))
            if ef:
                m_np = _flatten(plan, new_m)
                _bitwise(_flatten(plan, jnew_m), m_np)


@pytest.mark.parametrize("gran", ["layerwise", "entire_model"])
def test_master_compression_bitwise(gran):
    """A non-identity Q_M (TernGrad, order-free statistic) on the worker
    mean, keyed by fold_in(unit key, 0x5EED) as in the reference."""
    from repro_torch import random as R
    from repro_torch.core.aggregation import (CompressionConfig,
                                              aggregate_simulated_workers)
    from repro_torch.core.compressors import TernGrad
    from repro_torch.core.granularity import Granularity, stacked_mask
    plan = _port_plan(gran)
    wg = _unflatten(plan, _normal_flat(plan, np.random.default_rng(5)))
    tg = _to_torch(wg)
    cfg = CompressionConfig(qw=TernGrad(), qm=TernGrad(),
                            granularity=Granularity(gran))
    out, _ = aggregate_simulated_workers(tg, stacked_mask(tg), cfg,
                                         R.key(13), wire=True)
    with reference() as ref:
        jg = _to_jax(wg)
        jcfg = ref.core.CompressionConfig(
            qw=ref.core.TernGrad(), qm=ref.core.TernGrad(),
            granularity=ref.core.Granularity(gran))
        jout, _ = ref.core.aggregate_simulated_workers(
            jg, ref.core.stacked_mask(jg), jcfg, jkey(13), wire=True)
    _bitwise(_flat_mean(jout), _flat_mean(out))


@pytest.mark.parametrize("comp", ["qsgd", "terngrad", "signsgd", "natural",
                                  "topk", "randomk"])
@pytest.mark.parametrize("gran", ["layerwise", "entire_model"])
@pytest.mark.parametrize("fusion", [None, 0.0, 256.0, math.inf])
def test_port_wire_path_equals_sim_path(comp, gran, fusion):
    """Port-only: real wire buffers round-trip to the sim operator, bit for
    bit, on random normal gradients with error feedback."""
    from repro_torch import random as R
    from repro_torch.core.aggregation import (CompressionConfig,
                                              aggregate_simulated_workers)
    from repro_torch.core.compressors import make_compressor
    from repro_torch.core.granularity import Granularity, stacked_mask
    plan = _port_plan(gran)
    rng = np.random.default_rng(3)
    cfg = CompressionConfig(qw=make_compressor(comp),
                            granularity=Granularity(gran),
                            error_feedback=True, fusion_bytes=fusion)
    tg = _to_torch(_unflatten(plan, _normal_flat(plan, rng)))
    tm = _to_torch(_unflatten(plan, 0.1 * _normal_flat(plan, rng)))
    runs = [aggregate_simulated_workers(tg, stacked_mask(tg), cfg,
                                        R.key(21), ef_state=tm, wire=wire)
            for wire in (True, False)]
    _bitwise(_flat_mean(runs[0][0]), _flat_mean(runs[1][0]))
    _bitwise(_flatten(plan, runs[0][1]), _flatten(plan, runs[1][1]))


@pytest.mark.parametrize("comp", ["threshold_v", "adaptive_threshold"])
def test_thresholds_refuse_the_simulated_wire_path(comp):
    """Capacity-bounded threshold records are not sim-exact, so wire=True
    under strategy='simulated' raises the reference's ValueError; the sim
    path runs."""
    from repro_torch import random as R
    from repro_torch.core.aggregation import aggregate_simulated_workers
    from repro_torch.core.granularity import stacked_mask
    plan = _port_plan("layerwise")
    wg = _unflatten(plan, _normal_flat(plan, np.random.default_rng(1)))
    tg = _to_torch(wg)
    with reference() as ref:
        cfg, jcfg = _configs(ref, comp, "layerwise", False)
        jg = _to_jax(wg)
        with pytest.raises(ValueError) as jerr:
            ref.core.aggregate_simulated_workers(
                jg, ref.core.stacked_mask(jg), jcfg, jkey(0), wire=True)
        with pytest.raises(ValueError) as err:
            aggregate_simulated_workers(tg, stacked_mask(tg), cfg, R.key(0),
                                        wire=True)
        assert str(err.value) == str(jerr.value)
        jout, _ = ref.core.aggregate_simulated_workers(
            jg, ref.core.stacked_mask(jg), jcfg, jkey(0))
        out, _ = aggregate_simulated_workers(tg, stacked_mask(tg), cfg,
                                             R.key(0))
        _bitwise(_flat_mean(jout), _flat_mean(out))


@pytest.mark.parametrize("d", [2304, 121002])
def test_qsgd_random_normal_tolerance(d):
    """Stated tolerance for QSGD on arbitrary inputs: the unit norm is a
    sum in a framework-specific order (torch vs jnp differ by ulps), and it
    scales every code. Norms agree to 1e-4 relative; at most 0.1% of the
    codes differ, each by one level."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.qsgd import unpack_codes_plain
    rng = np.random.default_rng(d)
    x = rng.standard_normal((4, d)).astype(np.float32)
    keys = rng.integers(0, 2**32, (4, 2), dtype=np.uint64).astype(np.uint32)
    w, nrm = ops.qsgd_pack_units(torch.from_numpy(x), tkeys(keys), 16, 6)
    with reference() as ref:
        jw, jn = ref.ops.qsgd_pack_units(jnp.asarray(x), jnp.asarray(keys),
                                         16, 6, use_pallas=False)
    np.testing.assert_allclose(nrm.numpy(), np.asarray(jn), rtol=1e-4)
    mine = unpack_codes_plain(w, d, 6).numpy()
    theirs = unpack_codes_plain(
        torch.from_numpy(np.array(jw).view(np.int32)), d, 6).numpy()
    diff = np.abs(mine - theirs)
    assert diff.max() <= 1
    assert (diff != 0).mean() <= 1e-3
