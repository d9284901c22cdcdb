"""The port's adaptive compression controller (control/: telemetry,
policies, the decision -> step cache; engine_controller and the train
CLI's --policy) against the JAX package's control/ on the CPU
(tests/test_control.py's cases, each held against the reference).

Inputs are made with numpy from a seed and handed to both packages.

Bitwise: CompressionDecision round trips, hashing and describe();
PerDimRatio's resolution per dimension and its payload bits;
payload_bits_per_step against comm_report; every policy's decision on the
SAME summary dict (the reference's, so a decision cannot flip on a
summation order); FusionPolicy's threshold; Controller.builds and its
switches over the same decision sequence; the wire step with a
per-dimension top-k decision against its simulated step; the identity
compressor's exact zeros.

Stated tolerance (ROADMAP Queue 3 item 16): the port sums squares in
torch's order, the reference in XLA's, so every TelemetryState field and
every number of summarize() / the controller's JSON export agree within
1e-5 relative (exact zeros exactly, an omega_hat as its ratio 1 +
omega_hat; the largest seen in each docstring).

The Engine cases (tests/test_control.py:444-539: mamba2 smoke, one
device, QSGD(16) layerwise, the default SGD at lr 0.1) and the train
CLI's --policy run in ONE run_ranks spawn of two gloo CPU ranks, started
with the module beside a reference subprocess that writes its init
params first: rank 0 runs the Engine cases on a one-rank group, their
steps from those params (params_from_jax), then both ranks run the CLI's
rank loop. Losses and params hold Queue 3 item 15's rules.

This module imports no jax at module level: the spawned rank imports it.
"""
import dataclasses
import json
import math
import os
import pathlib
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
REL = 1e-5
STEPS = 2
ENGINE_LR = 0.1          # OptConfig's default (plain SGD)
LEVELS = 16
REF_TIMEOUT = 600.0
RANK_TIMEOUT = 300.0
REF_CONTROL = ("repro.control", "repro.core.bits", "repro.core.schedule")
CLI_RANKS = 2
CLI = ["--arch", "llama3-405b", "--smoke", "--steps", "4", "--data",
       str(CLI_RANKS), "--device", "cpu", "--backend", "gloo", "--batch",
       "8", "--seq", "16", "--compressor", "topk", "--ratio", "0.1",
       "--policy", "granularity_switch", "--replan-every", "2"]


def _reference():
    from test_torch_ref import reference
    return reference(*REF_CONTROL)


# ---- inputs -------------------------------------------------------------------

def _tree_np(seed=0, dyadic=False):
    """test_control.py's _tree shapes: a stacked (3, 16, 8) block and two
    loose leaves. `dyadic` draws entries of {0, +-1/8, +-1/4}, whose sums
    of squares are exact in any order (QSGD's norms then agree)."""
    rng = np.random.default_rng(seed)

    def draw(*shape):
        if dyadic:
            return rng.choice(np.float32([-0.25, -0.125, 0, 0.125, 0.25]),
                              shape)
        return rng.standard_normal(shape).astype(np.float32)
    return {"blocks": {"w": draw(3, 16, 8)}, "embed": draw(20, 4),
            "head": draw(16, 4)}


def _switch_tree_np(seed=0):
    """test_control.py's _switch_tree: a spiky leaf (global top-k captures
    it) and a pure-noise leaf of another size."""
    spiky = np.zeros((512,), np.float32)
    spiky[:8] = 100.0
    noise = (0.1 * np.random.default_rng(seed).standard_normal(448)
             ).astype(np.float32)
    return {"spiky": spiky, "noise": noise}


def _energy_split_tree_np(seed=0):
    rng = np.random.default_rng(seed)
    return {"hot": (10.0 * rng.standard_normal(512)).astype(np.float32),
            "cold": (0.01 * rng.standard_normal(448)).astype(np.float32)}


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _jax(tree):
    import jax.numpy as jnp
    if isinstance(tree, dict):
        return {k: _jax(v) for k, v in tree.items()}
    return jnp.asarray(tree)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _fields_close(got, want, rel=REL, what=""):
    """Every field of two TelemetryStates within rel of the reference's
    (exact zeros exactly) -> the largest relative error seen."""
    worst = 0.0
    assert got._fields == want._fields
    for name, g, w in zip(got._fields, got, want):
        g, w = _np(g).astype(np.float64), np.asarray(w, np.float64)
        assert g.shape == w.shape, (what, name)
        zero = w == 0
        assert np.array_equal(g[zero], w[zero]), (what, name)
        err = np.abs(g - w)[~zero] / np.abs(w[~zero])
        if err.size:
            assert err.max() <= rel, (what, name, float(err.max()))
            worst = max(worst, float(err.max()))
    return worst


def _json_close(got, want, rel=REL, path=""):
    """Two JSON-like values: same keys and strings, equal ints, floats
    within rel relative. An omega_hat (E|Q(x)|^2 / |x|^2 - 1, a difference
    that cancels near 0) is held as its ratio 1 + omega_hat."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _json_close(got[k], want[k], rel, f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _json_close(g, w, rel, f"{path}/{i}")
    elif isinstance(want, float) and not isinstance(want, bool):
        assert isinstance(got, float), path
        if path.endswith("omega_hat"):
            got, want = 1.0 + got, 1.0 + want
        assert abs(got - want) <= rel * max(abs(want), 1e-30) or (
            abs(want) < 1e-12 and abs(got) < 1e-12), (path, got, want)
    else:
        assert got == want, (path, got, want)


def _port_summary(qw, tree_np=None):
    from repro_torch import random as R
    from repro_torch.control import (accumulate, init_telemetry, measure,
                                     measurement_plan, summarize)
    from repro_torch.core import stacked_mask
    t = _torch(tree_np if tree_np is not None else _tree_np())
    mplan = measurement_plan(t, stacked_mask(t))
    inc = measure(mplan, qw, t, R.key(0))
    return summarize(accumulate(init_telemetry(mplan), inc), mplan,
                     qw=qw), mplan


def _ref_summary(ref, qw, tree_np=None):
    import jax
    t = _jax(tree_np if tree_np is not None else _tree_np())
    c = ref.control
    mplan = c.measurement_plan(t, ref.core.stacked_mask(t))
    inc = jax.jit(lambda g, k: c.measure(mplan, qw, g, k))(
        t, jax.random.key(0))
    return c.summarize(c.accumulate(c.init_telemetry(mplan), inc), mplan,
                       qw=qw), mplan


def _decision_key(d):
    """What a decision decides, comparable across the packages."""
    qw = d.qw
    return (d.granularity.kind, d.granularity.block_size, qw.name,
            getattr(qw, "ratio", None), d.strategy, d.error_feedback,
            d.wire_dtype, tuple(d.ratio_overrides), d.fusion_bytes,
            d.describe())


# ---- telemetry ------------------------------------------------------------------

def test_telemetry_identity_is_lossless():
    """Identity: every bucket's Omega_hat and relative error exactly 0 (and
    the reference's too), JSON-exportable."""
    from repro_torch.core import Identity
    s, _ = _port_summary(Identity())
    with _reference() as ref:
        rs, _ = _ref_summary(ref, ref.core.Identity())
    assert s["steps"] == 1.0
    for b, rb in zip(s["buckets"], rs["buckets"]):
        assert b["omega_hat"] == 0.0 and b["rel_err"] == 0.0
        assert rb["omega_hat"] == 0.0 and rb["rel_err"] == 0.0
    assert s["entire_model"]["rel_err"] == 0.0
    assert rs["entire_model"]["rel_err"] == 0.0
    json.dumps(s)
    _json_close(s, rs)


MEASURE_CASES = {
    "topk": ("topk", {"ratio": 0.1}, False),
    "randomk": ("randomk", {"ratio": 0.25}, False),
    "qsgd_dyadic": ("qsgd", {"levels": 8}, True),
    "signsgd": ("signsgd", {}, False),
}


@pytest.mark.parametrize("case", list(MEASURE_CASES))
def test_measure_matches_reference(case):
    """measure() on the same tree and key, with the aggregate leg and the
    entire-model leg, 3 steps accumulated (the reference's jitted):
    every field within 1e-5 relative (seen 1.8e-7), summarize() and
    unit_omegas too; entire_model=False leaves the em_* fields exactly
    zero on both sides."""
    import jax
    from repro_torch import random as R
    from repro_torch.control import (accumulate, init_telemetry, measure,
                                     measurement_plan, summarize,
                                     unit_omegas)
    from repro_torch.core import make_compressor, stacked_mask
    name, kw, dyadic = MEASURE_CASES[case]
    tree, hat = _tree_np(0, dyadic), _tree_np(1, dyadic)
    t, th = _torch(tree), _torch(hat)
    qw = make_compressor(name, **kw)
    mplan = measurement_plan(t, stacked_mask(t))
    st = init_telemetry(mplan)
    for i in range(3):
        st = accumulate(st, measure(mplan, qw, t, R.fold_in(R.key(0), i),
                                    grads_hat=th))
    no_em = measure(mplan, qw, t, R.key(0), entire_model=False)
    with _reference() as ref:
        c = ref.control
        jt, jh = _jax(tree), _jax(hat)
        jqw = ref.core.make_compressor(name, **kw)
        jplan = c.measurement_plan(jt, ref.core.stacked_mask(jt))
        inc = jax.jit(lambda g, h, k: c.measure(jplan, jqw, g, k,
                                                grads_hat=h))
        jst = c.init_telemetry(jplan)
        for i in range(3):
            jst = c.accumulate(jst, inc(jt, jh, jax.random.fold_in(
                jax.random.key(0), i)))
        want = c.TelemetryState(*(np.asarray(v) for v in jst))
        jno = c.measure(jplan, jqw, jt, jax.random.key(0),
                        entire_model=False)
        rs = c.summarize(jst, jplan, qw=jqw)
        romega = c.unit_omegas(rs, jplan)
    _fields_close(st, want, what=case)
    assert float(no_em.em_sumsq) == 0.0 == float(jno.em_sumsq)
    assert float(no_em.em_errsq) == 0.0 == float(jno.em_errsq)
    s = summarize(st, mplan, qw=qw)
    _json_close(s, rs)
    np.testing.assert_allclose(unit_omegas(s, mplan), romega, rtol=REL)


def test_telemetry_entire_model_leg_is_gated():
    """entire_model=False: em_* zero, summarize omits the block, and
    GranularitySwitchPolicy keeps the current decision (both packages)."""
    from repro_torch import random as R
    from repro_torch.control import (BitBudgetPolicy, CompressionDecision,
                                     GranularitySwitchPolicy,
                                     VarianceBudgetPolicy, accumulate,
                                     init_telemetry, measure,
                                     measurement_plan, summarize)
    from repro_torch.core import make_compressor, stacked_mask
    t = _torch(_tree_np())
    mplan = measurement_plan(t, stacked_mask(t))
    qw = make_compressor("topk", ratio=0.1)
    inc = measure(mplan, qw, t, R.key(0), entire_model=False)
    assert float(inc.em_sumsq) == 0.0 and float(inc.em_errsq) == 0.0
    s = summarize(accumulate(init_telemetry(mplan), inc), mplan, qw=qw)
    assert not s.get("entire_model")
    base = CompressionDecision(qw=qw)
    assert GranularitySwitchPolicy().decide(s, base, mplan) == base
    assert VarianceBudgetPolicy().needs_entire_model is False
    assert BitBudgetPolicy().needs_entire_model is False
    assert GranularitySwitchPolicy().needs_entire_model is True


def test_telemetry_payload_bits_match_comm_report():
    """payload_bits_per_step (bucket-wise) equals comm_report's per-unit
    walk, analytic and measured, for a plain config and a decision with
    per-bucket ratio overrides, and equals the reference's numbers."""
    from repro_torch.control import (CompressionDecision,
                                     payload_bits_per_step, measurement_plan)
    from repro_torch.core import (CompressionConfig, Granularity,
                                  comm_report, make_compressor, stacked_mask)
    t = _torch(_tree_np())
    mplan = measurement_plan(t, stacked_mask(t))
    qw = make_compressor("topk", ratio=0.1)
    cfg = CompressionConfig(qw=qw, granularity=Granularity("layerwise"),
                            strategy="allgather")
    dec = CompressionDecision(qw=qw, granularity=Granularity("layerwise"),
                              strategy="allgather",
                              ratio_overrides=((8, 0.5), (128, 0.02)))
    got = [payload_bits_per_step(mplan, qw, measured=False),
           comm_report(cfg, mplan, 4).uplink_bits_per_worker,
           payload_bits_per_step(mplan, qw),
           comm_report(cfg, mplan, 4, measured=True).uplink_bits_per_worker,
           payload_bits_per_step(mplan, dec.to_config().qw, measured=False),
           payload_bits_per_step(mplan, dec.to_config().qw),
           comm_report(dec, mplan, 4).uplink_bits_per_worker,
           dec.payload_bits(mplan.unit_dims)]
    assert got[0] == got[1] and got[2] == got[3]
    assert got[4] == got[6] == got[7] != got[1]
    with _reference() as ref:
        c, core = ref.control, ref.core
        jt = _jax(_tree_np())
        jplan = c.measurement_plan(jt, core.stacked_mask(jt))
        jqw = core.make_compressor("topk", ratio=0.1)
        jcfg = core.CompressionConfig(qw=jqw, strategy="allgather",
                                      granularity=core.Granularity(
                                          "layerwise"))
        jdec = c.CompressionDecision(
            qw=jqw, granularity=core.Granularity("layerwise"),
            strategy="allgather", ratio_overrides=((8, 0.5), (128, 0.02)))
        bits = ref.bits
        want = [c.payload_bits_per_step(jplan, jqw, measured=False),
                bits.comm_report(jcfg, jplan, 4).uplink_bits_per_worker,
                c.payload_bits_per_step(jplan, jqw),
                bits.comm_report(jcfg, jplan, 4,
                                 measured=True).uplink_bits_per_worker,
                c.payload_bits_per_step(jplan, jdec.to_config().qw,
                                        measured=False),
                c.payload_bits_per_step(jplan, jdec.to_config().qw),
                bits.comm_report(jdec, jplan, 4).uplink_bits_per_worker,
                jdec.payload_bits(jplan.unit_dims)]
    assert got == want


def test_aggregation_telemetry_wiring():
    """aggregate_simulated_workers with a telemetry_plan returns the same
    aggregate (bitwise) plus an increment; the increment is the
    reference's within 1e-5 relative (QSGD(16) on norm-exact inputs)."""
    import jax
    from repro_torch import random as R
    from repro_torch.control import measurement_plan
    from repro_torch.core import (CompressionConfig, Granularity,
                                  aggregate_simulated_workers,
                                  make_compressor, stacked_mask)
    tree = _tree_np(0, dyadic=True)
    wg_np = {k: (np.stack([v, 2 * v]) if not isinstance(v, dict) else
                 {kk: np.stack([vv, 2 * vv]) for kk, vv in v.items()})
             for k, v in tree.items()}
    t, wg = _torch(tree), _torch(wg_np)
    sm = stacked_mask(t)
    mplan = measurement_plan(t, sm)
    cfg = CompressionConfig(qw=make_compressor("qsgd", levels=16),
                            granularity=Granularity("layerwise"))
    a, _ = aggregate_simulated_workers(wg, sm, cfg, R.key(0))
    b, _, inc = aggregate_simulated_workers(wg, sm, cfg, R.key(0),
                                            telemetry_plan=mplan)
    for k in ("embed", "head"):
        assert torch.equal(a[k], b[k])
    assert torch.equal(a["blocks"]["w"], b["blocks"]["w"])
    assert float(inc.steps) == 1.0
    with _reference() as ref:
        c, core = ref.control, ref.core
        jt = _jax(tree)
        jsm = core.stacked_mask(jt)
        jplan = c.measurement_plan(jt, jsm)
        jcfg = core.CompressionConfig(
            qw=core.make_compressor("qsgd", levels=16),
            granularity=core.Granularity("layerwise"))
        _, _, jinc = jax.jit(lambda g, k: core.aggregate_simulated_workers(
            g, jsm, jcfg, k, telemetry_plan=jplan))(_jax(wg_np),
                                                    jax.random.key(0))
        want = c.TelemetryState(*(np.asarray(v) for v in jinc))
    _fields_close(inc, want, what="aggregate")


# ---- decisions ------------------------------------------------------------------

def test_decision_roundtrip_and_hashability():
    from repro_torch.control import CompressionDecision, PerDimRatio
    from repro_torch.core import Granularity, make_compressor
    d = CompressionDecision(qw=make_compressor("topk", ratio=0.05),
                            granularity=Granularity("entire_model"),
                            ratio_overrides=((128, 0.5),),
                            fusion_bytes=math.inf)
    cfg = d.to_config()
    assert isinstance(cfg.qw, PerDimRatio)
    assert cfg.qw.for_dim(128).ratio == 0.5
    assert cfg.qw.for_dim(64).ratio == 0.05
    assert CompressionDecision.from_config(cfg) == d
    assert len({d, d, CompressionDecision.from_config(cfg)}) == 1
    with _reference() as ref:
        c, core = ref.control, ref.core
        jd = c.CompressionDecision(
            qw=core.make_compressor("topk", ratio=0.05),
            granularity=core.Granularity("entire_model"),
            ratio_overrides=((128, 0.5),), fusion_bytes=math.inf)
        want = _decision_key(c.CompressionDecision.from_config(
            jd.to_config()))
        want_name = jd.to_config().qw.name
    assert _decision_key(CompressionDecision.from_config(cfg)) == want
    assert cfg.qw.name == want_name == "topk[adaptive]"


def test_per_dim_ratio_compressor_semantics():
    """PerDimRatio resolves its ratio per unit dimension: sim bitwise the
    reference's per dim, payload bits equal."""
    import jax
    from repro_torch import random as R
    from repro_torch.control import PerDimRatio
    from repro_torch.core import make_compressor
    c = PerDimRatio(base=make_compressor("topk", ratio=0.5),
                    table=((8, 0.25),))
    x = torch.arange(8.0)[None]
    assert int((c.sim(x, R.key(0)[None]) != 0).sum()) == 2
    y = (torch.arange(16.0) + 1.0)[None]
    assert int((c.sim(y, R.key(0)[None]) != 0).sum()) == 8
    assert c.payload_bits(8) == 2 * 35 and c.payload_bits(16) == 8 * 36
    rng = np.random.default_rng(3)
    rows = rng.standard_normal((5, 8)).astype(np.float32)
    with _reference() as ref:
        jc = ref.control.PerDimRatio(
            base=ref.core.make_compressor("topk", ratio=0.5),
            table=((8, 0.25),))
        want = np.stack([np.asarray(jc.sim(r, jax.random.key(0)))
                         for r in rows])
        wbits = [jc.payload_bits(d) for d in (8, 16, 100)]
        wname = jc.name
    got = c.sim(torch.from_numpy(rows), R.key(0)[None].expand(5, 2))
    assert got.numpy().tobytes() == want.tobytes()
    assert [c.payload_bits(d) for d in (8, 16, 100)] == wbits
    assert c.name == wname


def test_shared_random_decision_ignores_ratio_overrides():
    from repro_torch.control import (BitBudgetPolicy, CompressionDecision,
                                     VarianceBudgetPolicy)
    from repro_torch.core import RandomK, make_compressor
    qw = make_compressor("randomk", ratio=0.1)
    d = CompressionDecision(qw=qw, strategy="shared_random",
                            ratio_overrides=((128, 0.5),))
    assert isinstance(d.to_config().qw, RandomK)
    summary, mplan = _port_summary(qw)
    base = CompressionDecision(qw=qw, strategy="shared_random")
    assert VarianceBudgetPolicy(budget=0.01).decide(summary, base,
                                                    mplan) == base
    assert BitBudgetPolicy(bits_per_step=1 << 20).decide(summary, base,
                                                         mplan) == base


def test_noise_bounds_from_plan_measured():
    from repro_torch.control import measurement_plan
    from repro_torch.core import make_compressor, stacked_mask
    from repro_torch.core.theory import noise_bounds_from_plan
    t = _torch(_tree_np())
    mplan = measurement_plan(t, stacked_mask(t))
    n = mplan.num_units
    tr, em = noise_bounds_from_plan(mplan, measured_w=[0.5] * n)
    assert tr == pytest.approx(1.5 * mplan.total)
    assert em == pytest.approx(1.5 * mplan.total)
    with pytest.raises(ValueError):
        noise_bounds_from_plan(mplan, measured_w=[0.5] * (n + 1))
    with pytest.raises(ValueError):
        noise_bounds_from_plan(mplan, make_compressor("signsgd"))


# ---- policies: the same summary in, the same decision out ------------------------

def _policy_pairs(ref):
    """(port policy, reference policy) of every policy and knob the
    reference's tests use."""
    from repro_torch import control as C
    c = ref.control
    pairs = [(C.StaticPolicy(), c.StaticPolicy())]
    for b in (0.8, 0.4, 0.2, 0.1, 0.05, 0.01, 0.002, 0.3):
        pairs.append((C.VarianceBudgetPolicy(budget=b),
                      c.VarianceBudgetPolicy(budget=b)))
    for bits in (0, 1 << 10, 1 << 12, 1 << 14, 1 << 16, 1 << 20):
        pairs.append((C.BitBudgetPolicy(bits_per_step=bits),
                      c.BitBudgetPolicy(bits_per_step=bits)))
    for r in (0.01, 0.05, 0.2):
        pairs.append((C.AdaptiveKPolicy(avg_ratio=r),
                      c.AdaptiveKPolicy(avg_ratio=r)))
    for m in (0.0, 0.05, 0.5):
        pairs.append((C.GranularitySwitchPolicy(margin=m),
                      c.GranularitySwitchPolicy(margin=m)))
    for a in (0.0, 3.0, 50.0, 1e5):
        pairs.append((C.FusionPolicy(alpha_us=a), c.FusionPolicy(alpha_us=a)))
    return pairs


POLICY_TREES = {"tree": _tree_np, "switch": _switch_tree_np,
                "energy": _energy_split_tree_np}


@pytest.mark.parametrize("tree", list(POLICY_TREES))
def test_every_policy_decides_as_the_reference(tree):
    """Every policy (and the reference tests' knobs) on the reference's
    own summary of a top-k(0.1) window, from layer-wise and entire-model
    top-k / random-k / QSGD / signSGD / shared random-k decisions: the
    port's decision equals the reference's, field for field and in
    describe(). The port's own summary of the same window agrees with the
    reference's within 1e-5 relative (seen 4.3e-8)."""
    from repro_torch.control import CompressionDecision
    from repro_torch.core import Granularity, make_compressor
    tree_np = POLICY_TREES[tree]()
    bases = [("topk", {"ratio": 0.1}, "layerwise", "simulated"),
             ("topk", {"ratio": 0.05}, "entire_model", "simulated"),
             ("randomk", {"ratio": 0.25}, "layerwise", "simulated"),
             ("randomk", {"ratio": 0.1}, "layerwise", "shared_random"),
             ("qsgd", {"levels": 16}, "layerwise", "simulated"),
             ("signsgd", {}, "layerwise", "simulated")]
    port_summary, mplan = _port_summary(make_compressor("topk", ratio=0.1),
                                        tree_np)
    with _reference() as ref:
        c, core = ref.control, ref.core
        summary, jplan = _ref_summary(
            ref, core.make_compressor("topk", ratio=0.1), tree_np)
        _json_close(port_summary, summary)
        seen = 0
        for pp, rp in _policy_pairs(ref):
            assert pp.name == rp.name
            assert pp.needs_telemetry == rp.needs_telemetry
            assert pp.needs_entire_model == rp.needs_entire_model
            for name, kw, gran, strat in bases:
                base = CompressionDecision(
                    qw=make_compressor(name, **kw),
                    granularity=Granularity(gran), strategy=strat)
                jbase = c.CompressionDecision(
                    qw=core.make_compressor(name, **kw),
                    granularity=core.Granularity(gran), strategy=strat)
                for s in (summary, {}):
                    got = pp.decide(s, base, mplan)
                    want = rp.decide(s, jbase, jplan)
                    assert _decision_key(got) == _decision_key(want), (
                        pp, name, gran, strat)
                    assert (got is base) == (want is jbase)
                    seen += got != base
    assert seen > 0


def test_variance_budget_monotone_and_bit_budget_respected():
    """Tighter variance budget => never fewer bits; the bit budget is never
    exceeded and a looser one never captures less (port policies on the
    port's summary)."""
    from repro_torch.control import (BitBudgetPolicy, CompressionDecision,
                                     VarianceBudgetPolicy)
    from repro_torch.core import make_compressor
    qw = make_compressor("topk", ratio=0.1)
    base = CompressionDecision(qw=qw)
    summary, mplan = _port_summary(qw)
    dims = mplan.unit_dims
    budgets = sorted(np.geomspace(1e-4, 1.0, 25))
    bits = [VarianceBudgetPolicy(budget=b).decide(summary, base, mplan)
            .payload_bits(dims) for b in budgets]
    assert all(a >= b for a, b in zip(bits, bits[1:]))
    min_bits = BitBudgetPolicy(bits_per_step=0).decide(
        summary, base, mplan).payload_bits(dims)
    for budget in (min_bits, 4 * min_bits, 64 * min_bits):
        d = BitBudgetPolicy(bits_per_step=budget).decide(summary, base,
                                                         mplan)
        assert d.payload_bits(dims) <= budget
    loose = BitBudgetPolicy(bits_per_step=64 * min_bits).decide(
        summary, base, mplan)
    assert loose.payload_bits(dims) >= min_bits


def test_make_policy_and_fusion_threshold():
    """make_policy by name; FusionPolicy fuses everything on a
    latency-bound link and streams per bucket at alpha 0, and passes
    non-layerwise decisions through."""
    from repro_torch.control import (CompressionDecision, FusionPolicy,
                                     make_policy)
    from repro_torch.core import Granularity, build_schedule, make_compressor
    assert make_policy("static").name == "static"
    assert make_policy("variance_budget", budget=0.2).budget == 0.2
    p = make_policy("adaptive_k", avg_ratio=0.1)
    assert p.name == "adaptive_k" and p.avg_ratio == 0.1
    assert p.needs_telemetry and not p.needs_entire_model
    with pytest.raises(ValueError):
        make_policy("nope")
    qw = make_compressor("topk", ratio=0.1)
    summary, mplan = _port_summary(qw)
    base = CompressionDecision(qw=qw)
    hi = FusionPolicy(alpha_us=1e5).decide(summary, base, mplan)
    assert build_schedule(mplan, hi.fusion_bytes).num_messages == 1
    assert FusionPolicy(alpha_us=0.0).decide(summary, base,
                                             mplan).fusion_bytes == 0.0
    em = CompressionDecision(qw=qw, granularity=Granularity("entire_model"))
    assert FusionPolicy().decide(summary, em, mplan) == em
    assert make_policy("fusion", alpha_us=3.0).alpha_us == 3.0


def test_adaptive_k_allocates_by_energy_and_falls_back():
    from repro_torch.control import AdaptiveKPolicy, CompressionDecision
    from repro_torch.core import make_compressor
    qw = make_compressor("topk", ratio=0.05)
    summary, mplan = _port_summary(qw, _energy_split_tree_np())
    base = CompressionDecision(qw=qw)
    d = AdaptiveKPolicy(avg_ratio=0.05).decide(summary, base, mplan)
    ratios = dict(d.ratio_overrides)
    assert set(ratios) == {512, 448} and ratios[512] > ratios[448]
    d2 = AdaptiveKPolicy(avg_ratio=0.05).decide(summary, base, mplan)
    assert d == d2 and hash(d) == hash(d2)
    assert AdaptiveKPolicy().decide({}, base, mplan) is base
    sign = CompressionDecision(qw=make_compressor("signsgd"))
    assert AdaptiveKPolicy().decide(summary, sign, mplan) is sign
    dead = dict(summary, buckets=[dict(b, grad_norm_sq=0.0)
                                  for b in summary["buckets"]])
    assert all(r == 0.05 for _, r in AdaptiveKPolicy(avg_ratio=0.05).decide(
        dead, base, mplan).ratio_overrides)


# ---- the controller over a simulated-worker harness -----------------------------

def _sim_harness(sm, mplan, collect=True, wire=False):
    """build_step factory: an Algorithm-1 aggregation over fixed 2-worker
    gradients, threading telemetry (test_control.py's)."""
    from repro_torch.control import accumulate
    from repro_torch.core import aggregate_simulated_workers

    def build(decision):
        cfg = decision.to_config()

        def step(wg, key, telem):
            if collect:
                out, _, inc = aggregate_simulated_workers(
                    wg, sm, cfg, key, telemetry_plan=mplan, wire=wire)
                return out, accumulate(telem, inc)
            out, _ = aggregate_simulated_workers(wg, sm, cfg, key, wire=wire)
            return out, telem
        return step
    return build


def _ref_sim_harness(ref, sm, mplan, collect=True):
    import jax
    c, core = ref.control, ref.core

    def build(decision):
        cfg = decision.to_config()

        @jax.jit
        def step(wg, key, telem):
            if collect:
                out, _, inc = core.aggregate_simulated_workers(
                    wg, sm, cfg, key, telemetry_plan=mplan)
                return out, c.accumulate(telem, inc)
            out, _ = core.aggregate_simulated_workers(wg, sm, cfg, key)
            return out, telem
        return step
    return build


def _two_workers(tree_np):
    return {k: np.stack([v, v]) for k, v in tree_np.items()}


def test_granularity_switch_controller_matches_reference():
    """GranularitySwitchPolicy over 6 steps (re-plan every 2) on the
    switch workload: the port switches to entire-model at step 1 exactly
    as the reference, builds 2 steps (the revisits are cache hits: the
    same step object), and its report() (the --telemetry-out JSON,
    schema version 2) has the reference's keys and strings, its numbers
    within 1e-5 relative."""
    import jax
    from repro_torch import random as R
    from repro_torch.control import (CompressionDecision, Controller,
                                     GranularitySwitchPolicy,
                                     measurement_plan, unit_omegas)
    from repro_torch.core import Granularity, make_compressor, stacked_mask
    from repro_torch.core.theory import noise_bounds_from_plan
    tree = _switch_tree_np()
    t = _torch(tree)
    sm = stacked_mask(t)
    mplan = measurement_plan(t, sm)
    base = CompressionDecision(qw=make_compressor("topk", ratio=0.1),
                               granularity=Granularity("layerwise"))
    ctrl = Controller(GranularitySwitchPolicy(margin=0.05),
                      _sim_harness(sm, mplan), base, mplan, replan_every=2)
    wg = _torch(_two_workers(tree))
    fns = []
    for i in range(6):
        fn = ctrl.step_fn()
        fns.append(fn)
        _, telem = fn(wg, R.fold_in(R.key(0), i), ctrl.telemetry)
        ctrl.observe(telem, i)
    assert ctrl.switches and ctrl.switches[0]["step"] == 1
    assert ctrl.decision.granularity.kind == "entire_model"
    assert ctrl.builds == 2 and ctrl.retraces_unexpected == 0
    assert fns[2] is fns[3] is fns[4] is fns[5]
    s = ctrl.windows[-1]["summary"]
    lw, _ = noise_bounds_from_plan(mplan, measured_w=unit_omegas(s, mplan))
    assert s["entire_model"]["dim"] * (1 + s["entire_model"]["rel_err"]) < lw
    report = json.loads(json.dumps(ctrl.report()))
    assert report["schema_version"] == 2 and report["jit_recompiles"] == 0
    with _reference() as ref:
        c, core = ref.control, ref.core
        jt = _jax(tree)
        jsm = core.stacked_mask(jt)
        jplan = c.measurement_plan(jt, jsm)
        jbase = c.CompressionDecision(
            qw=core.make_compressor("topk", ratio=0.1),
            granularity=core.Granularity("layerwise"))
        jctrl = c.Controller(c.GranularitySwitchPolicy(margin=0.05),
                             _ref_sim_harness(ref, jsm, jplan), jbase, jplan,
                             replan_every=2)
        jwg = _jax(_two_workers(tree))
        for i in range(6):
            _, telem = jctrl.step_fn()(jwg, jax.random.fold_in(
                jax.random.key(0), i), jctrl.telemetry)
            jctrl.observe(telem, i)
        want = json.loads(json.dumps(jctrl.report()))
    assert ctrl.builds == jctrl.builds and ctrl.switches == jctrl.switches
    _json_close(report, want)


def test_controller_cache_never_rebuilds_a_decision():
    """Same decision -> the same step object; a fusion_bytes-only decision
    is a new key the first time and a cache hit on every revisit, its
    outputs bitwise the unscheduled step's; an adaptive-k allocation
    re-decided from the same summary hits the cache too. builds equals
    the number of distinct decisions (and the reference's count over the
    same sequence)."""
    from repro_torch import random as R
    from repro_torch.control import (AdaptiveKPolicy, CompressionDecision,
                                     Controller, StaticPolicy,
                                     measurement_plan)
    from repro_torch.core import Granularity, make_compressor, stacked_mask
    tree = _tree_np()
    t = _torch(tree)
    sm = stacked_mask(t)
    mplan = measurement_plan(t, sm)
    qw = make_compressor("topk", ratio=0.25)
    base = CompressionDecision(qw=qw)
    a = dataclasses.replace(base, fusion_bytes=4096.0)
    b = dataclasses.replace(base, fusion_bytes=math.inf)
    em = CompressionDecision(qw=qw, granularity=Granularity("entire_model"))
    et = _energy_split_tree_np()
    summary, _ = _port_summary(make_compressor("topk", ratio=0.05), et)
    ak = AdaptiveKPolicy(avg_ratio=0.05).decide(summary, base, mplan)
    assert len({base, a, b, em, ak}) == 5
    seq = [base, base, a, b, a, base, em, base, ak, base, ak,
           AdaptiveKPolicy(avg_ratio=0.05).decide(summary, base, mplan)]
    ctrl = Controller(StaticPolicy(), _sim_harness(sm, mplan, False), base,
                      mplan, collect_telemetry=False)
    wg = {k: np.stack([v, 2 * v]) if not isinstance(v, dict) else
          {kk: np.stack([vv, 2 * vv]) for kk, vv in v.items()}
          for k, v in tree.items()}
    wg = _torch(wg)
    fns, outs = {}, {}
    for d in seq:
        ctrl.set_decision(d)
        fn = ctrl.step_fn()
        assert fns.setdefault(d, fn) is fn
        outs[d] = fn(wg, R.key(0), None)[0]
    assert ctrl.builds == 5 and ctrl.retraces_unexpected == 0
    for d in (a, b):
        for k in ("embed", "head"):
            assert torch.equal(outs[d][k], outs[base][k])
        assert torch.equal(outs[d]["blocks"]["w"], outs[base]["blocks"]["w"])
    with _reference() as ref:
        c, core = ref.control, ref.core
        jt = _jax(tree)
        jsm = core.stacked_mask(jt)
        jplan = c.measurement_plan(jt, jsm)

        def jdec(d):
            return c.CompressionDecision(
                qw=core.make_compressor("topk", ratio=0.25),
                granularity=core.Granularity(d.granularity.kind),
                ratio_overrides=d.ratio_overrides,
                fusion_bytes=d.fusion_bytes)
        built = []
        jctrl = c.Controller(c.StaticPolicy(),
                             lambda d: built.append(d) or (lambda: None),
                             jdec(base), jplan, collect_telemetry=False)
        for d in seq:
            jctrl.set_decision(jdec(d))
            jctrl.step_fn()
    assert jctrl.builds == ctrl.builds


def test_per_dim_topk_wire_step_is_its_simulated_step():
    """An AdaptiveKPolicy decision (a different k per bucket) through
    aggregate_simulated_workers with wire=True: one grouped fields pack /
    unpack over index legs of different k and width, bitwise the
    simulated step, which is bitwise the reference's simulated step."""
    import jax
    from repro_torch import random as R
    from repro_torch.control import (AdaptiveKPolicy, CompressionDecision,
                                     measurement_plan)
    from repro_torch.core import (aggregate_simulated_workers,
                                  make_compressor, stacked_mask, wire_codec)
    from repro_torch.core.compressors import index_bits
    tree = _tree_np(4)
    tree["embed"] = tree["embed"] * 30.0        # an uneven energy split
    t = _torch(tree)
    sm = stacked_mask(t)
    mplan = measurement_plan(t, sm)
    base = CompressionDecision(qw=make_compressor("topk", ratio=0.05))
    summary, _ = _port_summary(make_compressor("topk", ratio=0.05), tree)
    d = AdaptiveKPolicy(avg_ratio=0.05).decide(summary, base, mplan)
    cfg = d.to_config()
    codec = wire_codec(cfg.qw)
    ks = {b.dim: codec._k(b.dim) for b in mplan.buckets}
    assert len(set(ks.values())) > 1
    assert len({(ks[dd], index_bits(dd)) for dd in ks}) == len(ks)
    rng = np.random.default_rng(5)
    wg_np = {k: (np.stack([v * (1 + 0.1 * w) for w in range(4)])
                 if not isinstance(v, dict) else
                 {kk: np.stack([vv + 0.01 * rng.standard_normal(vv.shape)
                                .astype(np.float32) for _ in range(4)])
                  for kk, vv in v.items()})
             for k, v in tree.items()}
    wg = _torch(wg_np)
    sim, _ = aggregate_simulated_workers(wg, sm, cfg, R.key(7))
    wire, _ = aggregate_simulated_workers(wg, sm, cfg, R.key(7), wire=True)
    with _reference() as ref:
        c, core = ref.control, ref.core
        jd = c.CompressionDecision(
            qw=core.make_compressor("topk", ratio=0.05),
            ratio_overrides=d.ratio_overrides)
        jsm = core.stacked_mask(_jax(tree))
        want, _ = jax.jit(lambda g, k: core.aggregate_simulated_workers(
            g, jsm, jd.to_config(), k))(_jax(wg_np), jax.random.key(7))
        want = jax.tree_util.tree_map(np.asarray, want)
    for k in ("embed", "head"):
        assert sim[k].numpy().tobytes() == wire[k].numpy().tobytes()
        assert sim[k].numpy().tobytes() == want[k].tobytes()
    assert sim["blocks"]["w"].numpy().tobytes() == \
        wire["blocks"]["w"].numpy().tobytes() == want["blocks"]["w"].tobytes()


# ---- the Engine: a reference subprocess beside one port spawn ---------------------

ENGINE_ALT = ("topk", 0.25, "entire_model")


def reference_main(out_dir: str) -> None:
    """The reference's Engine cases of tests/test_control.py on one
    device: inputs.npz (init params) first, then results.npz (losses and
    params of the plain QSGD(16) step, the telemetry step's losses and
    states) and results.json (the controller's report). The fresh-engine
    case is the port's own bitwise twin
    (test_engine_controller_within_the_port) and costs the reference a
    compile, so it runs here only through the plain step's check."""
    import jax
    import jax.numpy as jnp
    from test_torch_engine import _flat_np
    from test_torch_ref import reference
    out = pathlib.Path(out_dir)
    mods = REF_CONTROL + ("repro.launch.engine", "repro.launch.mesh",
                          "repro.configs.registry")
    with reference(*mods) as ref:
        E = sys.modules["repro.launch.engine"]
        M = sys.modules["repro.launch.mesh"]
        c, core = ref.control, ref.core
        cfg = ref.registry.get_smoke("mamba2-1.3b")
        mesh = M.make_host_mesh(1, 1)
        comp = core.CompressionConfig(
            qw=core.make_compressor("qsgd", levels=LEVELS),
            granularity=core.Granularity("layerwise"))
        eng = E.Engine(cfg, mesh, comp=comp)
        params0, _ = eng.init_state(0)
        np.savez(out / "inputs.tmp.npz", **{
            f"params/{k}": v for k, v in _flat_np(params0).items()})
        os.replace(out / "inputs.tmp.npz", out / "inputs.npz")
        batch = {"tokens": jnp.ones((4, 16), jnp.int32) * 3,
                 "targets": jnp.ones((4, 16), jnp.int32) * 5}
        res, meta = {}, {}

        def run(tag, fn, engine, telem=None):
            params, opt = engine.init_state(0)
            for i in range(STEPS):
                if telem is not None:
                    params, opt, m, telem = fn(params, opt, batch,
                                               jnp.int32(i), telem)
                    for f, v in zip(telem._fields, telem):
                        res[f"{tag}/{i}/telem/{f}"] = np.asarray(v)
                else:
                    params, opt, m = fn(params, opt, batch, jnp.int32(i))
                res[f"{tag}/{i}/loss"] = np.float32(m["loss"])
                for k, v in _flat_np(params).items():
                    res[f"{tag}/{i}/params/{k}"] = v
        run("plain", eng.build_train_step(), eng)
        ctrl = c.engine_controller(eng, c.GranularitySwitchPolicy(),
                                   replan_every=2)
        params, opt = eng.init_state(0)
        for i in range(STEPS):
            params, opt, m, telem = ctrl.step_fn()(
                params, opt, batch, jnp.int32(i), ctrl.telemetry)
            for f, v in zip(telem._fields, telem):
                res[f"telem/{i}/{f}"] = np.asarray(v)
            res[f"telem/{i}/loss"] = np.float32(m["loss"])
            ctrl.observe(telem, i)
        meta["report"] = json.loads(json.dumps(ctrl.report()))
        # compressed_allreduce's telemetry leg (test_control.py's wiring
        # case) on the same mesh
        from jax.sharding import PartitionSpec as P
        t = _jax(_tree_np())
        sm = core.stacked_mask(t)
        mplan = c.measurement_plan(t, sm)
        wcfg = core.CompressionConfig(
            qw=core.make_compressor("topk", ratio=0.25),
            granularity=core.Granularity("layerwise"))

        def with_telem(g):
            o, _, inc = core.compressed_allreduce(
                g, sm, wcfg, ("data",), jax.random.key(0), 1,
                telemetry_plan=mplan)
            return o, inc
        o, inc = jax.jit(E.shard_map(with_telem, mesh, in_specs=(P(),),
                                     out_specs=(P(), P())))(t)
        for f, v in zip(inc._fields, inc):
            res[f"allreduce/{f}"] = np.asarray(v)
        for k, v in _flat_np(o).items():
            res[f"allreduce/out/{k}"] = v
    np.savez(out / "results.npz", **res)
    (out / "results.json").write_text(json.dumps(meta))


@pytest.fixture(scope="module", autouse=True)
def reference_run(tmp_path_factory):
    """Start the reference's subprocess and the port's rank spawn (in a
    thread: run_ranks blocks) with the module's first test, so both run
    beside the in-process cases; the port's rank 0 waits for the
    reference's inputs."""
    out = tmp_path_factory.mktemp("control")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           str(ROOT / "tests")]))
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen(
        [sys.executable, "-c", "import sys, test_torch_control as t; "
         "t.reference_main(sys.argv[1])", str(out)], env=env,
        cwd=str(ROOT / "tests"), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    # import in this thread: two threads importing the package at once
    # can each see the other's half-initialized modules
    from repro_torch.launch import train  # noqa: F401
    from repro_torch.launch.mesh import run_ranks
    box = {}

    def spawn():
        try:
            box["ranks"] = run_ranks(
                rank_cases, CLI_RANKS, backend="gloo", device="cpu",
                args=(str(out / "inputs.npz"), str(out / "telemetry.json")),
                timeout=RANK_TIMEOUT)
        except BaseException as e:   # re-raised by the test that reads it
            box["error"] = e
    thread = threading.Thread(target=spawn, daemon=True)
    thread.start()

    def results():
        if "npz" not in box:
            log, _ = proc.communicate(timeout=REF_TIMEOUT)
            assert proc.returncode == 0, log[-4000:]
            box["npz"] = dict(np.load(out / "results.npz"))
            box["json"] = json.loads((out / "results.json").read_text())
        return box["npz"], box["json"]

    def ranks():
        thread.join(RANK_TIMEOUT)
        assert not thread.is_alive(), "the rank spawn did not finish"
        if "error" in box:
            raise box["error"]
        return box["ranks"]
    yield str(out / "inputs.npz"), results, ranks, out / "telemetry.json"
    thread.join(RANK_TIMEOUT)
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def _host_tree(tree) -> dict:
    from repro_torch.convert import tree_leaves, tree_paths
    return {"/".join(p): l.detach().numpy().copy()
            for p, l in zip(tree_paths(tree), tree_leaves(tree))}


def rank_cases(rank, world, dev, inputs_path, telemetry_out):
    """Rank 0: every Engine case on a one-rank group; then both ranks: the
    train CLI's rank loop with --policy (rank 0's printed lines
    captured) -> {"engine": ..., "cli": ..., "lines": ...}."""
    import contextlib
    import io
    import torch.distributed as dist
    from repro_torch.launch import train
    from repro_torch.launch.mesh import Mesh
    solo = dist.new_group([0])
    out = {}
    if rank == 0:
        out["engine"] = _engine_cases(Mesh(("data", "model"), (1, 1),
                                           {"data": solo}), dev,
                                      inputs_path)
    dist.barrier()
    args = train._parse(CLI + ["--telemetry-out", telemetry_out])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out["cli"] = train._train_rank(rank, world, dev, args, False)
    out["lines"] = buf.getvalue().splitlines()
    return out


def _engine_cases(mesh, dev, inputs_path):
    """Every Engine case on `mesh` (one rank) -> a dict of results."""
    from test_torch_engine import _unflat
    from repro_torch import random as R
    from repro_torch.configs import get_smoke
    from repro_torch.control import (CompressionDecision,
                                     GranularitySwitchPolicy, StaticPolicy,
                                     engine_controller, measure,
                                     measurement_plan)
    from repro_torch.convert import params_from_jax, tree_leaves, tree_map
    from repro_torch.core import (CompressionConfig, Granularity,
                                  compressed_allreduce, make_compressor,
                                  stacked_mask)
    from repro_torch.launch.engine import Engine
    from repro_torch.optim import init_opt_state
    torch.set_num_threads(2)
    deadline = time.monotonic() + REF_TIMEOUT
    while not os.path.exists(inputs_path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"no reference inputs at {inputs_path}")
        time.sleep(0.1)
    p0 = _unflat(dict(np.load(inputs_path)), "params")
    cfg = get_smoke("mamba2-1.3b")
    comp = CompressionConfig(qw=make_compressor("qsgd", levels=LEVELS),
                             granularity=Granularity("layerwise"))
    eng = Engine(cfg, mesh, comp=comp, device=dev)
    batch = {"tokens": torch.full((4, 16), 3, dtype=torch.int32),
             "targets": torch.full((4, 16), 5, dtype=torch.int32)}
    out = {}

    def run(fn, engine, telem=None):
        params = params_from_jax(p0, device=dev)
        opt = init_opt_state(engine.opt, params)
        rec = []
        for i in range(STEPS):
            if telem is not None:
                params, opt, m, telem = fn(params, opt, batch, i, telem)
            else:
                params, opt, m = fn(params, opt, batch, i)
            rec.append({"loss": float(m["loss"]),
                        "params": _host_tree(params),
                        "telem": None if telem is None else
                        [v.numpy().copy() for v in telem]})
        return rec
    plain_step = eng.build_train_step()
    _, g = plain_step.grads(params_from_jax(p0, device=dev), batch, 0)
    out["grad_norm"] = float(torch.sqrt(sum(torch.sum(x.double() ** 2)
                                            for x in tree_leaves(g))))
    out["plain"] = run(plain_step, eng)
    ctrl = engine_controller(eng, StaticPolicy())
    out["static_decision_is_base"] = (
        ctrl.decision == CompressionDecision.from_config(comp))
    out["static"] = run(ctrl.step_fn(), eng)
    name, ratio, gran = ENGINE_ALT
    alt = CompressionDecision(qw=make_compressor(name, ratio=ratio),
                              granularity=Granularity(gran))
    actrl = engine_controller(eng, StaticPolicy(), collect_telemetry=False)
    actrl.set_decision(alt)
    out["alt_controller"] = run(actrl.step_fn(), eng)
    fresh = Engine(cfg, mesh, comp=alt.to_config(), device=dev)
    out["alt_fresh"] = run(fresh.build_train_step(), fresh)
    out["builds"] = (ctrl.builds, actrl.builds)
    tctrl = engine_controller(eng, GranularitySwitchPolicy(),
                              replan_every=2)
    params = params_from_jax(p0, device=dev)
    opt = init_opt_state(eng.opt, params)
    telem_rec = []
    for i in range(STEPS):
        # sum |x| of each bucket over the window: the scale of the signed
        # grad_sum's rounding (the same gradients the step measures)
        _, g = plain_step.grads(params, batch, i)
        abs_sum = measure(eng.measurement_plan(), comp.qw,
                          tree_map(torch.abs, g), R.key(0),
                          entire_model=False).grad_sum
        params, opt, m, telem = tctrl.step_fn()(params, opt, batch, i,
                                                tctrl.telemetry)
        if float(telem.steps) > 1:
            abs_sum = abs_sum + telem_rec[-1]["abs_sum"]
        telem_rec.append({"loss": float(m["loss"]),
                          "telem": [v.numpy().copy() for v in telem],
                          "abs_sum": abs_sum})
        tctrl.observe(telem, i)
    for r in telem_rec:
        r["abs_sum"] = r["abs_sum"].numpy().copy()
    out["telem"] = telem_rec
    out["report"] = json.loads(json.dumps(tctrl.report()))
    # compressed_allreduce: the telemetry leg changes nothing else
    t = _torch(_tree_np())
    sm = stacked_mask(t)
    mplan = measurement_plan(t, sm)
    wcfg = CompressionConfig(qw=make_compressor("topk", ratio=0.25),
                             granularity=Granularity("layerwise"))
    group = mesh.group("data")
    a, _ = compressed_allreduce(t, sm, wcfg, group, R.key(0), 1)
    b, _, inc = compressed_allreduce(t, sm, wcfg, group, R.key(0), 1,
                                     telemetry_plan=mplan)
    out["allreduce"] = {"same": all(torch.equal(x, y) for x, y in zip(
        tree_leaves(a), tree_leaves(b))), "out": _host_tree(b),
        "inc": [v.numpy().copy() for v in inc]}
    return out


def port_engine_run(reference_run):
    return reference_run[2]()[0]["engine"]


def _ref_tree(ref: dict, tag: str) -> dict:
    p = tag + "/"
    return {k[len(p):]: v for k, v in ref.items() if k.startswith(p)}


def _state(fields):
    from repro_torch.control import TelemetryState
    return TelemetryState(*fields)


def test_engine_controller_within_the_port(reference_run):
    """StaticPolicy through engine_controller is bitwise the plain Engine
    step (losses and params, 2 steps); a decision the controller builds
    on the fly is bitwise a fresh Engine built with its config; each
    controller built one step; compressed_allreduce with a telemetry_plan
    returns the same aggregate, bitwise."""
    from test_torch_engine import _bitwise_trees
    port = port_engine_run(reference_run)
    assert port["static_decision_is_base"]
    for a, b in (("static", "plain"), ("alt_controller", "alt_fresh")):
        for i in range(STEPS):
            assert port[a][i]["loss"] == port[b][i]["loss"], (a, i)
            _bitwise_trees(port[a][i]["params"], port[b][i]["params"],
                           (a, b, i))
    assert port["builds"] == (1, 1)
    assert port["allreduce"]["same"]


def test_engine_controller_matches_reference(reference_run):
    """Against the reference's Engine on one device (Queue 3 item 15):
    QSGD(16) step 0's loss within 1e-5 relative, step 1's within 1e-4,
    params at most 0.1% of entries beyond 1e-4 of their leaf's largest
    change, each within 2 lr levels, for the plain step and the static
    controller's (the on-the-fly decision is held bitwise against a
    fresh port Engine). The telemetry threads through the steps: 1 then
    2 steps accumulated, one window of 2 steps summarized; the gradient
    fields within 1e-4 relative (seen 6.2e-5: the gradients themselves
    differ within item 12's tolerance; the signed grad_sum within 1e-4 of
    its bucket's sum |x|), the Q_W fields within 1e-3 (seen 1.1e-4:
    QSGD codes of those gradients), the report's keys, strings and
    decisions the reference's. Seen: losses 6.4e-8 and 1.5e-5, no QSGD
    param beyond the share rule's 1e-4.
    compressed_allreduce's telemetry increment is the reference's within
    1e-5 relative and its aggregate bitwise."""
    from test_torch_engine import _share_close
    port = port_engine_run(reference_run)
    ref, meta = reference_run[1]()
    p0 = _ref_tree(dict(np.load(reference_run[0])), "params")
    level = 1.001 * port["grad_norm"] / LEVELS
    seen = {}
    for tag, held in (("plain", "plain"), ("static", "plain")):
        last = _ref_tree(ref, f"{held}/{STEPS - 1}/params")
        change = {k: np.abs(last[k].astype(np.float64) - p0[k]).max()
                  for k in p0}
        for i in range(STEPS):
            got = port[tag][i]
            want = float(ref[f"{held}/{i}/loss"])
            rel = abs(got["loss"] - want) / abs(want)
            rp = _ref_tree(ref, f"{held}/{i}/params")
            assert rel <= (1e-5 if i == 0 else 1e-4), (tag, i, rel)
            seen[f"{tag}/{i}"] = (rel, _share_close(
                got["params"], rp, change, 1e-4,
                (i + 1) * ENGINE_LR * level, (tag, i)))
    fields = ("steps", "grad_sum", "grad_sumsq", "qw_sumsq", "qw_errsq",
              "agg_errsq", "em_sumsq", "em_qw_sumsq", "em_errsq")
    for i in range(STEPS):
        got = dict(zip(fields, port["telem"][i]["telem"]))
        assert float(got["steps"]) == i + 1
        for f in fields:
            want = ref[f"telem/{i}/{f}"].astype(np.float64)
            g = got[f].astype(np.float64)
            scale = np.abs(want)
            if f == "grad_sum":   # a signed sum: held against sum |x|
                scale = port["telem"][i]["abs_sum"].astype(np.float64)
            rel = 1e-4 if f in ("steps", "grad_sum", "grad_sumsq",
                                "em_sumsq") else 1e-3
            err = np.abs(g - want) / np.maximum(scale, 1e-30)
            assert err.max() <= rel, (f, i, float(err.max()))
            seen[f"telem/{i}/{f}"] = float(err.max())
    rep, wrep = port["report"], meta["report"]
    assert sorted(rep) == sorted(wrep) and rep["schema_version"] == 2
    for k in ("policy", "replan_every", "decision", "active", "builds",
              "retraces_unexpected", "switches"):
        assert rep[k] == wrep[k], k
    # the reference's extra jit signature (its first optimized step
    # re-specializes once); a torch step has no jit cache
    assert rep["jit_recompiles"] == 0
    assert len(rep["windows"]) == len(wrep["windows"]) == 1
    ws, wws = rep["windows"][0]["summary"], wrep["windows"][0]["summary"]
    assert ws["steps"] == wws["steps"] == 2.0
    assert sorted(ws) == sorted(wws)
    assert [(b["dim"], b["n_units"], sorted(b)) for b in ws["buckets"]] == \
        [(b["dim"], b["n_units"], sorted(b)) for b in wws["buckets"]]
    _fields_close(_state(port["allreduce"]["inc"]),
                  _state([ref[f"allreduce/{f}"] for f in fields]),
                  what="allreduce")
    want_out = _ref_tree(ref, "allreduce/out")
    for k, v in port["allreduce"]["out"].items():
        assert v.tobytes() == want_out[k].tobytes(), k
    print(json.dumps(seen))


def test_train_cli_policy_runs_the_controller(reference_run):
    """train --policy granularity_switch on 2 gloo CPU ranks (the CLI's
    rank loop; llama3 smoke, top-k(10%)): the header names the policy, a
    re-plan line per switch, the controller line, the same decision
    sequence and losses on both ranks, builds equal to the distinct
    decisions, and --telemetry-out's report (schema version 2) from rank
    0."""
    ranks = reference_run[2]()
    lines = ranks[0]["lines"]
    assert any(ln.startswith("arch=") and "policy=granularity_switch/"
               "replan=2" in ln for ln in lines)
    c0, c1 = ranks[0]["cli"]["controller"], ranks[1]["cli"]["controller"]
    assert c0["decisions"] == c1["decisions"]
    assert ranks[0]["cli"]["losses"] == ranks[1]["cli"]["losses"]
    assert all(math.isfinite(v) for v in ranks[0]["cli"]["losses"])
    rep = json.loads(reference_run[3].read_text())
    assert rep["schema_version"] == 2 and rep == c0["report"]
    assert rep["builds"] == len(set(c0["decisions"])) == 2
    ctl = [ln for ln in lines if ln.startswith("controller: ")]
    assert ctl == [f"controller: decision={rep['decision']} "
                   f"builds={rep['builds']} "
                   f"switches={len(rep['switches'])}"]
    replans = [ln for ln in lines if " replan -> " in ln]
    assert len(replans) == len(rep["switches"]) >= 1
