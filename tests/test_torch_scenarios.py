"""The port's simulated cluster (repro_torch/sim/), its non-IID samplers
and draws (data/synthetic.py, random.py) and the scenario campaign
(repro_torch/scenarios.py, figures.fig_scenarios) against the JAX
package's.

Held exactly: the Scenario value objects (equality, hashing, describe(),
identity, validation messages), the straggler draws and alive masks, the
step_accounting dicts (per-link FusionPolicy thresholds through
simulate_schedule), the rescale of EF state through a real checkpoint
(a bitwise no-op at the same size, mass conserved over 4 -> 2 -> 4), the
identity scenario's aggregate (bitwise the bare aggregate over the
codec zoo), gumbel / categorical draws, the non-IID labels and tokens
given the reference's proportions, and fig_scenarios' rows. Stated
bounds: dirichlet_proportions is bitwise at 10 categories and within
ROADMAP Queue 3 item 20 on 512 (1e-6 relative, rows summing to 1 within
1e-6); the non-IID images within Queue 3 item 17's two ulps.
"""
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_ref import ROOT, jkey, key_data, reference, tkeys

SIX = [
    ("topk", {"ratio": 0.25}),
    ("randomk", {"ratio": 0.3, "scale": True}),
    ("qsgd", {"levels": 16}),
    ("terngrad", {}),
    ("signsgd", {}),
    ("natural", {}),
]
TREE = {"blocks": {"w": (3, 16, 8), "b": (3, 8)}, "embed": (20, 4),
        "head": (4, 2), "scalar_gain": ()}


def _zeros(shapes, lib):
    return {k: (_zeros(v, lib) if isinstance(v, dict) else
                lib.zeros(v, dtype=lib.float32))
            for k, v in shapes.items()}


def _scenarios(sim):
    """The same specs built from either package's sim module."""
    return [
        sim.Scenario(),
        sim.Scenario(name="identity", n_workers=4,
                     straggler=sim.StragglerSpec(prob=0.5, delay_us=0.0,
                                                 seed=11),
                     rescales=(sim.RescaleEvent(step=3, world_size=4),)),
        sim.Scenario(name="x", n_workers=4,
                     links=(sim.LinkSpec(10.0, 5.0),),
                     straggler=sim.StragglerSpec(0.5, 100.0, 3),
                     rescales=(sim.RescaleEvent(5, 2),),
                     dirichlet_alpha=0.3,
                     corruption=sim.CorruptionSpec(prob=0.25,
                                                   mode="truncate")),
        sim.Scenario(
            name="hetero_straggler", n_workers=4,
            links=(sim.LinkSpec(alpha_us=20.0, gbps=25.0),
                   sim.LinkSpec(alpha_us=50.0, gbps=12.5),
                   sim.LinkSpec(alpha_us=120.0, gbps=5.0),
                   sim.LinkSpec(alpha_us=400.0, gbps=1.25)),
            straggler=sim.StragglerSpec(prob=0.25, delay_us=5000.0,
                                        seed=7)),
        sim.Scenario(name="elastic", n_workers=5,
                     links=(sim.LinkSpec(0.0, 12.5),
                            sim.LinkSpec(5000.0, 12.5)),
                     rescales=(sim.RescaleEvent(1, 2),
                               sim.RescaleEvent(2, 4))),
    ]


BAD = [
    ("Scenario", dict(n_workers=0)), ("Scenario", dict(dirichlet_alpha=0.0)),
    ("LinkSpec", dict(alpha_us=-1.0)), ("LinkSpec", dict(gbps=0.0)),
    ("StragglerSpec", dict(prob=1.5)), ("StragglerSpec", dict(delay_us=-1.0)),
    ("RescaleEvent", dict(step=-1, world_size=2)),
    ("RescaleEvent", dict(step=0, world_size=0)),
    ("CorruptionSpec", dict(prob=2.0)), ("CorruptionSpec", dict(mode="x")),
    ("CorruptionSpec", dict(n_bits=0)),
]


def test_scenario_value_objects_match_reference():
    """Equal specs are equal and hash alike; describe(), is_identity(),
    world_size_at() and link() give the reference's answers; every bad
    spec raises the reference's ValueError message."""
    from repro_torch import sim
    mine = _scenarios(sim)
    again = _scenarios(sim)
    assert mine == again and [hash(s) for s in mine] == \
        [hash(s) for s in again]
    with reference("repro.sim") as ref:
        theirs = _scenarios(ref.sim)
        for a, b in zip(mine, theirs):
            assert a.describe() == b.describe()
            assert a.is_identity() == b.is_identity()
            assert [a.world_size_at(s) for s in range(8)] == \
                [b.world_size_at(s) for s in range(8)]
            assert [(a.link(i).alpha_us, a.link(i).gbps)
                    for i in range(6)] == \
                [(b.link(i).alpha_us, b.link(i).gbps) for i in range(6)]
        for cls, kw in BAD + [("Scenario", None)]:
            msgs = []
            for mod in (sim, ref.sim):
                with pytest.raises(ValueError) as e:
                    if kw is None:
                        mod.Scenario(rescales=(mod.RescaleEvent(10, 2),
                                               mod.RescaleEvent(5, 4)))
                    else:
                        getattr(mod, cls)(**kw)
                msgs.append(str(e.value))
            assert msgs[0] == msgs[1], (cls, kw)
    assert sim.DEFAULT_ALPHA_US == ref.sim.DEFAULT_ALPHA_US
    assert sim.DEFAULT_GBPS == ref.sim.DEFAULT_GBPS


def test_straggler_draws_and_alive_masks_match_reference():
    """StragglerSpec.draws (numpy default_rng((seed, step))) and
    SimCluster.alive_mask equal the reference's for every step."""
    from repro_torch import sim
    from repro_torch.core import CompressionConfig, make_compressor
    with reference("repro.sim") as ref:
        for a, b in zip(_scenarios(sim), _scenarios(ref.sim)):
            ca = sim.SimCluster(a, CompressionConfig(
                qw=make_compressor("topk", ratio=0.25)))
            cb = ref.sim.SimCluster(b, ref.core.CompressionConfig(
                qw=ref.core.make_compressor("topk", ratio=0.25)))
            for step in range(6):
                for n in (1, 4, 7):
                    np.testing.assert_array_equal(
                        a.straggler.draws(step, n), b.straggler.draws(step, n))
                for t in (None, 0.0, 10.0, 1e9):
                    ma, mb = ca.alive_mask(step, t), cb.alive_mask(step, t)
                    assert (ma is None) == (mb is None)
                    if ma is not None:
                        np.testing.assert_array_equal(ma, mb)


@pytest.mark.parametrize("gran", ["layerwise", "entire_model"])
def test_step_accounting_matches_reference(gran):
    """SimCluster.step_accounting: every worker's link, FusionPolicy
    threshold, message count, modelled times and straggler delay, and the
    step's exposed comm, equal the reference's dicts exactly, over the
    scenarios and steps (elastic world sizes included)."""
    from repro_torch import sim
    from repro_torch.core import (CompressionConfig, Granularity,
                                  build_plan, make_compressor, stacked_mask)
    t = _zeros(TREE, torch)
    plan = build_plan(t, stacked_mask(t), Granularity(gran))
    with reference("repro.sim") as ref:
        jt = _zeros(TREE, jnp)
        jplan = ref.core.build_plan(jt, ref.core.stacked_mask(jt),
                                    ref.core.Granularity(gran))
        for a, b in zip(_scenarios(sim), _scenarios(ref.sim)):
            ca = sim.SimCluster(a, CompressionConfig(
                qw=make_compressor("topk", ratio=0.25)))
            cb = ref.sim.SimCluster(b, ref.core.CompressionConfig(
                qw=ref.core.make_compressor("topk", ratio=0.25)))
            for step in range(3):
                for kw in ({}, {"backward_us": 200.0}):
                    assert ca.step_accounting(step, plan, **kw) == \
                        cb.step_accounting(step, jplan, **kw), (a.name, step)
            assert ca.exposed_comm_total_us() == cb.exposed_comm_total_us()


def _int_ef(n):
    """Integer-valued EF rows, so every re-bucketing sum is exact."""
    rng = np.random.default_rng(n)
    return {"blocks": {"w": torch.from_numpy(rng.integers(
        -8, 8, (n, 3, 16, 8)).astype(np.float32))},
        "head": torch.from_numpy(rng.integers(-8, 8, (n, 4, 2))
                                 .astype(np.float32)),
        "gain": torch.from_numpy(rng.integers(-8, 8, (n,)).astype(
            np.float32)).to(torch.bfloat16)}


def test_rescale_ef_through_checkpoints(tmp_path):
    """rescale_ef to the same size is a bitwise no-op (f32 and bf16 leaves
    through the checkpoint round trip); 4 -> 2 folds worker i into slot
    i % 2 and 2 -> 4 pads joiners with zeros, mass conserved; no event
    due leaves the very same object; an n -> n event changes nothing;
    init_ef is zeros with the worker axis; the reference's _rebucket_rows
    agrees on every leaf."""
    from repro_torch.convert import tree_leaves
    from repro_torch.core import CompressionConfig, make_compressor
    from repro_torch.sim import (RescaleEvent, Scenario, SimCluster,
                                 init_ef)
    from repro_torch.sim.cluster import _rebucket_rows
    cfg = CompressionConfig(qw=make_compressor("topk", ratio=0.25),
                            error_feedback=True)
    sc = Scenario(name="elastic", n_workers=4,
                  rescales=(RescaleEvent(step=10, world_size=2),
                            RescaleEvent(step=20, world_size=4)))
    cluster = SimCluster(sc, cfg, ckpt_dir=str(tmp_path))
    ef4 = _int_ef(4)
    back = cluster.rescale_ef(ef4, 4)
    for a, b in zip(tree_leaves(back), tree_leaves(ef4)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    n, ef2, changed = cluster.maybe_rescale(10, ef4)
    assert (n, changed) == (2, True)
    for l4, l2 in zip(tree_leaves(ef4), tree_leaves(ef2)):
        assert torch.equal(l2[0], l4[0] + l4[2])
        assert torch.equal(l2[1], l4[1] + l4[3])
    n, ef4b, changed = cluster.maybe_rescale(20, ef2)
    assert (n, changed) == (4, True)
    for l2, l4b in zip(tree_leaves(ef2), tree_leaves(ef4b)):
        assert torch.equal(l4b[:2], l2) and not l4b[2:].any()
        assert torch.equal(l4b.sum(0), l2.sum(0))
    for step in (0, 5, 9, 11, 15):
        n, out, changed = cluster.maybe_rescale(step, ef4)
        assert not changed and out is ef4 and n == (4 if step < 10 else 2)
    ident = SimCluster(Scenario(name="identity", n_workers=4, rescales=(
        RescaleEvent(step=3, world_size=4),)), cfg, ckpt_dir=str(tmp_path))
    assert ident.maybe_rescale(3, ef4) == (4, ef4, False)
    z = init_ef({"a": torch.ones(3, 2), "b": torch.ones(())}, 5)
    assert z["a"].shape == (5, 3, 2) and z["b"].shape == (5,)
    assert not z["a"].any()
    with reference("repro.sim") as ref:
        import repro.sim.cluster as C
        for new_n in (1, 2, 3, 4, 6):
            for leaf in tree_leaves(ef4):
                x = leaf.to(torch.float32)
                np.testing.assert_array_equal(
                    _rebucket_rows(x, new_n).numpy(),
                    np.asarray(C._rebucket_rows(jnp.asarray(x.numpy()),
                                                new_n)))


@pytest.mark.parametrize("wire", [False, True])
def test_identity_scenario_is_the_bare_aggregate(wire):
    """At identity (every knob present, every knob neutral) SimCluster's
    aggregate is bitwise aggregate_simulated_workers over the codec zoo,
    both granularities, with error feedback; injector() is None."""
    from repro_torch import random as R
    from repro_torch.convert import tree_leaves
    from repro_torch.core import (CompressionConfig, Granularity,
                                  aggregate_simulated_workers,
                                  make_compressor, stacked_mask)
    from repro_torch.sim import SimCluster, init_ef
    from repro_torch.faults import _tree, _worker_grads
    import repro_torch.sim as sim
    ident = _scenarios(sim)[1]
    assert ident.is_identity()
    grads = _worker_grads()
    sm = stacked_mask(_tree())
    for name, kw in SIX:
        for gran in ("layerwise", "entire_model"):
            cfg = CompressionConfig(qw=make_compressor(name, **kw),
                                    granularity=Granularity(gran),
                                    error_feedback=True)
            cluster = SimCluster(ident, cfg)
            assert cluster.injector(resend=True) is None
            ef = init_ef(_tree(), 4)
            got = cluster.aggregate(grads, sm, R.key(0), ef_state=ef,
                                    wire=wire)
            want = aggregate_simulated_workers(grads, sm, cfg, R.key(0),
                                               ef_state=ef, wire=wire)
            for part in (0, 1):
                for a, b in zip(tree_leaves(got[part]),
                                tree_leaves(want[part])):
                    assert torch.equal(a, b), (name, gran, part)


def test_gumbel_and_categorical_bitwise():
    """random.gumbel and categorical (shape prefix, batched logits, ties
    to the first maximum) are bitwise jax's jitted draws."""
    from repro_torch import random as R
    rng = np.random.default_rng(0)
    logits = np.log(rng.dirichlet(np.full(7, 0.3), 3) + 1e-9).astype(
        np.float32)
    with jax.threefry_partitionable(False):
        for seed in (0, 5):
            k = jkey(seed)
            want = np.asarray(jax.jit(
                lambda k: jax.random.gumbel(k, (33, 64)))(k))
            got = R.gumbel(tkeys(key_data(k)), (33, 64)).numpy()
            np.testing.assert_array_equal(got.view(np.uint32),
                                          want.view(np.uint32))
            want = np.asarray(jax.jit(lambda k, l: jax.random.categorical(
                k, l, shape=(5, 3)))(k, logits))
            got = R.categorical(tkeys(key_data(k)), torch.from_numpy(logits),
                                (5, 3)).numpy()
            np.testing.assert_array_equal(got, want)
            tie = jnp.zeros((4,), jnp.float32).at[1].set(50.0).at[3].set(50.0)
            want = np.asarray(jax.random.categorical(k, tie, shape=(9,)))
            got = R.categorical(tkeys(key_data(k)),
                                torch.from_numpy(np.array(tie)), (9,))
            np.testing.assert_array_equal(got.numpy(), want)


def test_noniid_samplers_match_reference():
    """dirichlet_proportions bitwise at 10 categories (alpha 0.3, 0.05 and
    0.1) and within Queue 3 item 20 at 128; given the reference's
    proportions,
    the non-IID labels and Markov tokens are bitwise and the images within
    two f32 ulps of the prototypes' largest magnitude (item 17)."""
    from repro_torch import data as D
    from repro_torch import random as R
    with reference("repro.data") as ref:
        syn = ref.synthetic
        for seed, cats, alpha in ((42, 10, 0.3), (9, 128, 0.3)):
            k = jkey(seed)
            want = np.asarray(syn.dirichlet_proportions(k, 4, cats, alpha))
            got = D.dirichlet_proportions(tkeys(key_data(k)), 4, cats, alpha,
                                          device="cpu").numpy()
            if cats == 10:
                np.testing.assert_array_equal(got.view(np.uint32),
                                              want.view(np.uint32))
            else:
                np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
                np.testing.assert_allclose(got.sum(1), 1.0, atol=1e-6)
        props = syn.dirichlet_proportions(jkey(3), 4, 10, 0.05)
        lprops = syn.dirichlet_proportions(jkey(4), 4, 10, 0.1)
        for seed, alpha, want in ((3, 0.05, props), (4, 0.1, lprops)):
            got = D.dirichlet_proportions(tkeys(key_data(jkey(seed))), 4,
                                          10, alpha, device="cpu")
            np.testing.assert_array_equal(
                got.numpy().view(np.uint32), np.asarray(want).view(np.uint32))
        k = jax.random.fold_in(jkey(3), 1)
        jb = syn.noniid_classification_batch(k, props, 8, 10, 8, 3)
        tb = D.noniid_classification_batch(
            tkeys(key_data(k)), torch.from_numpy(np.array(props)), 8, 10, 8,
            3)
        np.testing.assert_array_equal(tb["labels"].numpy(),
                                      np.asarray(jb["labels"]))
        assert tb["images"].shape == (4, 8, 8, 8, 3)
        ulp = np.spacing(np.float32(8.0))
        assert np.abs(tb["images"].numpy() - np.asarray(jb["images"])
                      ).max() <= 2 * ulp
        trans = syn.make_markov(10, seed=0)
        k = jax.random.fold_in(jkey(4), 2)
        jl = syn.noniid_markov_lm_batch(k, trans, lprops, 5, 12)
        tl = D.noniid_markov_lm_batch(
            tkeys(key_data(k)), D.make_markov(10, 0, device="cpu"),
            torch.from_numpy(np.array(lprops)), 5, 12)
        for name in ("tokens", "targets"):
            np.testing.assert_array_equal(tl[name].numpy(),
                                          np.asarray(jl[name]))
    assert torch.equal(tl["targets"][..., :-1], tl["tokens"][..., 1:])
    p = D.dirichlet_proportions(R.key(42), 4, 10, 0.1, device="cpu")
    assert float(p.max(1).values.min()) > 0.3


def test_campaign_and_fig_scenarios_rows_match_reference(tmp_path, capsys):
    """The port's campaign (resnet9, the reference's three scenarios, one
    ratio, 1 step, on the CPU) writes the reference's report layout, and
    an LM cell (whisper-base's smoke config: Markov tokens from non-IID
    starts, the audio frames, an elastic rescale) runs; the port's
    fig_scenarios renders the report as the reference's fig_scenarios
    does, row for row; the campaign's constants and scenarios are those
    of the reference's committed report (BENCH_scenarios.json, read)."""
    from repro_torch import figures, scenarios
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    out = tmp_path / "scenarios.json"
    try:
        rep = scenarios.scenarios(out, steps=1, device="cpu",
                                  configs=("resnet9",), ratios=(0.25,))
        lm = scenarios._run_cell(
            "whisper-base", scenarios._LmRunner("whisper-base", "cpu"),
            scenarios.scenarios_for(2)[2], 0.25, "layerwise", 2)
    finally:
        torch.set_num_threads(threads)
    assert rep["scenarios"] == {s.name: s.describe()
                                for s in scenarios.scenarios_for(1)}
    for sname, by_ratio in rep["configs"]["resnet9"].items():
        cell = by_ratio["ratio_0.25"]
        assert cell["verdict"] in ("layerwise", "entire_model", "tie")
        for gran in ("layerwise", "entire_model"):
            c = cell[gran]
            assert len(c["loss_curve"]) == 1
            assert np.isfinite(c["final_loss"])
            assert c["metrics"]["counters"]["scenario/steps"] == 1
    assert lm["metrics"]["counters"]["scenario/rescales"] == 1
    assert all(np.isfinite(lm["loss_curve"]))
    capsys.readouterr()
    figures.fig_scenarios(out)
    mine = capsys.readouterr().out
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    with reference("benchmarks.figures", "benchmarks.common") as ref:
        ref.figures.fig_scenarios(str(out))
    theirs = capsys.readouterr().out
    assert mine == theirs and mine.count("\n") == 3
    bench = json.loads((ROOT / "BENCH_scenarios.json").read_text())
    assert sorted(bench["configs"]) == sorted(scenarios.CONFIGS)
    assert (bench["steps"], tuple(bench["ratios"]), bench["lr"],
            bench["tie_margin"]) == (scenarios.STEPS, scenarios.RATIOS,
                                     scenarios.LR, scenarios.TIE_MARGIN)
    assert bench["scenarios"] == {s.name: s.describe()
                                  for s in scenarios.SCENARIOS}
