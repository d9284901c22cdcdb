"""The paper's figures (repro_torch/figures.py), the error-feedback run it
adds (experiment.train_cnn_ef) and the controller-driven study
(experiment.cnn_controller / train_cnn_with_controller,
repro_torch/granularity_study.py) against the JAX package's
benchmarks/figures.py, benchmarks/common.py and
examples/granularity_study.py, on the CPU.

train_cnn_ef on a narrow mlp (widths (16, 8)) starts from the
reference's init (params_from_jax) and is fed the reference's batches;
three steps of top-k(0.001), error feedback on and off, agree with the
reference's train_cnn_ef within Queue 3 item 2's 1e-2 relative on the test
loss (top-k keeps or zeroes each entry, so the EF residual is exact and
item 6's fma question does not arise). The figure rows are checked with
the same fake experiment in both modules, so the check costs nothing:
every figure's compressor and granularity already has its 3-step check
against the reference (test_torch_model.py::test_three_train_steps).
The cases that train run torch on at most 2 threads: the suite runs
files side by side, each worker's torch taking every core otherwise.
"""
import re
import sys

import numpy as np
import pytest
import torch

from test_torch_ref import ROOT, reference

WIDTHS = (16, 8)


@pytest.fixture(autouse=True)
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    yield
    torch.set_num_threads(threads)


def _figures_reference():
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    return reference("benchmarks.figures", "benchmarks.common")


def _narrow(ref):
    from repro_torch.configs.resnet9_cifar import CNNConfig
    return (ref.resnet9_cifar.CNNConfig(name="narrow", widths=WIDTHS,
                                       kind="mlp"),
            CNNConfig(name="narrow", widths=WIDTHS, kind="mlp"))


@pytest.mark.parametrize("ef", [False, True], ids=["ef0", "ef1"])
def test_train_cnn_ef_matches_reference(ef, monkeypatch):
    """3 steps of benchmarks/figures.py's train_cnn_ef (top-k(0.001),
    layer-wise, plain SGD, EF state with a worker axis of 4) against the
    port's, from the reference's init and on its batches: the final
    params' test loss within 1e-2 relative (seen: the same f32 loss, EF
    on and off) and the test accuracy within one of the 256 test images
    (seen the same)."""
    import jax
    from repro_torch import experiment
    from repro_torch.convert import params_from_jax
    from repro_torch.core import (CompressionConfig, Granularity,
                                  make_compressor)
    from repro_torch.models import cnn
    got = {}
    with _figures_reference() as ref:
        jcfg, cfg = _narrow(ref)
        monkeypatch.setitem(ref.common.MODELS, "narrow", jcfg)
        monkeypatch.setitem(ref.common.LR, "narrow", ref.common.LR["mlp"])
        monkeypatch.setitem(experiment.MODELS, "narrow", cfg)
        monkeypatch.setitem(experiment.LR, "narrow", experiment.LR["mlp"])
        jacc = ref.cnn.cnn_accuracy
        monkeypatch.setattr(ref.cnn, "cnn_accuracy",
                            lambda c, p, b: got.setdefault("ref", (p, b))
                            and jacc(c, p, b))
        tacc = experiment.cnn_accuracy
        monkeypatch.setattr(experiment, "cnn_accuracy",
                            lambda c, p, b: got.setdefault("port", p)
                            is not None and tacc(c, p, b))
        jcomp = ref.core.CompressionConfig(
            qw=ref.core.make_compressor("topk", ratio=0.001),
            granularity=ref.core.Granularity("layerwise"),
            error_feedback=ef)
        want_acc, none = ref.figures.train_cnn_ef("narrow", jcomp, steps=3)
        jp, jtest = got["ref"]
        want_loss = float(ref.cnn.cnn_loss(jcfg, jp, jtest))
        p0 = jax.tree_util.tree_map(
            np.asarray, ref.cnn.init_cnn(jcfg, jax.random.key(0)))

        def batch_fn(k, n):
            b = ref.synthetic.classification_batch(
                jax.random.wrap_key_data(k.numpy().astype(np.uint32)), n)
            return {k_: torch.from_numpy(np.array(v)) for k_, v in b.items()}
        comp = CompressionConfig(qw=make_compressor("topk", ratio=0.001),
                                 granularity=Granularity("layerwise"),
                                 error_feedback=ef)
        acc, none2 = experiment.train_cnn_ef(
            "narrow", comp, steps=3, device="cpu",
            params=params_from_jax(p0, device="cpu"), batch_fn=batch_fn)
        test = {k: torch.from_numpy(np.array(v)) for k, v in jtest.items()}
    assert none is None and none2 is None
    with torch.no_grad():
        loss = float(cnn.cnn_loss(cfg, got["port"], test))
    assert np.isfinite(loss)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-2)
    assert acc == pytest.approx(want_acc, abs=1.5 / 256)


devices = set()


def _fake_compare(calls):
    def fake(model, qname, *, steps, nesterov=False, device=None, **qkw):
        if device is not None:
            devices.add(device)
        calls.append((model, qname, steps, nesterov, sorted(qkw.items())))
        h = (len(calls) * 37) % 100
        return {"layerwise": h / 100, "entire_model": (h + 13) % 100 / 100,
                "baseline": (h + 29) % 100 / 100}
    return fake


def _fake_ef(calls):
    def fake(model, comp, steps=100, device=None):
        calls.append((model, comp.qw.name, comp.qw.ratio,
                      comp.granularity.kind, comp.error_feedback, steps))
        return 0.25 + 0.5 * comp.error_feedback, None
    return fake


def _rows(out: str):
    rows = [ln.split(",") for ln in out.strip().splitlines()]
    for name, us, derived in rows:
        assert re.fullmatch(r"\d+\.\d", us), (name, us)
    return [(name, derived) for name, us, derived in rows]


def test_figure_rows_match_reference(monkeypatch, capsys):
    """figures.ALL prints the reference's rows, in order, with its names
    and `name,us_per_call,derived` CSV (the derived column as the
    reference formats it), asking the experiment for the same model,
    compressor, knobs and steps; `--quick` runs 30 steps a row."""
    from repro_torch import figures
    calls, ef_calls = [], []
    devices.clear()
    monkeypatch.setattr(figures, "compare_granularities",
                        _fake_compare(calls))
    monkeypatch.setattr(figures, "train_cnn_ef", _fake_ef(ef_calls))
    for fig in figures.ALL:
        fig()
    got = _rows(capsys.readouterr().out)
    assert devices == {"cuda"}
    devices.clear()
    with _figures_reference() as ref:
        wcalls, wef = [], []
        monkeypatch.setattr(ref.figures, "compare_granularities",
                            _fake_compare(wcalls))
        monkeypatch.setattr(ref.figures, "train_cnn_ef", _fake_ef(wef))
        assert [f.__name__ for f in ref.figures.ALL] == \
            [f.__name__ for f in figures.ALL]
        for fig in ref.figures.ALL:
            fig()
        want = _rows(capsys.readouterr().out)
    assert len(got) == 26 and got == want
    assert calls == wcalls and ef_calls == wef
    assert figures.STEPS == 100 and {c[2] for c in calls} == {100}
    assert {c[5] for c in ef_calls} == {100}
    calls.clear()
    ef_calls.clear()
    figures.main(["--quick", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "name,us_per_call,derived"
    assert [r[0] for r in _rows("\n".join(out[1:]))] == [r[0] for r in want]
    assert {c[2] for c in calls} == {30} and {c[5] for c in ef_calls} == {30}
    assert devices == {"cpu"}


STATIC_CASES = {"topk_mlp": ("mlp", "topk"),
                "dense_resnet9": ("resnet9", "dense")}


@pytest.mark.parametrize("case", list(STATIC_CASES))
def test_cnn_controller_static_is_train_cnn(case, monkeypatch):
    """A StaticPolicy controller is the train_cnn experiment: the same
    data, keys, schedule and step, so the same final params, test
    accuracy and loss, bitwise (2 steps on the CPU). Over a top-k(1%)
    layer-wise decision on the mlp it is train_cnn of that config; over
    dense_decision() on resnet9 (granularity_study's baseline row:
    Identity / Identity through the DenseCodec wire path), with the
    telemetry leg on, it is train_cnn(model, None), the plain worker
    mean."""
    from repro_torch import experiment
    from repro_torch.control import CompressionDecision, StaticPolicy
    from repro_torch.convert import tree_leaves
    from repro_torch.core import Granularity, make_compressor
    model, kind = STATIC_CASES[case]
    if kind == "dense":
        d, comp = experiment.dense_decision(), None
    else:
        d = CompressionDecision(qw=make_compressor(kind, ratio=0.01),
                                granularity=Granularity("layerwise"))
        comp = d.to_config()
    final = []
    acc = experiment.cnn_accuracy
    monkeypatch.setattr(experiment, "cnn_accuracy",
                        lambda c, p, b: final.append(p) or acc(c, p, b))
    ctrl = experiment.cnn_controller(model, StaticPolicy(), base=d,
                                     collect_telemetry=kind == "dense")
    got = experiment.train_cnn_with_controller(model, ctrl, steps=2,
                                               device="cpu")
    assert got == experiment.train_cnn(model, comp, steps=2, device="cpu")
    assert ctrl.builds == 1 and ctrl.collect == (kind == "dense")
    a, b = (tree_leaves(p) for p in final)
    assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
    assert all(torch.isfinite(x).all() for x in a)


def test_adaptive_k_controller_builds_each_decision_once():
    """cnn_controller with AdaptiveKPolicy over top-k(1%) layer-wise on the
    mlp, re-planning every 2 of 6 steps (chip_smoke phase 12(a) runs
    resnet9 on the card): the telemetry window is measured and summarized, builds
    equal the distinct decisions the run took, and the last window's
    summary covers 2 steps. (A revisited allocation is a cache hit, so
    the switches may outnumber the builds.)"""
    from repro_torch.control import AdaptiveKPolicy, CompressionDecision
    from repro_torch.core import Granularity, make_compressor
    from repro_torch.experiment import (cnn_controller,
                                        train_cnn_with_controller)
    base = CompressionDecision(qw=make_compressor("topk", ratio=0.01),
                               granularity=Granularity("layerwise"))
    ctrl = cnn_controller("mlp", AdaptiveKPolicy(avg_ratio=0.01),
                          base=base, replan_every=2)
    seen = [base]
    step_fn = ctrl.step_fn

    def record():
        if ctrl.decision != seen[-1]:
            seen.append(ctrl.decision)
        return step_fn()
    ctrl.step_fn = record
    acc, loss = train_cnn_with_controller("mlp", ctrl, steps=6,
                                          device="cpu")
    assert np.isfinite(loss) and 0.0 <= acc <= 1.0
    assert ctrl.collect and len(ctrl.windows) == 3
    assert ctrl.windows[-1]["summary"]["steps"] == 2.0
    assert ctrl.builds == len(set(seen)) >= 2
    assert 1 + len(ctrl.switches) >= ctrl.builds
    assert ctrl.decision.ratio_overrides


def test_granularity_study_prints_the_reference_table(capsys,
                                                      monkeypatch):
    """`python -m repro_torch.granularity_study` with its training stubbed
    (each run builds its decision's step through the controller and
    returns a fake accuracy; test_cnn_controller_static_is_train_cnn
    holds the real loop): the reference's RUNS, header and one row per
    RUNS entry in its order with a verdict, the cache line with one
    build per distinct decision (13 for 13 rows), and the two adaptive
    rows."""
    from repro_torch import granularity_study as gs
    with _figures_reference():
        import examples.granularity_study as ref_gs
    assert gs.RUNS == ref_gs.RUNS
    runs = []

    def fake_train(model, ctrl, *, steps, device):
        ctrl.step_fn()
        runs.append((model, steps, device, ctrl.decision.describe()))
        return 0.1 + 0.01 * len(runs), 2.0
    monkeypatch.setattr(gs, "train_cnn_with_controller", fake_train)
    gs.main(["--steps", "1", "--model", "mlp", "--adaptive",
             "--replan-every", "1", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "model=mlp steps=1"
    assert out[1].split() == ["compressor", "layer-wise", "entire",
                              "baseline", "verdict"]
    rows = out[2:2 + len(gs.RUNS)]
    assert [r.split()[0] for r in rows] == [n for n, _ in gs.RUNS]
    for r in rows:
        assert r.endswith(("layer-wise better", "entire-model better",
                           "comparable"))
    assert out[2 + len(gs.RUNS)] == \
        "[cache] 13 built steps for 13 sweep rows (13 builds)"
    adaptive = out[-2:]
    assert [a.split()[0] for a in adaptive] == ["granularity_switch",
                                               "variance_budget"]
    for a in adaptive:
        assert re.search(r"final=layerwise/topk/simulated switches=0 "
                         r"builds=1$", a), a
    assert len(runs) == 15 and {r[:3] for r in runs} == {("mlp", 1, "cpu")}
