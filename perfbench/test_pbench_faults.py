"""The comparison fails what it must, at smoke size on the CPU: the
float8 control (the reference with every matrix product in float8 e4m3)
and the program with a step that returns its state unchanged or with
half of the workers' gradients left out, each judged by the cell's own
limits; and the model FLOP count against the port's dispatch counter."""
import pytest
import torch

import readings
from pbench import check, harness
from pbench.program import Program
from pbench.ref_common import fp8_matmul
from pbench.ref_step import make_params
from pbench_smoke import SEQ, one_thread, smoke_cell  # noqa: F401

SEED = 2**31 + 4242
CELL = "phi4mini-qsgd16-layerwise"


def _checked(cell, patch=None):
    r = harness.Run(cell, SEED, "cpu")
    restore = patch(r.program) if patch else (lambda: None)
    try:
        prog = r.checked()
    finally:
        restore()
    r.close()
    return prog


def _unchanged(program):
    exp = program.experiment
    orig = exp.lm_train_step

    def step(model, comp, params, *a, **kw):
        return params, orig(model, comp, params, *a, **kw)[1]
    exp.lm_train_step = step

    def restore():
        exp.lm_train_step = orig
    return restore


def test_control_is_not_correct():
    cell = smoke_cell(CELL)
    ref = harness.reference(cell, SEED, "cpu")
    ctl = harness.reference(cell, SEED, "cpu", mm=fp8_matmul)
    assert not check.verdict(harness.compare(cell, ctl, ref), cell.limits)


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_faults_are_not_correct(fault):
    cell = smoke_cell(CELL)
    patch = _unchanged if fault == "unchanged" else readings.half_batch
    nums = harness.compare(cell, _checked(cell, patch),
                           harness.reference(cell, SEED, "cpu"))
    assert not check.verdict(nums, cell.limits), nums
    if fault == "unchanged":
        assert nums["change_norm"] == pytest.approx(1.0)


@pytest.mark.parametrize("name,config", [
    ("phi4mini-qsgd16-layerwise", None),
    ("phi4mini-qsgd16-layerwise", "mamba2-1.3b")])
def test_flops_against_the_dispatch_counter(name, config):
    """The port's StepCost counts every matrix product a smoke step's
    forward and backward dispatch: at least the model FLOPs (recomputed
    layers and full attention blocks only add), and not half as much
    again."""
    from repro_torch.launch.hlo_cost import StepCost
    cell = smoke_cell(name, config=config)
    lv = cell.family.leaves(cell.config)
    prog = Program(cell.family.program_fields(cell.config), lv,
                   cell.traffic, "cpu")
    leaves = {k: v.requires_grad_(True) for k, v in
              make_params(lv, SEED, torch.float32, "cpu").items()}
    tok = torch.randint(0, cell.config["vocab_size"], (2, SEQ + 1))
    cost = StepCost()
    cost.arguments(leaves)
    with cost:
        loss = prog.model.loss(prog.tree(leaves), {
            "tokens": tok[:, :-1], "targets": tok[:, 1:]}, None)
        torch.autograd.grad(loss, list(leaves.values()))
    ours = cell.family.flops_per_token(cell.config, SEQ) * 2 * SEQ
    assert 1.0 <= cost.flops / ours <= 1.5
