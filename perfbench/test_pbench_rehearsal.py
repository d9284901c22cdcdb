"""A smoke-size rehearsal of each cell on the CPU: the program's checked
steps (through the same Run the card drives, its window and tracing
left out) against the plain reference, judged by the cell's own limits;
and the mamba2 reference against the program's float32 path."""
import pytest

from pbench import check, harness
from pbench_smoke import one_thread, smoke_cell  # noqa: F401

SEED = 2**31 + 977


def _readings(cell, seed=SEED):
    r = harness.Run(cell, seed, "cpu")
    prog = r.checked()
    r.close()
    return harness.compare(cell, prog, harness.reference(cell, seed, "cpu"))


@pytest.mark.parametrize("name", ["phi4mini-qsgd16-layerwise",
                                  "phi4mini-qsgd16-entire",
                                  "phi4mini-topk1-layerwise"])
def test_cell_rehearsal_is_correct(name):
    cell = smoke_cell(name)
    nums = _readings(cell)
    assert set(nums) == set(check.NAMES)
    assert check.verdict(nums, cell.limits), nums
    # float32 on both sides: the same draws and units to rounding
    assert nums["grad_diff"] < 1e-3 and nums["loss"] < 1e-5


def test_mamba2_reference_is_the_programs_float32_path():
    cell = smoke_cell("phi4mini-qsgd16-layerwise", config="mamba2-1.3b",
                      traffic="qsgd16-layerwise-w4x2x2048")
    nums = _readings(cell)
    assert max(nums.values()) < 1e-3, nums
