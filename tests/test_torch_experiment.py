"""Port-only: the paper's core experiment, compare_granularities, runs end
to end on resnet9 at its config width on the CPU for every compressor of
the registry (2 steps per granularity and the dense baseline), through
the plain versions: no kernel launches on the CPU."""
import math

import pytest

PAPER_COMPRESSORS = ["randomk", "topk", "threshold_v", "adaptive_threshold",
                     "terngrad", "qsgd", "signsgd", "natural"]


@pytest.mark.parametrize("qname", PAPER_COMPRESSORS)
def test_compare_granularities_resnet9_every_compressor(qname):
    from repro_torch import kernels
    from repro_torch.experiment import compare_granularities
    kernels.reset_launch_counts()
    out = compare_granularities("resnet9", qname, steps=2, device="cpu")
    assert sorted(out) == ["baseline", "entire_model", "layerwise"]
    assert all(math.isfinite(v) and 0.0 <= v <= 1.0 for v in out.values())
    assert set(kernels.launch_counts().values()) == {0}


def test_make_compressor_builds_the_whole_registry():
    from repro_torch.core.compressors import make_compressor
    for name in ["identity"] + PAPER_COMPRESSORS:
        assert make_compressor(name).name == name
    with pytest.raises(ValueError, match="unknown compressor"):
        make_compressor("powersgd")
