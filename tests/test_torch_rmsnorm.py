"""The port's RMSNorm against the JAX package:

  ref.rmsnorm_ref vs kernels/ref.py:215
  ops.rmsnorm     vs kernels/ops.py:665 (rmsnorm_pallas in interpret mode)

Stated tolerance: the row mean of squares is summed in another order by
torch and by the reference (its own Pallas kernel and its jnp oracle differ
by up to 9.5e-7 in f32), so f32 results agree within 1e-6 relative, and
bf16 results are equal except at most 0.1% of entries one bf16 ulp
(2**-7 relative) apart.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_compress import DTYPES, _pair
from test_torch_ref import reference

DIMS = [128, 384, 3072]


def _inputs(rows, D, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((rows, D)) * rng.uniform(0.1, 10, (rows, 1)))
    g = rng.uniform(0.5, 1.5, D)
    return x.astype(np.float32), g.astype(np.float32)


def assert_rmsnorm_close(want, got, dtype):
    want = np.asarray(want, np.float32)
    got = got.to(torch.float32).numpy()
    assert want.shape == got.shape
    if dtype == "f32":
        assert np.all(np.abs(want - got) <= 1e-6 * np.abs(want))
        return
    off = want != got
    assert off.mean() <= 1e-3, off.mean()
    assert np.all(np.abs(want - got)[off] <= 2.0**-7 * np.abs(want[off]))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("D", DIMS)
def test_rmsnorm_ref_matches_reference_oracle(D, dtype):
    from repro_torch.kernels import ref as P
    x, g = _inputs(64, D, D)
    jx, tx = _pair(x, dtype)
    with reference() as ref:
        want = ref.ref.rmsnorm_ref(jx, jnp.asarray(g))
    assert_rmsnorm_close(want, P.rmsnorm_ref(tx, torch.from_numpy(g)), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("D", DIMS)
@pytest.mark.parametrize("lead", [(5,), (2, 70)], ids=str)
def test_rmsnorm_matches_reference(lead, D, dtype):
    from repro_torch.kernels import ops
    x, g = _inputs(int(np.prod(lead)), D, D + len(lead))
    jx, tx = _pair(x.reshape(lead + (D,)), dtype)
    with reference() as ref:
        want = ref.ops.rmsnorm(jx, jnp.asarray(g), use_pallas=True)
    got = ops.rmsnorm(tx, torch.from_numpy(g))
    assert got.dtype == tx.dtype and got.shape == tx.shape
    assert_rmsnorm_close(want, got, dtype)


def test_rmsnorm_needs_a_multiple_of_128():
    from repro_torch.kernels import ops
    with pytest.raises(ValueError, match="D % 128"):
        ops.rmsnorm(torch.zeros((2, 100)), torch.ones(100))
