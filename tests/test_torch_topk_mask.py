"""The port's block-local top-k against the JAX package:

  ref.topk_mask_ref  vs kernels/ref.py:36 (jitted)
  ops.blockwise_topk vs kernels/ops.py:82 (topk_mask_pallas in interpret
                        mode; use_pallas=False at d = 121,002)

Every step is exact (row max, compares, integer counts, the same rounded
0.5 * (lo + hi)), so both are held bitwise. XLA compiles the reference's
multiply by the 0/1 mask into a select: a dropped entry is +0.0, also
where x is -0.0 or negative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_compress import DTYPES, SHAPES, _pair, _x, assert_bitwise
from test_torch_ref import reference

KS = [1, 5, 16, 128]


@pytest.mark.parametrize("k", KS + [0, 511, 512])
def test_topk_mask_ref_matches_reference_oracle(k):
    from repro_torch.kernels import ref as P
    x = _x((24, 512), k)
    x[1] = 0.0                                     # all-zero row
    x[2, ::3] = 1.5                                # ties at the threshold
    x[3] = np.float32(1e-30) * x[3]                # tiny magnitudes
    with reference() as ref:
        want = jax.jit(ref.ref.topk_mask_ref, static_argnums=1)(
            jnp.asarray(x), k)
    assert_bitwise(want, P.topk_mask_ref(torch.from_numpy(x), k))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_blockwise_topk_bitwise(shape, k, dtype):
    from repro_torch.kernels import ops
    jx, tx = _pair(_x(shape, k + 40), dtype)
    with reference() as ref:
        want = ref.ops.blockwise_topk(jx, k, use_pallas=True)
    got = ops.blockwise_topk(tx, k)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    assert_bitwise(want, got)


@pytest.mark.parametrize("k", [5, 128])
def test_blockwise_topk_bitwise_at_full_width(k):
    """resnet9's 121,002 gradient entries: 237 rows, the last one padded."""
    from repro_torch.kernels import ops
    x = _x((121002,), k)
    with reference() as ref:
        want = ref.ops.blockwise_topk(jnp.asarray(x), k, use_pallas=False)
    got = ops.blockwise_topk(torch.from_numpy(x), k)
    assert_bitwise(want, got)
    kept = (got.reshape(-1) != 0).sum().item()
    assert kept >= 237 * k - 1                     # >= k per row (ties: more)
