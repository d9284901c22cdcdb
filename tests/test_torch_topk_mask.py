"""The port's block-local top-k against the JAX package:

  ref.topk_mask_ref        vs kernels/ref.py:36 (jitted)
  topk_mask_rounds_plain   vs kernels/ref.py:36 (jitted) (the kernel's
                              own scheme: whole-row steps, then the
                              [lo, hi) list)
  ops.blockwise_topk       vs kernels/ops.py:82 (topk_mask_pallas in
                              interpret mode; use_pallas=False at
                              d = 121,002), f32 and bf16 through
                              topk_mask_flat, other dtypes cast

Every step is exact (row max, compares, integer counts, the same rounded
0.5 * (lo + hi)), so all are held bitwise. XLA compiles the reference's
multiply by the 0/1 mask into a select: a dropped entry is +0.0, also
where x is -0.0 or negative.
"""
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_compress import DTYPES, SHAPES, _pair, _x, assert_bitwise
from test_torch_ref import reference

KS = [1, 5, 16, 128]
EDGE_KS = [0, 1, 5, 16, 128, 511, 512, 600]


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


def _special_rows():
    """(24, 512) f32: Gaussian rows beside rows where the bisection and
    the kernel's [lo, hi) list are most fragile."""
    rng = np.random.default_rng(22)
    x = rng.standard_normal((24, 512)).astype(np.float32)
    x[1] = 0.0                                     # every count 512
    x[2] = 2.0                                     # equal values: the same
    x[3, ::3] = 1.5                                # ties at the threshold
    x[4, 7] = np.nan
    x[5, 9] = np.inf
    x[6, 3] = -np.inf
    x[7] = -0.0
    x[8] = np.float32(1e-30) * x[8]                # tiny magnitudes
    x[9] = np.float32(1e-45) * np.sign(x[9])       # subnormals
    x[10] = np.float32(3e38) * np.sign(x[10])      # counted whole (>= 2^126)
    x[11, 5] = np.float32(2.0**126)
    x[12] = 1 + np.arange(512, dtype=np.float32) * np.float32(1e-7)
    x[13, :300] = 0.0                              # mostly zeros
    x[14] = rng.uniform(0.99, 1.0, 512).astype(np.float32)
    x[15] = np.repeat(np.arange(64, dtype=np.float32), 8)
    x[16, ::2] = 0.0
    x[16, 1::2] = -1.0
    return x


def _rows(kind):
    """(24, 512) f32 rows for the kernel's scheme, by the path they take:
    special (_special_rows), Gaussian (every 7th entry 0: listed after
    1-4 whole-row steps), sparse (a few nonzeros a row: at k above them
    the zeros stay in [lo, hi) and every step counts the whole row),
    clustered (magnitudes within 1e-5 of each other: listed late) and
    huge (row max >= 2^126: the whole row at every step)."""
    if kind == "special":
        return _special_rows()
    rng = np.random.default_rng(["gaussian", "sparse", "clustered",
                                 "huge"].index(kind))
    x = rng.standard_normal((24, 512)).astype(np.float32)
    if kind == "gaussian":
        x[:, ::7] = 0.0
    elif kind == "sparse":
        keep = rng.random((24, 512)) < (np.arange(24) + 1)[:, None] / 512
        x = np.where(keep, x, np.float32(0.0))
    elif kind == "clustered":
        x = np.sign(x) * (1 + rng.uniform(0, 1e-5, x.shape)).astype(
            np.float32)
    else:
        x = np.clip(x, -6, 6) * np.float32(5e37)
    return x


@functools.lru_cache(maxsize=None)
def _reference_masked(k, kind):
    with reference() as ref:
        return np.asarray(jax.jit(ref.ref.topk_mask_ref, static_argnums=1)(
            jnp.asarray(_rows(kind)), k))


@pytest.mark.parametrize("rows", ["special", "gaussian", "sparse",
                                  "clustered", "huge"])
@pytest.mark.parametrize("k", EDGE_KS)
def test_topk_mask_rounds_plain_bitwise(k, rows):
    """The kernel's scheme (csrc/topk_mask.cu threshold) equals the
    reference's 24 sequential whole-row steps on every row set."""
    from repro_torch.kernels import ref as P
    from repro_torch.kernels import topk_mask as K
    x = torch.from_numpy(_rows(rows))
    got = K.topk_mask_rounds_plain(x, k)
    assert_bitwise(_reference_masked(k, rows), got)
    assert_bitwise(P.topk_mask_ref(x, k), got)


def test_topk_mask_rounds_plain_counts_a_full_row():
    """A row whose every count is 512 (zeros) and a row of distinct
    values whose [lo, hi) list is taken after the first step: the 10-bit
    fields hold 512, and the list path equals the whole-row count."""
    from repro_torch.kernels import ref as P
    from repro_torch.kernels import topk_mask as K
    x = torch.zeros((2, 512))
    x[1] = torch.linspace(1.0, 2.0, 512)
    for k in (0, 5, 511, 512):
        assert_bitwise(P.topk_mask_ref(x, k), K.topk_mask_rounds_plain(x, k))
    assert K._warp_counts(x[0].reshape(32, 16), [torch.tensor(0.0)] * 2) \
        == [512, 512]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [1, 511, 512, 513, 121002])
def test_blockwise_topk_flat_bitwise(d, dtype):
    """blockwise_topk on a flat input (one launch of topk_mask_flat on the
    card; its plain version here): the tail row's padding and the casts
    as the reference's, interpret-mode Pallas up to 513 entries and its
    plain path at resnet9's 121,002."""
    from repro_torch.kernels import ops
    x = _x((d,), d)
    x[: min(d, 40)] = np.float32(2.0)             # ties in the first row
    jx, tx = _pair(x, dtype)
    with reference() as ref:
        want = ref.ops.blockwise_topk(jx, 5, use_pallas=d <= 513)
    got = ops.blockwise_topk(tx, 5)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    assert_bitwise(want, got)


def test_blockwise_topk_other_dtypes_cast_route():
    """f16 is cast to f32 for topk_mask_flat and back, as the reference
    casts it."""
    from repro_torch.kernels import ops
    x = _x((3, 700), 3)
    with reference() as ref:
        want = ref.ops.blockwise_topk(jnp.asarray(x).astype(jnp.float16), 16,
                                      use_pallas=True)
    got = ops.blockwise_topk(torch.from_numpy(x).to(torch.float16), 16)
    assert got.dtype == torch.float16 and got.shape == (3, 700)
    assert np.array_equal(np.asarray(want).view(np.uint16),
                          got.numpy().view(np.uint16))


def test_topk_mask_flat_checks_inputs_and_counts_no_cpu_launch():
    from repro_torch import kernels
    from repro_torch.kernels import topk_mask as K
    x = torch.ones((3, 5))
    out = K.flat_output(x, 5)
    assert out.shape == x.shape and out.dtype == x.dtype
    assert K.flat_output(x.to(torch.bfloat16), -1).dtype == torch.bfloat16
    for bad in (x.double(), x.half(), x.long()):
        with pytest.raises(ValueError, match="f32 or bf16"):
            K.flat_output(bad, 5)
    with pytest.raises(ValueError, match="contiguous"):
        K.flat_output(torch.ones((5, 3)).t(), 5)
    for k in (2**31, -2**31 - 1, 5.0, None):
        with pytest.raises(ValueError, match="int32"):
            K.flat_output(x, k)
    # meta takes the shape function (the dry run); a device with no kernel
    # raises (an XPU stand-in: this CPU build has no other device)
    with pytest.raises(ValueError, match="no kernel"):
        K.topk_mask_flat(types.SimpleNamespace(device=torch.device("xpu")),
                         1)
    kernels.reset_launch_counts()
    for dtype in (torch.float32, torch.bfloat16):
        y = K.topk_mask_flat(torch.arange(600.0).to(dtype), 2)
        assert y.dtype == dtype and y.shape == (600,)
        kept = y.float().nonzero().reshape(-1).tolist()
        # count(|x| >= lo) > k: three a row in f32, more in bf16, whose
        # rounding makes ties
        if dtype == torch.float32:
            assert kept == [509, 510, 511, 597, 598, 599]
        else:
            assert len(kept) > 6 and {511, 599} <= set(kept)
    assert K.topk_mask_flat(torch.empty(0), 3).shape == (0,)
    assert kernels.launch_counts()["topk_mask"] == 0
