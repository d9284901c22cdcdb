"""The plain versions of the port's sign and field kernels against the TPU
kernels they replace, run in interpret mode on the CPU through the
reference's own tiling (ops.*_units(use_pallas=True) -> ops._tile_rows),
and against the reference's jnp fallback (use_pallas=False):

  sign_pack     vs kernels/sign.py:49  sign_pack_pallas_rows
  sign_unpack   vs kernels/sign.py:67  sign_unpack_pallas_rows
  fields_pack   vs kernels/pack.py:94  fields_pack_pallas
  fields_unpack vs kernels/pack.py:111 fields_unpack_pallas

No statistic and no randomness enters these kernels, so every comparison
is bitwise on arbitrary inputs: sign inputs hold zeros, -0.0 and a NaN,
unpack inputs are random words (padding bits included).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_ref import np_bits, reference

SIGN_DIMS = [1, 31, 32, 700, 4608]
WIDTHS = [1, 4, 9, 13, 16, 17, 24, 31]
FIELD_KS = [1, 31, 32, 369, 1300]


def _sign_inputs(n, d, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    x[:, ::5] = 0.0
    x[:, 2::7] = -0.0
    x[0, -1] = np.nan
    return x


def _words(n, wpu, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**32, (n, wpu), dtype=np.uint64).astype(
        np.uint32)


def _i32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


@pytest.mark.parametrize("d", SIGN_DIMS)
def test_sign_plain_matches_pallas_and_reference(d):
    from repro_torch.kernels import ops
    from repro_torch.kernels.sign import sign_pack_plain, sign_unpack_plain
    n = 3 if d <= 700 else 2
    x = _sign_inputs(n, d, seed=d)
    words = sign_pack_plain(torch.from_numpy(x))
    rand = _words(n, ops.words_per_unit(d, 1), seed=d + 1)
    dec = sign_unpack_plain(_i32(rand), d)
    e = np.random.default_rng(d).standard_normal((n, d)).astype(np.float32)
    xhat, m = ops.sign_unpack_ef_units(_i32(rand), torch.from_numpy(e), d)
    with reference() as ref:
        for use_pallas in (True, False):
            jw = ref.ops.sign_pack_units(jnp.asarray(x),
                                         use_pallas=use_pallas)
            assert np.array_equal(np.asarray(jw), np_bits(words))
            jd = ref.ops.sign_unpack_units(jnp.asarray(rand), d,
                                           use_pallas=use_pallas)
            assert np.array_equal(np.asarray(jd).view(np.uint32),
                                  dec.numpy().view(np.uint32))
        jx, jm = ref.ops.sign_unpack_ef_units(jnp.asarray(rand),
                                              jnp.asarray(e), d,
                                              use_pallas=False)
        assert np.array_equal(np.asarray(jx), xhat.numpy())
        assert np.array_equal(np.asarray(jm), m.numpy())
    assert set(np.unique(dec.numpy())) <= {-1.0, 1.0}


@pytest.mark.parametrize("k", FIELD_KS)
@pytest.mark.parametrize("width", WIDTHS)
def test_fields_plain_matches_pallas_and_reference(width, k):
    from repro_torch.kernels import ops
    from repro_torch.kernels.pack import fields_pack_plain, fields_unpack_plain
    n = 3 if k <= 369 else 2
    rng = np.random.default_rng(width * 100 + k)
    f = rng.integers(0, 2**width, (n, k)).astype(np.int32)
    words = fields_pack_plain(torch.from_numpy(f), width)
    rand = _words(n, ops.words_per_unit(k, width), seed=k + width)
    dec = fields_unpack_plain(_i32(rand), k, width)
    assert dec.dtype == torch.int32
    assert np.array_equal(
        ops.unpack_fields(words[0], k, width).numpy(), f[0])
    with reference() as ref:
        for use_pallas in (True, False):
            jw = ref.ops.fields_pack_units(jnp.asarray(f), width,
                                           use_pallas=use_pallas)
            assert np.array_equal(np.asarray(jw), np_bits(words))
            jd = ref.ops.fields_unpack_units(jnp.asarray(rand), k, width,
                                             use_pallas=use_pallas)
            assert np.array_equal(np.asarray(jd), dec.numpy())
        jv = ref.ops.pack_fields(jnp.asarray(f[0]), width)
        assert np.array_equal(np.asarray(jv),
                              np_bits(ops.pack_fields(
                                  torch.from_numpy(f[0]), width)))


@pytest.mark.parametrize("width", [0, 32])
def test_field_wrappers_refuse_widths_outside_1_to_31(width):
    from repro_torch.kernels.pack import fields_pack, fields_unpack
    f = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="out of range"):
        fields_pack(f, width)
    with pytest.raises(ValueError, match="out of range"):
        fields_unpack(f, 4, width)
