"""The plain versions of the port's four kernels against the TPU kernels
they replace, run in interpret mode on the CPU:

  qsgd_pack       vs kernels/qsgd.py:122     qsgd_pack_pallas_rows
  qsgd_unpack     vs kernels/qsgd.py:151     qsgd_unpack_pallas_rows
  terngrad_pack   vs kernels/terngrad.py:92  terngrad_pack_pallas_rows
  terngrad_unpack vs kernels/terngrad.py:118 terngrad_unpack_pallas_rows

Both sides get the SAME norms / scales (the reference's ops._tile_rows /
_key_cols / _unit_col layout the TPU tiles), so words and decoded floats
must match bit for bit on arbitrary inputs. Against the reference's own
statistic (ops.*_units(use_pallas=False)) QSGD is compared on dyadic
inputs, whose sum of squares is exact in any order (the l2 norm is in the
payload and differs by ulps between torch and jnp otherwise).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_ref import np_bits, reference, tkeys


def _key_words(keys):
    """uint32 numpy key data -> the kernels' two int32 key-word columns."""
    kw = torch.from_numpy(np.ascontiguousarray(keys).view(np.int32))
    return kw[:, 0].contiguous(), kw[:, 1].contiguous()


WIDTH_LEVELS = [(2, 1), (4, 4), (6, 16), (8, 64)]
DIMS = [1, 31, 32, 700, 1300, 4608]


def _inputs(n, d, seed, dyadic=False):
    rng = np.random.default_rng(seed)
    if dyadic:
        x = rng.choice(np.float32([0, 0.25, -0.25, 0.5, -0.5, 1, -1, 2, -2]),
                       (n, d))
    else:
        x = rng.standard_normal((n, d)).astype(np.float32)
    keys = rng.integers(0, 2**32, (n, 2), dtype=np.uint64).astype(np.uint32)
    return x.astype(np.float32), keys


def _pallas_pack(ref, kind, x, keys, stat, levels=None, width=None):
    """The TPU pack kernel in interpret mode on the reference's tiling."""
    ops = ref.ops
    n, d = x.shape
    xt, rows, rpu = ops._tile_rows(jnp.asarray(x), ref.pack.PACK_R)
    R = xt.shape[0]
    k0, k1 = ops._key_cols(jnp.asarray(keys), rpu, R)
    sc = ops._unit_col(jnp.asarray(stat), rpu, R)
    if kind == "qsgd":
        wt = ref.qsgd.qsgd_pack_pallas_rows(xt, k0, k1, sc, levels, width,
                                            d=d, rpu=rpu, interpret=True)
    else:
        width = 2
        wt = ref.terngrad.terngrad_pack_pallas_rows(xt, k0, k1, sc, d=d,
                                                    rpu=rpu, interpret=True)
    return np.asarray(ops._untile_words(wt, n, rows,
                                        ops.words_per_unit(d, width)))


def _pallas_unpack(ref, kind, words, stat, d, levels=None, width=None):
    ops = ref.ops
    n = words.shape[0]
    width = 2 if kind == "terngrad" else width
    rpu = -(-d // ref.qsgd.BLOCK_C)
    wt, rows = ops._tile_word_rows(jnp.asarray(words), width, rpu,
                                   ref.pack.PACK_R)
    sc = ops._unit_col(jnp.asarray(stat), rpu, wt.shape[0])
    if kind == "qsgd":
        xt = ref.qsgd.qsgd_unpack_pallas_rows(wt, sc, levels, width,
                                              interpret=True)
    else:
        xt = ref.terngrad.terngrad_unpack_pallas_rows(wt, sc, interpret=True)
    return np.asarray(ops._untile_rows(xt, n, rows, d))


@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("width,levels", WIDTH_LEVELS)
def test_qsgd_plain_matches_pallas(width, levels, d):
    from repro_torch.kernels.qsgd import qsgd_pack_plain, qsgd_unpack_plain
    n = 3 if d <= 1300 else 2
    x, keys = _inputs(n, d, seed=d + width)
    tx, (k0, k1) = torch.from_numpy(x), _key_words(keys)
    nrm = torch.linalg.vector_norm(tx, dim=1) + 1e-12
    words = qsgd_pack_plain(tx, k0, k1, nrm, levels, width)
    fac = nrm / levels
    xhat = qsgd_unpack_plain(words, fac, d, levels, width)
    with reference() as ref:
        want = _pallas_pack(ref, "qsgd", x, keys, nrm.numpy(), levels, width)
        assert np.array_equal(want, np_bits(words))
        dec = _pallas_unpack(ref, "qsgd", want, fac.numpy(), d, levels,
                             width)
        assert np.array_equal(dec.view(np.uint32),
                              xhat.numpy().view(np.uint32))


@pytest.mark.parametrize("d", DIMS)
def test_terngrad_plain_matches_pallas(d):
    from repro_torch.kernels.terngrad import (terngrad_pack_plain,
                                              terngrad_unpack_plain)
    n = 3 if d <= 1300 else 2
    x, keys = _inputs(n, d, seed=7 * d)
    tx, (k0, k1) = torch.from_numpy(x), _key_words(keys)
    scale = tx.abs().amax(dim=1) + 1e-12
    words = terngrad_pack_plain(tx, k0, k1, scale)
    xhat = terngrad_unpack_plain(words, scale, d)
    with reference() as ref:
        want = _pallas_pack(ref, "terngrad", x, keys, scale.numpy())
        assert np.array_equal(want, np_bits(words))
        dec = _pallas_unpack(ref, "terngrad", want, scale.numpy(), d)
        assert np.array_equal(dec.view(np.uint32),
                              xhat.numpy().view(np.uint32))


@pytest.mark.parametrize("width,levels,d", [
    (w, s, d) for w, s in WIDTH_LEVELS for d in (1, 31, 700, 4608)]
    + [(6, 16, 121002)])
def test_qsgd_units_match_reference_on_dyadic_inputs(width, levels, d):
    from repro_torch.kernels import ops
    x, keys = _inputs(2, d, seed=d * 3 + width, dyadic=True)
    e = np.random.default_rng(d).standard_normal((2, d)).astype(np.float32)
    w, nrm = ops.qsgd_pack_units(torch.from_numpy(x), tkeys(keys), levels,
                                 width)
    xhat, m = ops.qsgd_unpack_ef_units(w, nrm, torch.from_numpy(e), d,
                                       levels, width)
    with reference() as ref:
        jw, jn = ref.ops.qsgd_pack_units(jnp.asarray(x), jnp.asarray(keys),
                                         levels, width, use_pallas=False)
        assert np.array_equal(np.asarray(jn), nrm.numpy())
        assert np.array_equal(np.asarray(jw), np_bits(w))
        jx, jm = ref.ops.qsgd_unpack_ef_units(jw, jn, jnp.asarray(e), d,
                                              levels, width,
                                              use_pallas=False)
        assert np.array_equal(np.asarray(jx), xhat.numpy())
        assert np.array_equal(np.asarray(jm), m.numpy())


@pytest.mark.parametrize("d", [1, 31, 700, 4608, 121002])
def test_terngrad_units_match_reference(d):
    from repro_torch.kernels import ops
    x, keys = _inputs(3, d, seed=d + 11)
    e = np.random.default_rng(d).standard_normal((3, d)).astype(np.float32)
    w, s = ops.terngrad_pack_units(torch.from_numpy(x), tkeys(keys))
    xhat, m = ops.terngrad_unpack_ef_units(w, s, torch.from_numpy(e), d)
    with reference() as ref:
        jw, js = ref.ops.terngrad_pack_units(jnp.asarray(x),
                                             jnp.asarray(keys),
                                             use_pallas=False)
        assert np.array_equal(np.asarray(js), s.numpy())
        assert np.array_equal(np.asarray(jw), np_bits(w))
        jx, jm = ref.ops.terngrad_unpack_ef_units(jw, js, jnp.asarray(e), d,
                                                  use_pallas=False)
        assert np.array_equal(np.asarray(jx), xhat.numpy())
        assert np.array_equal(np.asarray(jm), m.numpy())


def test_bytes_moved_counts():
    from repro_torch.kernels import ops
    assert ops.words_per_unit(121002, 6) == 22688
    assert ops.pack_bytes_moved(4, 121002, 6) == {
        "read": 4 * 4 * 121002 + 48, "write": 4 * 4 * 22688}
    assert ops.unpack_bytes_moved(4, 121002, 2) == {
        "read": 4 * 4 * 7563 + 16, "write": 4 * 4 * 121002}
    assert ops.pack_bytes_moved(4, 121002, 1, "sign") == {
        "read": 4 * 4 * 121002, "write": 4 * 4 * 3782}
    assert ops.unpack_bytes_moved(4, 121002, 9, "fields") == {
        "read": 4 * 4 * 34032, "write": 4 * 4 * 121002}
    assert ops.pack_bytes_moved(4, 1210, 17, "fields") == {
        "read": 4 * 4 * 1210, "write": 4 * 4 * 643}
