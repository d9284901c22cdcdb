"""The port's compressors and codecs of slice 2 against the reference
(core/compressors.py, core/wire.py): Random-k, Top-k, Threshold-v,
Adaptive Threshold, signSGD and natural compression, and the bf16 value
cast of the dense and sparse codecs.

Bitwise on random normal inputs with planted ties: sim outputs, the
sparse encode records in selection order (the order is the wire's byte
order), and the bf16 payload bytes. Natural compression holds a stated
tolerance instead: the reference takes floor(log2 |x|) and 2**e with
jnp.log2 / jnp.exp2, which are inexact on the CPU (exp2 is exact for 33
of the 254 normal exponents; floor(log2(2**e)) is one low at 23 of them),
while the port builds both exactly. So at most max(1, 1e-5 n) of n codes
differ, each by one exponent step, and where the codes agree the decoded
values differ by at most 2e-6 relative (the reference's exp2 error).
Inputs stay clear of subnormals, which the reference flushes to zero.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_ref import key_data, reference, tkeys

DIMS = [1, 10, 700, 4608]


def _inputs(n, d, seed, ties=True):
    """(n, d) f32 normal rows with planted ties: every 50th entry is +-3
    (the largest magnitudes, so top-k and the caps break ties among
    them), a run of equal small values, and zeros."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    if ties and d > 2:
        x[:, ::50] = rng.choice(np.float32([-3, 3]), x[:, ::50].shape)
        x[:, 1:d // 3:7] = np.float32(0.25)
        x[:, 2::11] = 0.0
    keys = rng.integers(0, 2**32, (n, 2), dtype=np.uint64).astype(np.uint32)
    return x, keys


def _pair(ref, name, **kw):
    from repro_torch.core.compressors import make_compressor
    return make_compressor(name, **kw), ref.core.make_compressor(name, **kw)


COMPRESSORS = [("topk", {}), ("topk", {"ratio": 0.1}),
               ("randomk", {}), ("randomk", {"scale": True}),
               ("randomk", {"ratio": 0.1, "scale": True}),
               ("threshold_v", {}), ("threshold_v", {"v": 0.5,
                                                     "cap_ratio": 0.1}),
               ("adaptive_threshold", {}),
               ("adaptive_threshold", {"alpha": 0.3, "cap_ratio": 0.05}),
               ("signsgd", {})]


@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("name,kw", COMPRESSORS,
                         ids=[f"{n}-{sorted(k.items())}"
                              for n, k in COMPRESSORS])
def test_sim_and_records_bitwise(name, kw, d):
    x, keys = _inputs(3, d, seed=d + len(name))
    with reference() as ref:
        mine, theirs = _pair(ref, name, **kw)
        tx, tk = torch.from_numpy(x), tkeys(keys)
        jx, jk = jnp.asarray(x), jnp.asarray(keys)
        want = np.asarray(jax.vmap(theirs.sim)(jx, jk))
        got = mine.sim(tx, tk).numpy()
        assert np.array_equal(want.view(np.uint32), got.view(np.uint32))
        if name == "signsgd":
            return
        rec = jax.vmap(theirs.encode)(jx, jk)
        mrec = mine.encode(tx, tk)
        assert np.array_equal(np.asarray(rec["idx"]), mrec["idx"].numpy())
        assert np.array_equal(np.asarray(rec["val"]).view(np.uint32),
                              mrec["val"].numpy().view(np.uint32))
        for dd in (1, 2, 700, 36864, 121002):
            assert mine.payload_bits(dd) == theirs.payload_bits(dd)
            assert mine.omega(dd) == theirs.omega(dd)


@pytest.mark.parametrize("ratio", [0.01, 0.25])
def test_randomk_tied_scores_keep_index_order(ratio):
    """At d = 36,864 equal f32 uniform scores are common (these keys draw
    tied scores inside the selected k); lax.top_k keeps them in index
    order, and so must the port (torch.topk does not)."""
    from repro_torch.kernels.prng import uniform_rows
    x, keys = _inputs(2, 36864, seed=6, ties=False)
    k = round(ratio * 36864)
    top = torch.sort(uniform_rows(tkeys(keys), 36864), dim=1,
                     descending=True)[0][:, :k]
    assert all(len(torch.unique(r)) < k for r in top)
    with reference() as ref:
        mine, theirs = _pair(ref, "randomk", ratio=ratio)
        rec = jax.vmap(theirs.encode)(jnp.asarray(x), jnp.asarray(keys))
        got = mine.encode(torch.from_numpy(x), tkeys(keys))["idx"].numpy()
        assert np.array_equal(np.asarray(rec["idx"]), got)


def test_stable_sort_is_lax_top_k_order():
    from repro_torch.core.compressors import _top_idx
    v = [1, 3, 3, 2, 3, 0, 3]
    _, want = jax.lax.top_k(jnp.asarray(v, jnp.float32), 4)
    got = _top_idx(torch.tensor([v], dtype=torch.float32), 4)[0]
    assert np.asarray(want).tolist() == got.tolist() == [1, 2, 4, 6]


def test_index_bits_and_k_match_reference():
    from repro_torch.core.compressors import _k_of, index_bits
    with reference() as ref:
        for d in (1, 2, 3, 10, 16, 432, 4608, 36864, 121002):
            assert index_bits(d) == ref.compressors.index_bits(d)
            for r in (0.001, 0.01, 0.25, 1.0):
                assert _k_of(r, d) == ref.compressors._k_of(r, d)


def _natural_inputs(n, d, seed):
    """Normal entries at per-entry scales 10**U(-8, 0), with zeros: every
    |x| is a normal f32 far from the subnormal range."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)) * 10.0 ** rng.uniform(-8, 0, (n, d))
    x = x.astype(np.float32)
    x[:, ::13] = 0.0
    keys = rng.integers(0, 2**32, (n, 2), dtype=np.uint64).astype(np.uint32)
    return x, keys


def _natural_codes_close(want, got):
    """Codes sign*(e + 128): equal except at most max(1, 1e-5 n) entries,
    each one exponent step off with the same sign."""
    diff = want != got
    assert diff.sum() <= max(1, int(1e-5 * want.size)), int(diff.sum())
    if diff.any():
        assert np.all(np.abs(want[diff] - got[diff]) == 1)
        assert np.all(np.sign(want[diff]) == np.sign(got[diff]))
    return ~diff


@pytest.mark.parametrize("d", [10, 700, 36864])
def test_natural_within_stated_tolerance(d):
    from repro_torch.core.wire import wire_codec
    from repro_torch.kernels import ops
    x, keys = _natural_inputs(4, d, seed=d)
    with reference() as ref:
        mine, theirs = _pair(ref, "natural")
        jx, jk = jnp.asarray(x), jnp.asarray(keys)
        want_sim = np.asarray(jax.vmap(theirs.sim)(jx, jk))
        want_code = np.asarray(jax.vmap(theirs.encode)(jx, jk)["code"],
                               np.int64)
    tx, tk = torch.from_numpy(x), tkeys(keys)
    e, sgn, zero = mine._exponents(tx, tk)
    code = torch.where(zero, 0, sgn.to(torch.int32) * (e + 128)).numpy()
    same = _natural_codes_close(want_code, code)
    got_sim = mine.sim(tx, tk).numpy()
    np.testing.assert_allclose(got_sim[same], want_sim[same], rtol=2e-6,
                               atol=0)
    assert np.array_equal(got_sim == 0, x == 0)
    # the port's own wire is exact: payload codes are the sim's codes
    codec = wire_codec(mine)
    pay = codec.encode_batch(tx, tk)
    words = pay.view(torch.int32)
    assert np.array_equal(ops.fields_unpack_units(words, d, 9).numpy(),
                          code + 255)


def test_exact_powers_of_two():
    """pow2 is 2**e bit for bit on all 254 normal exponents; frexp gives
    floor(log2 x) exactly at every power of two."""
    from repro_torch.core.compressors import pow2
    e = torch.arange(-126, 128)
    want = np.ldexp(np.float32(1), e.numpy()).astype(np.float32)
    got = pow2(e).numpy()
    assert np.array_equal(want.view(np.uint32), got.view(np.uint32))
    assert torch.equal(torch.frexp(pow2(e)).exponent - 1, e.to(torch.int32))


# ---- bf16 value cast and codec errors (ROADMAP Queue 3 item 4, repaired) ---

@pytest.mark.parametrize("name", ["identity", "topk", "randomk",
                                  "threshold_v", "adaptive_threshold"])
@pytest.mark.parametrize("d", [1, 7, 700, 4608])
def test_bf16_value_cast_bytes_match_reference(name, d):
    from repro_torch.core.wire import wire_codec
    x, keys = _inputs(3, d, seed=3 * d + len(name))
    x[:, -1] = np.float32(1.00390625)   # halfway between two bf16 values
    with reference() as ref:
        mine, theirs = _pair(ref, name)
        codec = wire_codec(mine, wire_dtype="bfloat16")
        jcodec = ref.core.wire_codec(theirs, wire_dtype="bfloat16")
        assert not codec.exact_sim and not jcodec.exact_sim
        for dd in (1, 7, 700, 121002):
            assert codec.nbytes(dd) == jcodec.nbytes(dd)
            assert codec.payload_bits(dd) == jcodec.payload_bits(dd)
            assert codec.padding_bits(dd) == jcodec.padding_bits(dd)
        pay = codec.encode_batch(torch.from_numpy(x), tkeys(keys))
        jpay = jcodec.encode_batch(jnp.asarray(x), jnp.asarray(keys))
        assert np.array_equal(np.asarray(jpay), pay.numpy())
        dec = codec.decode_batch(pay, d).numpy()
        jdec = np.asarray(jcodec.decode_batch(jpay, d))
        assert np.array_equal(jdec.view(np.uint32), dec.view(np.uint32))


@pytest.mark.parametrize("name", ["qsgd", "terngrad", "signsgd", "natural"])
def test_bf16_refused_where_there_are_no_value_records(name):
    from repro_torch.core.wire import wire_codec
    with reference() as ref:
        mine, theirs = _pair(ref, name)
        for dtype in ("bfloat16", "float16"):
            with pytest.raises(ValueError) as jerr:
                ref.core.wire_codec(theirs, wire_dtype=dtype)
            with pytest.raises(ValueError) as err:
                wire_codec(mine, wire_dtype=dtype)
            assert str(err.value) == str(jerr.value)


def test_codec_dispatch_matches_reference():
    from repro_torch.core.compressors import make_compressor
    from repro_torch.core.wire import wire_codec
    with reference() as ref:
        for name in ref.core.available_compressors():
            mine, theirs = make_compressor(name), ref.core.make_compressor(
                name)
            c, jc = wire_codec(mine), ref.core.wire_codec(theirs)
            assert type(c).__name__ == type(jc).__name__
            assert c.exact_sim == jc.exact_sim
            for d in (1, 31, 32, 700, 36864, 121002):
                assert c.nbytes(d) == jc.nbytes(d)
                assert c.payload_bits(d) == jc.payload_bits(d)
                assert c.padding_bits(d) == jc.padding_bits(d)


@pytest.mark.parametrize("d", [1, 33, 700])
@pytest.mark.parametrize("name", ["signsgd", "natural", "topk", "randomk"])
def test_codec_batches_match_reference(name, d):
    """encode_batch / decode_batch / decode_ef_batch of one bucket, with the
    reference's fused batch paths: bytes equal (natural: codes within the
    stated tolerance), decoded values and EF residuals bitwise."""
    from repro_torch.core.wire import wire_codec
    from repro_torch.kernels import ops
    x, keys = (_natural_inputs(3, d, seed=d) if name == "natural"
               else _inputs(3, d, seed=d))
    e = np.random.default_rng(d).standard_normal((3, d)).astype(np.float32)
    with reference() as ref:
        mine, theirs = _pair(ref, name)
        codec, jcodec = wire_codec(mine), ref.core.wire_codec(theirs)
        pay = codec.encode_batch(torch.from_numpy(x), tkeys(keys))
        jpay = np.asarray(jcodec.encode_batch(jnp.asarray(x),
                                              jnp.asarray(keys)))
        assert jpay.shape == tuple(pay.shape) == (3, codec.nbytes(d))
        if name == "natural":
            mc = ops.fields_unpack_units(pay.view(torch.int32), d, 9)
            jc = ops.fields_unpack_units(
                torch.from_numpy(jpay.view(np.int32).copy()), d, 9)
            _natural_codes_close(jc.numpy() - 255, mc.numpy() - 255)
            pay = torch.from_numpy(jpay.copy())   # decode the same bytes
        else:
            assert np.array_equal(jpay, pay.numpy())
        xhat, m = codec.decode_ef_batch(pay, torch.from_numpy(e), d)
        jx, jm = jcodec.decode_ef_batch(jnp.asarray(jpay), jnp.asarray(e), d)
        if name == "natural":
            np.testing.assert_allclose(xhat.numpy(), np.asarray(jx),
                                       rtol=2e-6, atol=0)
        else:
            assert np.array_equal(np.asarray(jx).view(np.uint32),
                                  xhat.numpy().view(np.uint32))
            assert np.array_equal(np.asarray(jm).view(np.uint32),
                                  m.numpy().view(np.uint32))


@pytest.mark.parametrize("name", ["identity", "qsgd", "terngrad", "signsgd",
                                  "natural", "topk", "randomk"])
def test_port_codecs_round_trip_to_sim(name):
    """Port-only: decode(encode(x)) == sim(x) bit for bit for every exact
    codec, natural included (its powers of two are exact on both legs)."""
    from repro_torch.core.compressors import make_compressor
    from repro_torch.core.wire import wire_codec
    comp = make_compressor(name)
    codec = wire_codec(comp)
    assert codec.exact_sim
    for d in (1, 31, 700, 36864):
        x, keys = (_natural_inputs(4, d, seed=d) if name == "natural"
                   else _inputs(4, d, seed=d))
        tx, tk = torch.from_numpy(x), tkeys(keys)
        got = codec.decode_batch(codec.encode_batch(tx, tk), d).numpy()
        want = comp.sim(tx, tk).numpy()
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def test_unit_keys_reach_the_codecs():
    """A codec's per-unit keys are the plan's unit keys (key_data of the
    reference's per-unit folds): randomk picks the same indices."""
    from repro_torch import random as R
    from repro_torch.core.compressors import RandomK
    with reference():
        k = jax.random.fold_in(jax.random.key(3), 7)
        idx = RandomK()._indices(4608, tkeys(key_data(k))[None])
        ref_idx = jax.lax.top_k(jax.random.uniform(k, (4608,)), 46)[1]
        assert np.array_equal(np.asarray(ref_idx), idx[0].numpy())
        assert np.array_equal(R.fold_in(R.key(3), 7).numpy(), key_data(k))
