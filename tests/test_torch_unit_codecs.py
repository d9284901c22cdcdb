"""The per-unit codec path of slice 3 against the reference: the
compressors' payload records (compressors.py encode / decode), every wire
codec's per-unit encode / decode / roundtrip and its fused=False batches
(core/wire.py:343-395 and each class), and the signSGD majority vote on
packed payloads (wire.py:579-594).

Bitwise throughout. Input families: QSGD takes dyadic entries
({0, +-0.25, +-0.5, +-1, +-2}: the sum of squares, and so the l2 norm in
the payload, is exact in any order); natural compression takes
magnitudes in [2^-3, 2^3) and zeros, exponents where the reference's CPU
log2 / exp2 are exact (its tolerance elsewhere is ROADMAP Queue 3 item
4); the rest random normal with planted ties (test_torch_codecs.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_codecs import _inputs
from test_torch_ref import reference, tkeys

DIMS = [1, 700]
NAMES = ["identity", "qsgd", "terngrad", "signsgd", "natural", "topk",
         "randomk", "threshold_v", "adaptive_threshold"]


def _unit_inputs(name, n, d, seed):
    x, keys = _inputs(n, d, seed)
    rng = np.random.default_rng(seed + 1)
    if name == "qsgd":
        x = rng.choice(np.float32([0, .25, -.25, .5, -.5, 1, -1, 2, -2]),
                       (n, d)).astype(np.float32)
    elif name == "natural":
        x = (rng.choice(np.float32([-1, 1]), (n, d))
             * 2.0 ** rng.uniform(-3, 3, (n, d))).astype(np.float32)
        x[:, ::5] = 0.0
    return x, keys


def _same(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype.itemsize == b.dtype.itemsize, what
    assert np.array_equal(a.view(f"u{a.dtype.itemsize}"),
                          b.view(f"u{b.dtype.itemsize}")), what


def _torch_np(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("name", NAMES)
def test_compressor_records_match_reference(name, d):
    """encode's records (names, dtypes, values in selection order) and
    decode, row by row against the reference's per-unit pair."""
    from repro_torch.core.compressors import make_compressor
    x, keys = _unit_inputs(name, 3, d, seed=d)
    comp = make_compressor(name)
    rec = comp.encode(torch.from_numpy(x), tkeys(keys))
    dec = comp.decode(rec, d)
    with reference() as ref:
        jc = ref.core.make_compressor(name)
        jrec = jax.vmap(jc.encode)(jnp.asarray(x), jnp.asarray(keys))
        assert set(jrec) == set(rec)
        for k in jrec:
            assert np.asarray(jrec[k]).dtype == _torch_np(rec[k]).dtype, k
            _same(jrec[k], _torch_np(rec[k]), (name, k))
        jdec = jax.vmap(lambda p: jc.decode(p, d))(jrec)
    _same(jdec, dec.numpy(), name)


@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("name", NAMES)
def test_per_unit_codecs_match_reference(name, d):
    """Per-unit encode / decode / roundtrip of each unit, and the
    fused=False batches (encode_batch / decode_batch / decode_ef_batch),
    byte for byte against the reference's per-unit codec; the port's
    fused and per-unit paths give the same bytes."""
    from repro_torch.core.compressors import make_compressor
    from repro_torch.core.wire import wire_codec
    x, keys = _unit_inputs(name, 3, d, seed=2 * d + 1)
    e = np.random.default_rng(d).standard_normal((3, d)).astype(np.float32)
    tx, tk = torch.from_numpy(x), tkeys(keys)
    comp = make_compressor(name)
    unit, fused = wire_codec(comp, fused=False), wire_codec(comp)
    pays = [unit.encode(tx[i], tk[i]) for i in range(3)]
    batch = unit.encode_batch(tx, tk)
    assert torch.equal(torch.stack(pays), batch)
    assert torch.equal(fused.encode_batch(tx, tk), batch)
    xhat, m = unit.decode_ef_batch(batch, torch.from_numpy(e), d)
    assert torch.equal(fused.decode_batch(batch, d), xhat)
    with reference() as ref:
        jcodec = ref.core.wire_codec(ref.core.make_compressor(name),
                                     fused=False)
        for i in range(3):
            jp = jcodec.encode(jnp.asarray(x[i]), jnp.asarray(keys[i]))
            _same(jp, pays[i].numpy(), (name, i))
            _same(jcodec.decode(jp, d), unit.decode(pays[i], d).numpy())
            _same(jcodec.roundtrip(jnp.asarray(x[i]), jnp.asarray(keys[i])),
                  unit.roundtrip(tx[i], tk[i]).numpy())
        jb = jcodec.encode_batch(jnp.asarray(x), jnp.asarray(keys))
        _same(jb, batch.numpy(), name)
        jx, jm = jcodec.decode_ef_batch(jb, jnp.asarray(e), d)
    _same(jx, xhat.numpy(), name)
    _same(jm, m.numpy(), name)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 8])
@pytest.mark.parametrize("d", [1, 33, 700])
def test_majority_vote_matches_reference(n, d):
    """signSGD majority vote over n workers' packed payloads: the fused vote
    (bit-sliced counting on the words) and the non-fused one (unpack,
    count, pack) give the reference's bytes; a (n, units, nbytes) batch
    votes each unit alone."""
    from repro_torch.core.compressors import SignSGD
    from repro_torch.core.wire import SignSGDCodec
    rng = np.random.default_rng(10 * n + d)
    x = rng.standard_normal((n, 2, d)).astype(np.float32)
    if n % 2 == 0:                          # ties resolve to +1
        x[: n // 2, :, 0], x[n // 2:, :, 0] = 1.0, -1.0
    codec = SignSGDCodec(comp=SignSGD())
    pays = codec.encode_batch(torch.from_numpy(x.reshape(-1, d)), None)
    pays = pays.reshape(n, 2, -1)
    fused = codec.majority_vote(pays, d)
    unfused = SignSGDCodec(comp=SignSGD(), fused=False).majority_vote(pays, d)
    assert torch.equal(fused, unfused)
    assert codec.decode(fused[0], d)[0] == 1.0 or n % 2
    with reference() as ref:
        for f in (True, False):
            jcodec = ref.core.SignSGDCodec(comp=ref.core.SignSGD(), fused=f)
            for u in range(2):
                jm = jcodec.majority_vote(jnp.asarray(pays[:, u].numpy()), d)
                _same(jm, fused[u].numpy(), (n, d, f, u))


def test_has_wire_codec_matches_reference():
    from repro_torch.core.compressors import Compressor, make_compressor
    from repro_torch.core.wire import has_wire_codec
    with reference() as ref:
        for name in ref.core.available_compressors():
            assert has_wire_codec(make_compressor(name)) == \
                ref.wire.has_wire_codec(ref.core.make_compressor(name))
        assert not has_wire_codec(Compressor(name="custom"))
        assert not ref.wire.has_wire_codec(
            ref.compressors.Compressor(name="custom"))
