"""Wire integrity of slice 3 against the reference (core/wire.py:147-182,
787-936): Fletcher-32 on odd, even, empty and > 65,536-word buffers, the
checksummed message buffers byte for byte (QSGD on dyadic gradients,
signSGD and top-k on random normal ones), verify_message on clean and
corrupted buffers, and parse_message_header's accept / reject cases.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_ref import jkey, reference
from test_torch_wire import (MIXED_SHAPES, RESNET9_SHAPES, _grads,
                             _port_schedule, _to_jax, _to_torch)


@pytest.mark.parametrize("size", [0, 1, 2, 7, 1024, 131_075])
def test_fletcher32_matches_reference(size):
    from repro_torch.core.wire import fletcher32
    rng = np.random.default_rng(size)
    b = rng.integers(0, 256, size, dtype=np.uint8)
    if size > 1024:
        b[:4096] = 255                     # large words, long runs
    with reference() as ref:
        want = int(ref.wire.fletcher32(jnp.asarray(b)))
    assert int(fletcher32(torch.from_numpy(b))) == want
    rows = torch.from_numpy(np.stack([b, b[::-1].copy()]))
    got = fletcher32(rows)
    assert got.shape == (2,) and int(got[0]) == want


@pytest.mark.parametrize("gran", ["layerwise", "entire_model"])
@pytest.mark.parametrize("comp", ["qsgd", "signsgd", "topk"])
def test_checksummed_buffers_byte_identical(comp, gran):
    """integrity=True message buffers equal the reference's; stripping the
    checksum word gives the plain buffers back (payloads unchanged), and
    every buffer verifies."""
    from repro_torch import random as R
    from repro_torch.core.compressors import make_compressor
    from repro_torch.core.wire import (execute_schedule_wire,
                                       message_layouts, verify_message,
                                       wire_codec)
    g = _grads(MIXED_SHAPES, seed=len(comp), dyadic=comp == "qsgd")
    tg = _to_torch(g)
    sched = _port_schedule(tg, gran, 256.0)
    codec = wire_codec(make_compressor(comp), integrity=True)
    _, bufs = execute_schedule_wire(sched, codec, tg, R.key(6))
    _, plain = execute_schedule_wire(sched, wire_codec(make_compressor(comp)),
                                     tg, R.key(6))
    layouts = message_layouts(sched, codec)
    with reference() as ref:
        jg = _to_jax(g)
        jplan = ref.core.build_plan(jg, ref.core.stacked_mask(jg),
                                    ref.core.Granularity(gran))
        jsched = ref.core.build_schedule(jplan, 256.0)
        jcodec = ref.core.wire_codec(ref.core.make_compressor(comp),
                                     integrity=True)
        _, jbufs = jax.jit(lambda g, k: jsched.execute(
            None, g, k, wire=jcodec))(jg, jkey(6))
        jlay = ref.wire.message_layouts(jsched, jcodec)
        assert len(jbufs) == len(bufs) == sched.num_messages
        for jb, tb, pb, lay, jl in zip(jbufs, bufs, plain, layouts, jlay):
            assert np.array_equal(np.asarray(jb), tb.numpy())
            assert (lay.offsets, lay.header_nbytes, lay.total_nbytes,
                    lay.checksum) == (jl.offsets, jl.header_nbytes,
                                      jl.total_nbytes, jl.checksum)
            assert bool(verify_message(tb, lay))
            assert bool(ref.wire.verify_message(jnp.asarray(tb.numpy()), jl))
            assert torch.equal(tb[lay.header_nbytes:],
                               pb[lay.header_nbytes - 4:])


def test_verify_message_catches_every_single_flip():
    """One flipped payload bit (any of them, in one buffer) fails the
    check; the batched (one row per worker) form verifies row by row."""
    from repro_torch import random as R
    from repro_torch.core.compressors import make_compressor
    from repro_torch.core.wire import (execute_schedule_wire,
                                       message_layouts, verify_message,
                                       wire_codec)
    tg = _to_torch(_grads(RESNET9_SHAPES, seed=2, dyadic=False))
    sched = _port_schedule(tg, "layerwise", 0.0)
    codec = wire_codec(make_compressor("signsgd"), integrity=True)
    _, bufs = execute_schedule_wire(sched, codec, tg, R.key(1))
    lay, buf = min(((lay, b) for lay, b in zip(message_layouts(sched, codec),
                                               bufs) if b.numel() >= 64),
                   key=lambda lb: lb[1].numel())        # 68 bytes
    bad = buf[None].repeat(8 * (buf.numel() - 8), 1)
    pos = torch.arange(bad.shape[0])
    bad[pos, 8 + pos // 8] ^= (1 << (pos % 8)).to(torch.uint8)
    assert not verify_message(bad, lay).any()
    both = torch.stack([buf, bad[5]])
    assert verify_message(both, lay).tolist() == [True, False]
    with pytest.raises(ValueError, match="checksum layout"):
        verify_message(buf, message_layouts(
            sched, wire_codec(make_compressor("signsgd")))[0])


def _mutations(words: np.ndarray, size: int):
    """The reference's malformed-header cases (tests/test_resil.py)."""
    out = []
    for idx, val in ((0, 0), (0, 1 << 24), (2, int(words[2]) + 4)):
        w = words.copy()
        w[idx] = val
        out.append(w.view(np.uint8))
    if words[0] >= 2:
        w = words.copy()
        w[3] = w[2] - 4
        out.append(w.view(np.uint8))
    w = words.copy()
    w[2 + int(words[0]) - 1] = size + 64
    out.append(w.view(np.uint8))
    return out


def test_parse_message_header_matches_reference():
    from repro_torch import random as R
    from repro_torch.core.compressors import make_compressor
    from repro_torch.core.wire import (execute_schedule_wire,
                                       message_layouts,
                                       parse_message_header, wire_codec)
    tg = _to_torch(_grads(MIXED_SHAPES, seed=4, dyadic=False))
    sched = _port_schedule(tg, "layerwise", float("inf"))
    for integrity in (True, False):
        codec = wire_codec(make_compressor("topk", ratio=0.25),
                           integrity=integrity)
        _, bufs = execute_schedule_wire(sched, codec, tg, R.key(2))
        lay = message_layouts(sched, codec)[0]
        assert parse_message_header(bufs[0], checksum=integrity) == (
            len(lay.offsets), lay.offsets)
    _, cbufs = execute_schedule_wire(
        sched, wire_codec(make_compressor("topk", ratio=0.25),
                          integrity=True), tg, R.key(2))
    b = cbufs[0].numpy()
    bad = [b[:-1], np.zeros((0,), np.uint8)] + _mutations(
        b.view("<u4").copy(), b.size)
    with reference() as ref:
        for buf in bad:
            with pytest.raises(ValueError) as jerr:
                ref.wire.parse_message_header(buf, checksum=True)
            with pytest.raises(ValueError) as err:
                parse_message_header(torch.from_numpy(buf.copy()),
                                     checksum=True)
            assert str(err.value) == str(jerr.value)
