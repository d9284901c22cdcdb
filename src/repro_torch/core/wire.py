"""WireCodec: real bit-packed wire payloads (the JAX package's
core/wire.py:78-541, 742-1171) — the ported codecs are dense f32, QSGD
and TernGrad, fused only.

A codec turns a bucket of units into payload rows of `nbytes(d)` bytes
and back, and the round trip is bit-identical to the compressor's `sim`:

    codec.decode_batch(codec.encode_batch(x2d, keys), d) == comp.sim(x2d, keys)

Formats (little-endian; field i of a packed leg sits at bit i*width of
its unit's uint32 words, each leg padded to a whole word):

  dense      raw f32 bytes                           32 bits/entry
  qsgd(s)    f32 norm + b-bit offset-binary levels,  b = ceil(log2(2s+1))
             code = level + s in [0, 2s]
  terngrad   f32 scale + 2-bit codes t+1 in {0,1,2}  2 bits/entry

Fused wire messages: execute_schedule_wire streams a CommSchedule message
by message, concatenating each message's payload rows into ONE uint8
buffer behind a header table [n_buckets, byte_offset_0, ...] (uint32),
then decodes every bucket back OUT OF the buffer. The encode and decode
of a QSGD or TernGrad bucket are one kernel launch each
(kernels/ops.py). With a (B, 2) key batch every buffer is (B, nbytes):
one message per worker, the reference's vmap over workers written out.

Integrity checksums, fault injection, the trace recorder, the bf16 value
cast and the streaming collectives are later slices (ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import torch

from repro_torch.core.compressors import QSGD, Compressor, Identity, TernGrad
from repro_torch.kernels import ops


def words_for(nbits: int) -> int:
    """uint32 words holding `nbits` packed bits."""
    return -(-nbits // 32)


def word_padding(nbits: int) -> int:
    """Pad-to-word slack of one packed leg: (-nbits) % 32, always < 32."""
    return (-nbits) % 32


# ---- byte views (exact: float and word legs round-trip bit for bit) -------

def _rows_to_u8(v: torch.Tensor) -> torch.Tensor:
    """(n, k) 4-byte rows (f32 or int32 words) -> (n, 4k) uint8."""
    return v.contiguous().view(torch.uint8)


def _u8_rows_to(b: torch.Tensor, dtype) -> torch.Tensor:
    """(n, 4k) uint8 -> (n, k) rows of a 4-byte dtype."""
    return b.contiguous().view(dtype)


def _split(payloads: torch.Tensor):
    """QSGD / TernGrad payload rows -> ((n,) f32 statistic, (n, words)
    int32 words): a 4-byte f32 leg, then the packed code words."""
    return (_u8_rows_to(payloads[:, :4], torch.float32)[:, 0],
            _u8_rows_to(payloads[:, 4:], torch.int32))


# ---- codecs ---------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class WireCodec:
    """Bit-packed wire format of one compression unit (frozen: hashable)."""
    comp: Compressor = Identity()

    def nbytes(self, d: int) -> int:
        raise NotImplementedError

    def wire_bits(self, d: int) -> int:
        return 8 * self.nbytes(d)

    def payload_bits(self, d: int) -> int:
        return self.comp.payload_bits(d)

    def padding_bits(self, d: int) -> int:
        return self.wire_bits(d) - self.payload_bits(d)

    def encode_batch(self, x2d, keys) -> torch.Tensor:
        """(n, d) units + (n, 2) unit keys -> (n, nbytes(d)) uint8 rows."""
        raise NotImplementedError

    def decode_batch(self, payloads, d: int) -> torch.Tensor:
        """(n, nbytes(d)) uint8 rows -> (n, d) decoded f32 units."""
        raise NotImplementedError

    def decode_ef_batch(self, payloads, e2d, d: int):
        """Decode + error-feedback residual -> (xhat, m = e - xhat)."""
        xhat = self.decode_batch(payloads, d)
        return xhat, e2d - xhat


@dataclasses.dataclass(frozen=True)
class DenseCodec(WireCodec):
    """Passthrough: raw f32 bytes."""

    def nbytes(self, d: int) -> int:
        return 4 * d

    def encode_batch(self, x2d, keys):
        return _rows_to_u8(x2d.to(torch.float32))

    def decode_batch(self, payloads, d: int):
        return _u8_rows_to(payloads, torch.float32)


@dataclasses.dataclass(frozen=True)
class QSGDCodec(WireCodec):
    """f32 unit norm + b-bit offset-binary levels (code = level + s)."""
    comp: Compressor = QSGD()

    @property
    def entry_bits(self) -> int:
        return self.comp.entry_bits

    def nbytes(self, d: int) -> int:
        return 4 + 4 * words_for(self.entry_bits * d)

    def encode_batch(self, x2d, keys):
        w, nrm = ops.qsgd_pack_units(x2d, keys, self.comp.levels,
                                     self.entry_bits)
        return torch.cat([_rows_to_u8(nrm[:, None]), _rows_to_u8(w)], dim=1)

    def decode_batch(self, payloads, d: int):
        nrm, w = _split(payloads)
        return ops.qsgd_unpack_units(w, nrm, d, self.comp.levels,
                                     self.entry_bits)

    def decode_ef_batch(self, payloads, e2d, d: int):
        nrm, w = _split(payloads)
        return ops.qsgd_unpack_ef_units(w, nrm, e2d, d, self.comp.levels,
                                        self.entry_bits)


@dataclasses.dataclass(frozen=True)
class TernGradCodec(WireCodec):
    """f32 unit scale + 2-bit ternary codes (t + 1 in {0, 1, 2})."""
    comp: Compressor = TernGrad()

    def nbytes(self, d: int) -> int:
        return 4 + 4 * words_for(2 * d)

    def encode_batch(self, x2d, keys):
        w, s = ops.terngrad_pack_units(x2d, keys)
        return torch.cat([_rows_to_u8(s[:, None]), _rows_to_u8(w)], dim=1)

    def decode_batch(self, payloads, d: int):
        s, w = _split(payloads)
        return ops.terngrad_unpack_units(w, s, d)

    def decode_ef_batch(self, payloads, e2d, d: int):
        s, w = _split(payloads)
        return ops.terngrad_unpack_ef_units(w, s, e2d, d)


def wire_codec(comp: Compressor, wire_dtype: str = "float32",
               integrity: bool = False) -> WireCodec:
    """The WireCodec materializing `comp`'s payloads."""
    if wire_dtype != "float32" or integrity:
        raise NotImplementedError(
            "the bf16 value cast and Fletcher-32 integrity words are not "
            "ported yet (ROADMAP.md Queue 1, items a and b)")
    if isinstance(comp, QSGD):
        return QSGDCodec(comp=comp)
    if isinstance(comp, TernGrad):
        return TernGradCodec(comp=comp)
    if isinstance(comp, Identity):
        return DenseCodec(comp=comp)
    raise ValueError(f"no wire codec for compressor {comp.name!r}")


# ---- fused message buffers --------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MessageLayout:
    """Static byte layout of one fused wire message: a uint32 header
    [n_buckets, byte_offset_0, ...] (absolute offsets), then per bucket
    n_units back-to-back payload records of unit_nbytes bytes."""
    bucket_ids: Tuple[int, ...]
    offsets: Tuple[int, ...]
    unit_nbytes: Tuple[int, ...]
    header_nbytes: int
    total_nbytes: int


@functools.lru_cache(maxsize=256)
def message_layouts(schedule, codec: WireCodec) -> Tuple[MessageLayout, ...]:
    """Static layouts of every fused message of (schedule, codec)."""
    plan = schedule.plan
    outs = []
    for msg in schedule.messages:
        header = 4 * (1 + len(msg.bucket_ids))
        off = header
        offs, unb = [], []
        for bi in msg.bucket_ids:
            b = plan.buckets[bi]
            nb = codec.nbytes(b.dim)
            offs.append(off)
            unb.append(nb)
            off += b.n * nb
        outs.append(MessageLayout(msg.bucket_ids, tuple(offs), tuple(unb),
                                  header, off))
    return tuple(outs)


def _message_buffer(layout: MessageLayout, payload_mats) -> torch.Tensor:
    """Per-bucket payload regions (B, n_units * nbytes) -> (B, total_nbytes)
    uint8 buffers, one per worker: header ++ regions."""
    B = payload_mats[0].shape[0]
    header = torch.tensor((len(layout.bucket_ids),) + layout.offsets,
                          dtype=torch.int32).view(torch.uint8)
    header = header.to(payload_mats[0].device)[None].expand(B, -1)
    return torch.cat([header, *payload_mats], dim=1)


def _bucket_region(buf: torch.Tensor, layout: MessageLayout, j: int,
                   n: int) -> torch.Tensor:
    """(B, total) buffers -> bucket j's (B * n, unit_nbytes) payload rows."""
    off, nb = layout.offsets[j], layout.unit_nbytes[j]
    return buf[:, off:off + n * nb].reshape(-1, nb)


def execute_schedule_wire(schedule, codec: WireCodec, grads, key):
    """Stream a CommSchedule through REAL wire buffers: per message, encode
    every member bucket (one pack launch each), concatenate the payload
    rows into one uint8 buffer behind the header, then decode each bucket
    back out of the buffer (one unpack launch each). Returns (tree,
    buffers); sum(8 * buf.numel()) is the measured wire truth."""
    return _execute_wire(schedule, codec, grads, None, key)


def execute_schedule_wire_with_state(schedule, codec: WireCodec, grads,
                                     state, key):
    """Error-feedback twin of execute_schedule_wire: per unit e = x + m is
    encoded, and decode threads through codec.decode_ef_batch (one unpack
    launch per bucket plus the caller-side residual m' = e - xhat).
    Returns (tree, m_tree, buffers)."""
    return _execute_wire(schedule, codec, grads, state, key)


def _execute_wire(schedule, codec, grads, state, key):
    plan = schedule.plan
    leaves, batched = plan._inputs(grads, key)
    B = leaves[0].shape[0]
    need = plan.needs_flat
    flat = plan._flat(leaves) if need else None
    if state is not None:
        sleaves, _ = plan._inputs(state, key)
        mflat = plan._flat(sleaves) if need else None
    keys = plan._keys(key, leaves[0].device)
    out = ([None] * len(leaves), plan._new_flat(leaves) if need else None)
    mout = ([None] * len(leaves), plan._new_flat(leaves) if need else None)
    buffers = []
    for msg, layout in zip(schedule.messages,
                           message_layouts(schedule, codec)):
        bs = [plan.buckets[bi] for bi in msg.bucket_ids]
        es = [plan._gather_runs(leaves, flat, b) for b in bs]
        if state is not None:
            es = [e + plan._gather_runs(sleaves, mflat, b)
                  for e, b in zip(es, bs)]
        buf = _message_buffer(layout, [
            codec.encode_batch(e, plan._bucket_keys(keys, b)).reshape(B, -1)
            for e, b in zip(es, bs)])
        buffers.append(buf if batched else buf[0])
        for j, b in enumerate(bs):
            pay = _bucket_region(buf, layout, j, b.n)
            if state is None:
                plan._scatter_runs(*out, b, codec.decode_batch(pay, b.dim))
            else:
                ehat, mn = codec.decode_ef_batch(pay, es[j], b.dim)
                plan._scatter_runs(*out, b, ehat)
                plan._scatter_runs(*mout, b, mn)
    tree = plan._assemble(*out, batched)
    if state is None:
        return tree, tuple(buffers)
    return tree, plan._assemble(*mout, batched), tuple(buffers)
