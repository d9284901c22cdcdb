"""WireCodec: real bit-packed wire payloads for every compressor (the JAX
package's core/wire.py:78-1171 without the integrity words and fault
hooks), fused batch paths only.

A codec turns a bucket of units into payload rows of `nbytes(d)` bytes
and back, and for every codec but the capacity-bounded thresholds and
the bf16 value cast the round trip is bit-identical to the compressor's
`sim`:

    codec.decode_batch(codec.encode_batch(x2d, keys), d) == comp.sim(x2d, keys)

Formats (little-endian; field i of a packed leg sits at bit i*width of
its unit's uint32 words, each leg padded to a whole word):

  dense      raw f32 bytes (or bf16, word-padded)        32 (16) bits/entry
  qsgd(s)    f32 norm + b-bit offset-binary levels,      b = ceil(log2(2s+1))
             code = level + s in [0, 2s]
  terngrad   f32 scale + 2-bit codes t+1 in {0,1,2}      2 bits/entry
  signsgd    1-bit signs (x >= 0)                        1 bit/entry
  natural    9-bit codes sign*(exponent+128) + 255       9 bits/entry
  topk /     k f32 (or bf16) values, then k packed       32 (16) + ceil(
  randomk    indices of ceil(log2 d) bits                log2 d) per record
  threshold  the same records, capacity-bounded count    (not sim-exact)

Fused wire messages: execute_schedule_wire streams a CommSchedule message
by message, concatenating each message's payload rows into ONE uint8
buffer behind a header table [n_buckets, byte_offset_0, ...] (uint32),
then decodes every bucket back OUT OF the buffer. Every packed leg of a
bucket is one kernel launch each way (kernels/ops.py). With a (B, 2) key
batch every buffer is (B, nbytes): one message per worker, the
reference's vmap over workers written out.

Integrity checksums, fault injection, the trace recorder, the majority
vote and the streaming collectives are later slices (ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.compressors import (QSGD, AdaptiveThreshold,
                                          Compressor, Identity,
                                          NaturalCompression, RandomK,
                                          SignSGD, TernGrad, ThresholdV,
                                          TopK, _k_of, index_bits, pow2)
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


# ---- value-record legs: f32, or the bf16 wire cast -------------------------

def _value_nbytes(k: int, wire_dtype: str) -> int:
    """Bytes of one unit's k-value record leg: raw f32, or bf16 rounded
    up to a whole uint32 word (the same padding rule as packed legs)."""
    return 4 * k if wire_dtype == "float32" else 4 * words_for(16 * k)


def _val_rows_to_u8(v: torch.Tensor, wire_dtype: str) -> torch.Tensor:
    """(n, k) values -> (n, _value_nbytes(k)) uint8. The bf16 cast rounds
    to nearest even, as jax's astype does."""
    v = v.to(torch.float32)
    if wire_dtype == "float32":
        return _rows_to_u8(v)
    b = v.to(torch.bfloat16).contiguous().view(torch.uint8)
    return F.pad(b, (0, (-b.shape[1]) % 4))


def _u8_rows_to_vals(b: torch.Tensor, k: int,
                     wire_dtype: str) -> torch.Tensor:
    """Inverse of _val_rows_to_u8 -> (n, k) f32."""
    if wire_dtype == "float32":
        return _u8_rows_to(b, torch.float32)
    return b[:, :2 * k].contiguous().view(torch.bfloat16).to(torch.float32)


# ---- codecs ---------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class WireCodec:
    """Bit-packed wire format of one compression unit (frozen: hashable).

    `wire_dtype="bfloat16"` casts the f32 VALUE records to bf16 on the
    wire: a deliberately lossy format, so exact_sim is False and the
    simulated-strategy wire path refuses it. Only the dense and sparse
    codecs carry value records; the others raise ValueError."""
    comp: Compressor = Identity()
    wire_dtype: str = "float32"

    #: codecs whose value-record legs support the bf16 wire cast
    _SUPPORTS_BF16 = False

    def __post_init__(self):
        if self.wire_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unknown wire_dtype {self.wire_dtype!r}")
        if self.wire_dtype == "bfloat16" and not self._SUPPORTS_BF16:
            raise ValueError(
                f"{type(self).__name__}({self.comp.name}): bfloat16 wire "
                f"casting halves f32 VALUE records — only the dense and "
                f"sparse codecs carry any (quantized-code legs are "
                f"already sub-16-bit)")

    @property
    def exact_sim(self) -> bool:
        """decode(encode(x)) == sim(x) bit for bit — never true for the
        lossy bf16 value cast."""
        return self.wire_dtype == "float32"

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
    """Passthrough: raw f32 bytes, or the bf16 wire cast (16 bits/entry)."""

    _SUPPORTS_BF16 = True

    def nbytes(self, d: int) -> int:
        return _value_nbytes(d, self.wire_dtype)

    def payload_bits(self, d: int) -> int:
        if self.wire_dtype == "float32":
            return self.comp.payload_bits(d)
        return 16 * d

    def encode_batch(self, x2d, keys):
        return _val_rows_to_u8(x2d, self.wire_dtype)

    def decode_batch(self, payloads, d: int):
        return _u8_rows_to_vals(payloads, d, self.wire_dtype)


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


@dataclasses.dataclass(frozen=True)
class SignSGDCodec(WireCodec):
    """1 bit per entry (x >= 0)."""
    comp: Compressor = SignSGD()

    def nbytes(self, d: int) -> int:
        return 4 * words_for(d)

    def encode_batch(self, x2d, keys):
        return _rows_to_u8(ops.sign_pack_units(x2d))

    def decode_batch(self, payloads, d: int):
        return ops.sign_unpack_units(_u8_rows_to(payloads, torch.int32), d)

    def decode_ef_batch(self, payloads, e2d, d: int):
        return ops.sign_unpack_ef_units(_u8_rows_to(payloads, torch.int32),
                                        e2d, d)

    def majority_vote(self, payloads, d: int):
        """The reference's packed-word majority vote (core/wire.py:579)."""
        raise NotImplementedError(
            "the signSGD majority vote on packed words is not ported yet "
            "(ROADMAP.md Queue 2, item 6: kernels/sign.py majority_pallas)")


@dataclasses.dataclass(frozen=True)
class NaturalCodec(WireCodec):
    """9-bit codes: sign * (exponent + 128), offset by 255 into [0, 510]
    (255 encodes exact zero)."""
    comp: Compressor = NaturalCompression()

    def nbytes(self, d: int) -> int:
        return 4 * words_for(9 * d)

    def encode_batch(self, x2d, keys):
        e, sgn, zero = self.comp._exponents(x2d.to(torch.float32), keys)
        code = torch.where(zero, 0, sgn.to(torch.int32)
                           * (e + self.comp._BIAS + 1))
        return _rows_to_u8(ops.fields_pack_units(code + 255, 9))

    def decode_batch(self, payloads, d: int):
        code = ops.fields_unpack_units(_u8_rows_to(payloads, torch.int32),
                                       d, 9) - 255
        val = torch.sign(code).to(torch.float32) * pow2(
            code.abs() - (self.comp._BIAS + 1))
        return torch.where(code == 0, 0.0, val)


@dataclasses.dataclass(frozen=True)
class SparseCodec(WireCodec):
    """k records of (f32 value, ceil(log2 d)-bit index): topk / randomk
    (exact_sim) and the capacity-bounded threshold methods (not). Values
    travel first (4k bytes, or 2k word-padded at wire_dtype="bfloat16"),
    then the packed index leg. Decode scatters the values into zeros at
    their (unique) indices."""
    comp: Compressor = TopK()
    sim_exact: bool = True

    _SUPPORTS_BF16 = True

    @property
    def exact_sim(self) -> bool:
        return self.sim_exact and self.wire_dtype == "float32"

    def _k(self, d: int) -> int:
        c = self.comp
        return _k_of(c.ratio if hasattr(c, "ratio") else c.cap_ratio, d)

    def _vb(self, d: int) -> int:
        """Byte size of the value leg at this wire dtype."""
        return _value_nbytes(self._k(d), self.wire_dtype)

    def nbytes(self, d: int) -> int:
        return self._vb(d) + 4 * words_for(self._k(d) * index_bits(d))

    def payload_bits(self, d: int) -> int:
        if self.wire_dtype == "float32":
            return self.comp.payload_bits(d)
        return self._k(d) * (16 + index_bits(d))

    def encode_batch(self, x2d, keys):
        d = x2d.shape[1]
        rec = self.comp.encode(x2d.to(torch.float32), keys)
        words = ops.fields_pack_units(rec["idx"], index_bits(d))
        return torch.cat([_val_rows_to_u8(rec["val"], self.wire_dtype),
                          _rows_to_u8(words)], dim=1)

    def decode_batch(self, payloads, d: int):
        k, vb = self._k(d), self._vb(d)
        val = _u8_rows_to_vals(payloads[:, :vb], k, self.wire_dtype)
        idx = ops.fields_unpack_units(_u8_rows_to(payloads[:, vb:],
                                                  torch.int32),
                                      k, index_bits(d))
        out = torch.zeros((payloads.shape[0], d), dtype=torch.float32,
                          device=payloads.device)
        return out.scatter_(1, idx.to(torch.int64), val)


def wire_codec(comp: Compressor, wire_dtype: str = "float32",
               integrity: bool = False) -> WireCodec:
    """The WireCodec materializing `comp`'s payloads. Raises ValueError for
    a compressor with no wire format, or a bf16 cast of a codec without
    value records (the reference's errors)."""
    if integrity:
        raise NotImplementedError(
            "Fletcher-32 integrity words are not ported yet (ROADMAP.md "
            "Queue 1, item b)")
    kw = dict(wire_dtype=wire_dtype)
    if isinstance(comp, (TopK, RandomK)):
        return SparseCodec(comp=comp, **kw)
    if isinstance(comp, (ThresholdV, AdaptiveThreshold)):
        return SparseCodec(comp=comp, sim_exact=False, **kw)
    if isinstance(comp, QSGD):
        return QSGDCodec(comp=comp, **kw)
    if isinstance(comp, TernGrad):
        return TernGradCodec(comp=comp, **kw)
    if isinstance(comp, SignSGD):
        return SignSGDCodec(comp=comp, **kw)
    if isinstance(comp, NaturalCompression):
        return NaturalCodec(comp=comp, **kw)
    if isinstance(comp, Identity):
        return DenseCodec(comp=comp, **kw)
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
