"""WireCodec: real bit-packed wire payloads for every compressor (the JAX
package's core/wire.py:78-936 without the fault hooks).

A codec turns a unit into a payload of `nbytes(d)` bytes and back, and for
every codec but the capacity-bounded thresholds and the bf16 value cast
the round trip is bit-identical to the compressor's `sim`:

    codec.decode(codec.encode(x, key), d) == comp.sim(x[None], key[None])[0]

Two implementations of each format, byte-identical:

  per-unit  `encode` / `decode` / `roundtrip` of one unit; `encode_rows` /
            `decode_rows` run the same per-unit arithmetic batched over
            rows (the reference's vmapped per-unit path): compressor draws
            and codes, then the word packing kernels (fields_pack, or
            bits_pack / bits_unpack for signSGD). The allgather receive
            leg decodes every gathered row with it.
  fused     `encode_batch` / `decode_batch` / `decode_ef_batch` of a whole
            bucket: one compress+pack kernel launch each way
            (kernels/ops.py). `fused=False` routes them to the per-unit
            rows instead (the reference's legacy fallback).

Formats (little-endian; field i of a packed leg sits at bit i*width of
its unit's uint32 words, each leg padded to a whole word):

  dense      raw f32 bytes (or bf16, word-padded)        32 (16) bits/entry
  qsgd(s)    f32 norm + b-bit offset-binary levels,      b = ceil(log2(2s+1))
             code = level + s in [0, 2s]
  terngrad   f32 scale + 2-bit codes t+1 in {0,1,2}      2 bits/entry
  signsgd    1-bit signs (x >= 0); the majority vote     1 bit/entry
             counts on the packed words
  natural    9-bit codes sign*(exponent+128) + 255       9 bits/entry
  topk /     k f32 (or bf16) values, then k packed       32 (16) + ceil(
  randomk    indices of ceil(log2 d) bits                log2 d) per record
  threshold  the same records, capacity-bounded count    (not sim-exact)

Fused wire messages: execute_schedule_wire streams a CommSchedule message
by message, concatenating each message's payload rows into ONE uint8
buffer behind a header table [n_buckets, byte_offset_0, ...] (uint32),
then decodes every bucket back OUT OF the buffer. With a (B, 2) key batch
every buffer is (B, nbytes): one message per worker, the reference's vmap
over workers written out. `integrity=True` adds a Fletcher-32 word to
the header, [n_buckets, fletcher32, offsets...], over every byte after it
(4 bytes a message; payloads and numerics unchanged); verify_message
checks it and parse_message_header validates a header's structure.

Fault injection, the trace recorder and the streaming collectives are
later slices (ROADMAP.md Queue 1).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional, Tuple

import numpy as np
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


def _stat_and_words(stat: torch.Tensor, words: torch.Tensor) -> torch.Tensor:
    """(n,) f32 statistic + (n, w) int32 words -> (n, 4 + 4w) payload rows."""
    return torch.cat([_rows_to_u8(stat[:, None]), _rows_to_u8(words)], dim=1)


# ---- wire integrity: Fletcher-32 over packed bytes -------------------------
# Fletcher-32 over little-endian 16-bit words with Adler-style
# initialization (sum1 starts at 1), so an all-zero span never verifies
# against a zeroed header word and the length rides in sum2. A single bit
# flip changes its 16-bit word by +-2^k, never 0 mod 65535, so it is always
# detected. With s1_0 = 1, s2_0 = 0 and per word s1 += w, s2 += s1:
# sum1 = 1 + sum_i w_i and sum2 = nw + sum_i (nw - i) w_i, mod 65535
# (the reference's wire.py:147-182). Carried in int64: the products stay
# below 2**32 and the sums far below 2**63.

_FLETCHER_MOD = 65535


def fletcher32(buf: torch.Tensor) -> torch.Tensor:
    """Fletcher-32 (init=1) of the last axis of a uint8 tensor -> int64
    tensor of the leading shape holding the uint32 checksum."""
    b = buf.to(torch.int64)
    if b.shape[-1] % 2:
        b = F.pad(b, (0, 1))
    words = (b[..., 0::2] | (b[..., 1::2] << 8)) % _FLETCHER_MOD
    nw = words.shape[-1]
    coef = torch.arange(nw, 0, -1, dtype=torch.int64,
                        device=buf.device) % _FLETCHER_MOD
    s1 = (1 + words.sum(dim=-1)) % _FLETCHER_MOD
    s2 = (nw % _FLETCHER_MOD
          + ((coef * words) % _FLETCHER_MOD).sum(dim=-1)) % _FLETCHER_MOD
    return (s2 << 16) | s1


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

    `fused=True` (default) runs the batch entry points through the
    single-launch compress+pack kernels; `fused=False` runs them through
    the per-unit rows (encode_rows / decode_rows), byte-identical.

    `wire_dtype="bfloat16"` casts the f32 VALUE records to bf16 on the
    wire: a deliberately lossy format, so exact_sim is False and the
    simulated-strategy wire path refuses it. Only the dense and sparse
    codecs carry value records; the others raise ValueError.

    `integrity=True` reserves one header word per fused message for a
    Fletcher-32 checksum (message_layouts); unit payloads are unchanged."""
    comp: Compressor = Identity()
    fused: bool = True
    wire_dtype: str = "float32"
    integrity: bool = False

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

    # ---- per-unit codec, batched over rows -------------------------------
    def encode_rows(self, x2d, keys) -> torch.Tensor:
        """(n, d) units + (n, 2) unit keys -> (n, nbytes(d)) uint8 rows,
        each the per-unit encode of its row."""
        raise NotImplementedError

    def decode_rows(self, payloads, d: int) -> torch.Tensor:
        """(n, nbytes(d)) uint8 rows -> (n, d) f32, the per-unit decode of
        each row."""
        raise NotImplementedError

    def encode(self, x, key) -> torch.Tensor:
        """One (d,) unit + its (2,) key -> (nbytes(d),) uint8 payload."""
        return self.encode_rows(x.reshape(1, -1), key.reshape(1, 2))[0]

    def decode(self, payload, d: int) -> torch.Tensor:
        """(nbytes(d),) uint8 payload -> the (d,) f32 unit."""
        return self.decode_rows(payload.reshape(1, -1), d)[0]

    def roundtrip(self, x, key) -> torch.Tensor:
        return self.decode(self.encode(x, key), x.shape[0])

    # ---- batched wire (one bucket = one dispatch) ------------------------
    def encode_batch(self, x2d, keys) -> torch.Tensor:
        """(n, d) units + (n, 2) unit keys -> (n, nbytes(d)) uint8 rows."""
        return self.encode_rows(x2d, keys)

    def decode_batch(self, payloads, d: int) -> torch.Tensor:
        """(n, nbytes(d)) uint8 rows -> (n, d) decoded f32 units."""
        return self.decode_rows(payloads, d)

    def decode_ef_batch(self, payloads, e2d, d: int):
        """Decode + error-feedback residual -> (xhat, m = e - xhat)."""
        xhat = self.decode_batch(payloads, d)
        return xhat, e2d - xhat


@dataclasses.dataclass(frozen=True)
class DenseCodec(WireCodec):
    """Passthrough: raw f32 bytes, or the bf16 wire cast (16 bits/entry).
    The per-unit and fused formats are one and the same byte copy."""

    _SUPPORTS_BF16 = True

    def nbytes(self, d: int) -> int:
        return _value_nbytes(d, self.wire_dtype)

    def payload_bits(self, d: int) -> int:
        if self.wire_dtype == "float32":
            return self.comp.payload_bits(d)
        return 16 * d

    def encode_rows(self, x2d, keys):
        return _val_rows_to_u8(x2d, self.wire_dtype)

    def decode_rows(self, payloads, d: int):
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

    def encode_rows(self, x2d, keys):
        q, nrm = self.comp._quantize(x2d.to(torch.float32), keys)
        codes = q.to(torch.int32) + self.comp.levels
        return _stat_and_words(nrm, ops.fields_pack_units(codes,
                                                          self.entry_bits))

    def decode_rows(self, payloads, d: int):
        nrm, w = _split(payloads)
        codes = ops.fields_unpack_units(w, d, self.entry_bits)
        q = codes - self.comp.levels
        return q.to(torch.float32) * (nrm / self.comp.levels)[:, None]

    def encode_batch(self, x2d, keys):
        if not self.fused:
            return self.encode_rows(x2d, keys)
        w, nrm = ops.qsgd_pack_units(x2d, keys, self.comp.levels,
                                     self.entry_bits)
        return _stat_and_words(nrm, w)

    def decode_batch(self, payloads, d: int):
        if not self.fused:
            return self.decode_rows(payloads, d)
        nrm, w = _split(payloads)
        return ops.qsgd_unpack_units(w, nrm, d, self.comp.levels,
                                     self.entry_bits)

    def decode_ef_batch(self, payloads, e2d, d: int):
        if not self.fused:
            return super().decode_ef_batch(payloads, e2d, d)
        nrm, w = _split(payloads)
        return ops.qsgd_unpack_ef_units(w, nrm, e2d, d, self.comp.levels,
                                        self.entry_bits)


@dataclasses.dataclass(frozen=True)
class TernGradCodec(WireCodec):
    """f32 unit scale + 2-bit ternary codes (t + 1 in {0, 1, 2})."""
    comp: Compressor = TernGrad()

    def nbytes(self, d: int) -> int:
        return 4 + 4 * words_for(2 * d)

    def encode_rows(self, x2d, keys):
        t, s = self.comp._quantize(x2d.to(torch.float32), keys)
        return _stat_and_words(s, ops.fields_pack_units(t.to(torch.int32)
                                                        + 1, 2))

    def decode_rows(self, payloads, d: int):
        s, w = _split(payloads)
        t = ops.fields_unpack_units(w, d, 2) - 1
        return t.to(torch.float32) * s[:, None]

    def encode_batch(self, x2d, keys):
        if not self.fused:
            return self.encode_rows(x2d, keys)
        w, s = ops.terngrad_pack_units(x2d, keys)
        return _stat_and_words(s, w)

    def decode_batch(self, payloads, d: int):
        if not self.fused:
            return self.decode_rows(payloads, d)
        s, w = _split(payloads)
        return ops.terngrad_unpack_units(w, s, d)

    def decode_ef_batch(self, payloads, e2d, d: int):
        if not self.fused:
            return super().decode_ef_batch(payloads, e2d, d)
        s, w = _split(payloads)
        return ops.terngrad_unpack_ef_units(w, s, e2d, d)


@dataclasses.dataclass(frozen=True)
class SignSGDCodec(WireCodec):
    """1 bit per entry (x >= 0). `majority_vote` aggregates n workers'
    payloads on the packed words — the signSGD-with-majority-vote wire
    protocol (Bernstein et al.): only packed signs ever travel."""
    comp: Compressor = SignSGD()

    def nbytes(self, d: int) -> int:
        return 4 * words_for(d)

    def encode_rows(self, x2d, keys):
        return _rows_to_u8(ops.pack_words(x2d >= 0))

    def decode_rows(self, payloads, d: int):
        bits = ops.unpack_words(_u8_rows_to(payloads, torch.int32), d)
        return (2 * bits - 1).to(torch.float32)

    def encode_batch(self, x2d, keys):
        if not self.fused:
            return self.encode_rows(x2d, keys)
        return _rows_to_u8(ops.sign_pack_units(x2d))

    def decode_batch(self, payloads, d: int):
        if not self.fused:
            return self.decode_rows(payloads, d)
        return ops.sign_unpack_units(_u8_rows_to(payloads, torch.int32), d)

    def decode_ef_batch(self, payloads, e2d, d: int):
        if not self.fused:
            return super().decode_ef_batch(payloads, e2d, d)
        return ops.sign_unpack_ef_units(_u8_rows_to(payloads, torch.int32),
                                        e2d, d)

    def majority_vote(self, payloads, d: int) -> torch.Tensor:
        """(n_workers, ..., nbytes(d)) packed payloads -> (..., nbytes(d)):
        bit i of each unit is the majority sign of entry i over the
        workers (ties -> +1, the x >= 0 convention). Fused: bit-sliced
        counting on the packed words of every unit at once (one majority
        launch); otherwise unpack, count, pack (the reference's non-fused
        vote, wire.py:579-594). Zero padding bits vote 0 on both paths, so
        both give the same bytes."""
        n, nb = payloads.shape[0], payloads.shape[-1]
        if self.fused:
            words = _u8_rows_to(payloads.reshape(n, -1), torch.int32)
            return _rows_to_u8(ops.majority_words(words)[None]).reshape(
                payloads.shape[1:])
        rows = _u8_rows_to(payloads.reshape(-1, nb), torch.int32)
        bits = ops.unpack_words(rows, d).reshape(n, -1, d)
        maj = (2 * bits.sum(dim=0) >= n).to(torch.int32)
        return _rows_to_u8(ops.pack_words(maj)).reshape(payloads.shape[1:])


@dataclasses.dataclass(frozen=True)
class NaturalCodec(WireCodec):
    """9-bit codes: sign * (exponent + 128), offset by 255 into [0, 510]
    (255 encodes exact zero). Per-unit and fused formats share one path:
    exponent draws, then one fields_pack launch per bucket."""
    comp: Compressor = NaturalCompression()

    def nbytes(self, d: int) -> int:
        return 4 * words_for(9 * d)

    def encode_rows(self, x2d, keys):
        e, sgn, zero = self.comp._exponents(x2d.to(torch.float32), keys)
        code = torch.where(zero, 0, sgn.to(torch.int32)
                           * (e + self.comp._BIAS + 1))
        return _rows_to_u8(ops.fields_pack_units(code + 255, 9))

    def decode_rows(self, payloads, d: int):
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
    their (unique) indices. Per-unit and fused formats share one path."""
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

    def encode_rows(self, x2d, keys):
        d = x2d.shape[1]
        rec = self.comp.encode(x2d.to(torch.float32), keys)
        words = ops.fields_pack_units(rec["idx"], index_bits(d))
        return torch.cat([_val_rows_to_u8(rec["val"], self.wire_dtype),
                          _rows_to_u8(words)], dim=1)

    def decode_rows(self, payloads, d: int):
        k, vb = self._k(d), self._vb(d)
        val = _u8_rows_to_vals(payloads[:, :vb], k, self.wire_dtype)
        idx = ops.fields_unpack_units(_u8_rows_to(payloads[:, vb:],
                                                  torch.int32),
                                      k, index_bits(d))
        out = torch.zeros((payloads.shape[0], d), dtype=torch.float32,
                          device=payloads.device)
        return out.scatter_(1, idx.to(torch.int64), val)


def wire_codec(comp: Compressor, wire_dtype: str = "float32",
               fused: bool = True, integrity: bool = False) -> WireCodec:
    """The WireCodec materializing `comp`'s payloads. Raises ValueError for
    a compressor with no wire format, or a bf16 cast of a codec without
    value records (the reference's errors). `fused=False` runs the batch
    entry points through the per-unit rows; `integrity=True` adds the
    Fletcher-32 header word to every fused message."""
    kw = dict(fused=fused, wire_dtype=wire_dtype, integrity=integrity)
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
    if isinstance(comp, Identity) or comp.name in ("identity", "dense"):
        return DenseCodec(comp=comp, **kw)
    raise ValueError(f"no wire codec for compressor {comp.name!r}")


def has_wire_codec(comp: Compressor) -> bool:
    try:
        wire_codec(comp)
        return True
    except ValueError:
        return False


# ---- fused message buffers --------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MessageLayout:
    """Static byte layout of one fused wire message: a uint32 header
    [n_buckets, byte_offset_0, ...] (absolute offsets), then per bucket
    n_units back-to-back payload records of unit_nbytes bytes. With
    `checksum=True` the header is [n_buckets, fletcher32, offsets...], the
    checksum covering every byte from `checksum_span_start` on."""
    bucket_ids: Tuple[int, ...]
    offsets: Tuple[int, ...]
    unit_nbytes: Tuple[int, ...]
    header_nbytes: int
    total_nbytes: int
    checksum: bool = False

    #: byte offset where the checksummed span begins (after the
    #: [n_buckets, fletcher32] words)
    checksum_span_start = 8


@functools.lru_cache(maxsize=256)
def message_layouts(schedule, codec: WireCodec) -> Tuple[MessageLayout, ...]:
    """Static layouts of every fused message of (schedule, codec)."""
    plan = schedule.plan
    outs = []
    for msg in schedule.messages:
        header = 4 * (1 + int(codec.integrity) + len(msg.bucket_ids))
        off = header
        offs, unb = [], []
        for bi in msg.bucket_ids:
            b = plan.buckets[bi]
            nb = codec.nbytes(b.dim)
            offs.append(off)
            unb.append(nb)
            off += b.n * nb
        outs.append(MessageLayout(msg.bucket_ids, tuple(offs), tuple(unb),
                                  header, off, checksum=codec.integrity))
    return tuple(outs)


def _u32_bytes(words, B: int, device) -> torch.Tensor:
    """A tuple of uint32 values -> (B, 4 * len) uint8, the same row B times."""
    w = torch.tensor(words, dtype=torch.int64)
    row = torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)
    return row.view(torch.uint8).to(device)[None].expand(B, -1)


def _message_buffer(layout: MessageLayout, payload_mats) -> torch.Tensor:
    """Per-bucket payload regions (B, n_units * nbytes) -> (B, total_nbytes)
    uint8 buffers, one per worker: header ++ regions (with the checksum
    word after n_buckets under `layout.checksum`)."""
    B, dev = payload_mats[0].shape[0], payload_mats[0].device
    n_b = len(layout.bucket_ids)
    if not layout.checksum:
        return torch.cat([_u32_bytes((n_b,) + layout.offsets, B, dev),
                          *payload_mats], dim=1)
    tail = torch.cat([_u32_bytes(layout.offsets, B, dev), *payload_mats],
                     dim=1)
    head = torch.stack([torch.full((B,), n_b, dtype=torch.int64,
                                   device=dev), fletcher32(tail)], dim=1)
    head = torch.where(head >= 1 << 31, head - (1 << 32), head)
    return torch.cat([head.to(torch.int32).view(torch.uint8), tail], dim=1)


def verify_message(buf: torch.Tensor, layout: MessageLayout) -> torch.Tensor:
    """Integrity check of a fused message buffer (or a (B, total) batch of
    them) -> bool tensor: the Fletcher-32 of the covered span equals the
    stored header word. Requires layout.checksum."""
    if not layout.checksum:
        raise ValueError("verify_message needs a checksum layout "
                         "(codec.integrity=True)")
    stored = buf[..., 4:8].contiguous().view(torch.int32)[..., 0]
    stored = stored.to(torch.int64) & 0xFFFFFFFF
    return stored == fletcher32(buf[..., layout.checksum_span_start:])


def parse_message_header(buf, *, checksum: bool = False):
    """Host-side hardened header parse of one fused message buffer (the
    reference's wire.py:891-936): returns (n_buckets, offsets) after
    bounds-checking every field a receiver would slice with, raising
    ValueError on a malformed header. `checksum=True` parses the integrity
    layout; the checksum VALUE is verify_message's job."""
    if isinstance(buf, torch.Tensor):
        buf = buf.detach().cpu().numpy()
    b = np.asarray(buf, dtype=np.uint8).reshape(-1)
    total = b.size
    if total < 4 or total % 4:
        raise ValueError(
            f"message buffer must be a whole number of uint32 words and "
            f"hold at least the bucket count; got {total} bytes")
    words = b.view("<u4")
    n_buckets = int(words[0])
    lead = 1 + int(bool(checksum))
    header = 4 * (lead + n_buckets)
    if n_buckets < 1 or header > total:
        raise ValueError(
            f"malformed header: n_buckets={n_buckets} needs "
            f"{header} header bytes but the buffer has {total}")
    offsets = tuple(int(o) for o in words[lead:lead + n_buckets])
    if offsets[0] != header:
        raise ValueError(
            f"malformed header: first bucket offset {offsets[0]} != "
            f"header end {header}")
    prev = offsets[0]
    for j, off in enumerate(offsets[1:], start=1):
        if off < prev:
            raise ValueError(
                f"malformed header: offset[{j}]={off} < "
                f"offset[{j - 1}]={prev} (must be non-decreasing)")
        prev = off
    if prev > total:
        raise ValueError(
            f"malformed header: offset[{n_buckets - 1}]={prev} beyond "
            f"buffer end {total}")
    return n_buckets, offsets


def _bucket_region(buf: torch.Tensor, layout: MessageLayout, j: int,
                   n: int) -> torch.Tensor:
    """(B, total) buffers -> bucket j's (B * n, unit_nbytes) payload rows."""
    off, nb = layout.offsets[j], layout.unit_nbytes[j]
    return buf[:, off:off + n * nb].reshape(-1, nb)


def execute_schedule_wire(schedule, codec: WireCodec, grads, key,
                          post: Optional[Callable] = None,
                          wire_key: Optional[Callable] = None,
                          decode_local: bool = True):
    """Stream a CommSchedule through REAL wire buffers: per message, encode
    every member bucket (one pack launch each), concatenate the payload
    rows into one uint8 buffer behind the header, then decode each bucket
    back out of the buffer (one unpack launch each) and apply
    `post(payload_rows, xhat, unit_keys, d) -> y` (None: y = xhat). Unit keys
    pass through `wire_key` (e.g. the rank fold) before encode.
    `decode_local=False` skips the local decode for a post that does not
    read xhat (it gets None). Returns (tree, buffers); sum(8 * buf.numel())
    is the measured wire truth."""
    return _execute_wire(schedule, codec, grads, None, key, post, wire_key,
                         decode_local)


def execute_schedule_wire_with_state(schedule, codec: WireCodec, grads,
                                     state, key,
                                     post: Optional[Callable] = None,
                                     wire_key: Optional[Callable] = None):
    """Error-feedback twin of execute_schedule_wire: per unit e = x + m is
    encoded, and decode threads through codec.decode_ef_batch (one unpack
    launch per bucket plus the caller-side residual m' = e - xhat); post,
    if given, maps (payload, xhat, keys, d) to the output. Returns (tree,
    m_tree, buffers)."""
    return _execute_wire(schedule, codec, grads, state, key, post, wire_key,
                         True)


def _execute_wire(schedule, codec, grads, state, key, post, wire_key,
                  decode_local):
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
        kbs = [plan._bucket_keys(keys, b) for b in bs]
        wkbs = kbs if wire_key is None else [wire_key(k) for k in kbs]
        buf = _message_buffer(layout, [
            codec.encode_batch(e, k).reshape(B, -1)
            for e, k in zip(es, wkbs)])
        buffers.append(buf if batched else buf[0])
        for j, b in enumerate(bs):
            pay = _bucket_region(buf, layout, j, b.n)
            if state is not None:
                xhat, mn = codec.decode_ef_batch(pay, es[j], b.dim)
                plan._scatter_runs(*mout, b, mn)
            else:
                xhat = codec.decode_batch(pay, b.dim) if decode_local \
                    else None
            y = xhat if post is None else post(pay, xhat, kbs[j], b.dim)
            plan._scatter_runs(*out, b, y)
    tree = plan._assemble(*out, batched)
    if state is None:
        return tree, tuple(buffers)
    return tree, plan._assemble(*mout, batched), tuple(buffers)
