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
            bits_pack / bits_unpack for signSGD). `encode_rows_buckets`
            and `decode_rows_buckets` encode and decode every bucket of
            a step in one pack and one unpack launch (fields_pack /
            fields_unpack, or bits_pack / bits_unpack for signSGD); the
            allgather receive leg decodes a step's gathered rows with
            it.
  fused     `encode_batch` / `decode_batch` / `decode_ef_batch` of a whole
            bucket: one compress+pack kernel launch each way
            (kernels/ops.py). `fused=False` routes them to the per-unit
            rows instead (the reference's legacy fallback).
  grouped   `encode_buckets` / `decode_buckets` / `decode_ef_buckets` of
            every bucket of a step: one pack and one unpack launch for all
            of them under the fused QSGD, TernGrad and signSGD codecs and
            the natural and sparse codecs (whose per-unit and fused
            formats are one path), and under fused=False
            `encode_rows_buckets` and `decode_rows_buckets`.

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
then decodes every bucket of the step back OUT OF its buffer in one
decode_buckets call. With a (B, 2) key batch
every buffer is (B, nbytes): one message per worker, the reference's vmap
over workers written out. `integrity=True` adds a Fletcher-32 word to
the header, [n_buckets, fletcher32, offsets...], over every byte after it
(4 bytes a message; payloads and numerics unchanged); verify_message
checks it and parse_message_header validates a header's structure.

Streaming collectives: execute_schedule_stream moves each message buffer
hop by hop around the ranks of a process group (collectives.ring_shift,
in chunks of whole bucket regions, layout_chunks) instead of one blocking
all_gather, and decodes every arriving chunk the hop it arrives into
slotted (n, n_units, d) accumulators (WireCodec.decode_accumulate*).
Under mode="rs" each rank encodes only the shard it owns after a dense
reduce-scatter (shard_message_layouts).

`recorder=` (duck-typed, obs.trace.TraceRecorder) marks the stages of
both pipelines: compress, pack, decode, collective and ef_update per
message on the serialized path (the step's grouped encode and decode as
one interval shared by the messages they cover, obs.trace.mark_group),
and the stream's per-message stages plus a hop span per ring hop. None
or a disabled recorder runs the uninstrumented ops.

`faults=` (duck-typed, resil.FaultInjector) corrupts the bytes each
receiver sees (_receive_buffer): every message buffer on the serialized
path after pack, each arriving hop on the ring; with a checksum layout
the received bytes are verified, optionally replaced by the sender's
clean copy (resend) and the verdict noted on the injector. The returned
buffers and EF residuals are the sender's, always clean. An injector
that cannot touch the bytes (prob 0) runs exactly the ops of faults=None.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.convert import tree_map
from repro_torch.core import collectives
from repro_torch.core.compressors import (QSGD, AdaptiveThreshold,
                                          Compressor, Identity,
                                          NaturalCompression, RandomK,
                                          SignSGD, TernGrad, ThresholdV,
                                          TopK, _k_of, index_bits, pow2)
from repro_torch.core.plan import _active, _scope
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
# below 2**32 and a span's sums far below 2**63. The buffer is summed in
# spans of FLETCHER_SPAN bytes, each span's two sums taken mod 65535 and
# added up: exact, since both sums are mod 65535 and word i's coefficient
# nw - i only depends on its absolute position, so a full-width message
# never widens to int64 all at once.

_FLETCHER_MOD = 65535
#: bytes of a buffer summed at a time (even, so spans split whole words)
FLETCHER_SPAN = 1 << 24


def fletcher32(buf: torch.Tensor) -> torch.Tensor:
    """Fletcher-32 (init=1) of the last axis of a uint8 tensor -> int64
    tensor of the leading shape holding the uint32 checksum."""
    nbytes = buf.shape[-1]
    nw = (nbytes + 1) // 2
    s1 = torch.zeros(buf.shape[:-1], dtype=torch.int64, device=buf.device)
    s2 = torch.zeros_like(s1)
    for lo in range(0, nbytes, FLETCHER_SPAN):
        b = buf[..., lo:lo + FLETCHER_SPAN].to(torch.int64)
        if b.shape[-1] % 2:
            b = F.pad(b, (0, 1))
        words = (b[..., 0::2] | (b[..., 1::2] << 8)) % _FLETCHER_MOD
        del b
        w0 = lo // 2
        coef = torch.arange(nw - w0, nw - w0 - words.shape[-1], -1,
                            dtype=torch.int64,
                            device=buf.device) % _FLETCHER_MOD
        s1 = (s1 + words.sum(dim=-1)) % _FLETCHER_MOD
        s2 = (s2 + ((coef * words) % _FLETCHER_MOD).sum(dim=-1)
              ) % _FLETCHER_MOD
    s1 = (1 + s1) % _FLETCHER_MOD
    s2 = (nw % _FLETCHER_MOD + s2) % _FLETCHER_MOD
    return (s2 << 16) | s1


def not_ported(what: str, queue: str) -> NotImplementedError:
    """The error of a reference feature a later slice ports."""
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md "
                               f"Queue 1, {queue})")


# ---- value-record legs: f32, or the bf16 wire cast -------------------------
# The to_f32 / to_bf16 idiom: the wire carries bf16 (a deliberate lossy
# cast), compute stays f32.

# columns of a bucket's codes _dequantize converts at a time
DEQUANT_SPAN = 1 << 22


def _dequantize(codes: list, offset: int, scales: list) -> list:
    """(c - offset) * scale per bucket, in f32, written over the bucket's
    own int32 codes DEQUANT_SPAN columns at a time (each slice converted
    before it is overwritten), so a step's decode holds no second copy of
    its rows. c - offset is a small integer, exact in f32, so the
    subtraction in f32 gives the bits of the int32 one."""
    out = []
    for i, scale in enumerate(scales):
        c, codes[i] = codes[i], None
        x = c.view(torch.float32)
        for s in range(0, c.shape[-1], DEQUANT_SPAN):
            cols = slice(s, s + DEQUANT_SPAN)
            x[:, cols] = (c[:, cols].to(torch.float32) - offset) \
                * scale[:, None]
        out.append(x)
    return out


def to_f32(t):
    """bf16 leaves of a tree (or one tensor) -> f32, others untouched."""
    return tree_map(lambda x: x.to(torch.float32)
                    if x.dtype == torch.bfloat16 else x, t)


def to_bf16(t):
    """f32 leaves of a tree (or one tensor) -> bf16, others untouched."""
    return tree_map(lambda x: x.to(torch.bfloat16)
                    if x.dtype == torch.float32 else x, t)


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

    @property
    def name(self) -> str:
        return self.comp.name

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

    def encode_buckets(self, es, keys) -> list:
        """encode_batch of every bucket of a step: [(n_i, d_i) units] +
        [(n_i, 2) unit keys] -> [(n_i, nbytes(d_i)) uint8 rows]."""
        return [self.encode_batch(e, k) for e, k in zip(es, keys)]

    def decode_batch(self, payloads, d: int) -> torch.Tensor:
        """(n, nbytes(d)) uint8 rows -> (n, d) decoded f32 units."""
        return self.decode_rows(payloads, d)

    def decode_ef_batch(self, payloads, e2d, d: int):
        """Decode + error-feedback residual -> (xhat, m = e - xhat)."""
        xhat = self.decode_batch(payloads, d)
        return xhat, e2d - xhat

    def decode_rows_buckets(self, payloads_list, dims) -> list:
        """decode_rows of every bucket of a step: [(n_i, nbytes(d_i)) uint8
        rows] + [d_i] -> [(n_i, d_i) f32]."""
        return [self.decode_rows(p, d) for p, d in zip(payloads_list, dims)]

    def decode_buckets(self, payloads_list, dims) -> list:
        """decode_batch of every bucket of a step: [(n_i, nbytes(d_i)) uint8
        rows] + [d_i] -> [(n_i, d_i) f32]. fused=False: the per-unit
        decode_rows_buckets."""
        if not self.fused:
            return self.decode_rows_buckets(payloads_list, dims)
        return [self.decode_batch(p, d) for p, d in zip(payloads_list, dims)]

    def decode_ef_buckets(self, payloads_list, es, dims) -> list:
        """decode_ef_batch of every bucket of a step -> [(xhat_i, m_i)].
        fused=False: the per-unit decode_rows_buckets, then the residuals."""
        if not self.fused:
            return _ef_pairs(self.decode_rows_buckets(payloads_list, dims),
                             es)
        return [self.decode_ef_batch(p, e, d)
                for p, e, d in zip(payloads_list, es, dims)]

    # ---- per-hop streaming (ring collectives) ----------------------------
    # One hop delivers one source rank's payload rows; the receiver decodes
    # them the hop they arrive and writes them into an (n, n_units, d)
    # accumulator at the SOURCE rank's slot, never into a running sum: the
    # final worker mean then reduces the same array in the same rank order
    # as the allgather path's gathered decode, which is what keeps the ring
    # bit-identical to it (a sum in arrival order would associate the f32
    # adds differently on every rank).

    def decode_accumulate(self, payloads, acc, slot: int, d: int):
        """Decode (n_units, nbytes(d)) rows from rank `slot` into
        acc[slot] of the (n, n_units, d) accumulator; returns acc."""
        return self.decode_accumulate_buckets([payloads], [acc], slot,
                                              [d])[0]

    def decode_accumulate_ef(self, payloads, e2d, acc, slot: int, d: int):
        """The own payload's decode-accumulate under error feedback: also
        returns the residual m = e - xhat (decode_ef_batch), the local
        encode-leg EF discipline of the allgather wire path."""
        accs, ms = self.decode_accumulate_ef_buckets([payloads], [e2d],
                                                     [acc], slot, [d])
        return accs[0], ms[0]

    def decode_accumulate_buckets(self, payloads_list, accs, slot: int,
                                  dims) -> list:
        """decode_accumulate of several buckets from one source rank: one
        decode_buckets call (one grouped unpack launch), then each
        bucket's rows written at `slot`. Returns accs."""
        for acc, xhat in zip(accs, self.decode_buckets(payloads_list, dims)):
            acc[slot] = xhat
        return accs

    def decode_accumulate_ef_buckets(self, payloads_list, es, accs,
                                     slot: int, dims):
        """decode_accumulate_ef of several buckets in one
        decode_ef_buckets call -> (accs, [m_i])."""
        ms = []
        for acc, (xhat, m) in zip(accs, self.decode_ef_buckets(
                payloads_list, es, dims)):
            acc[slot] = xhat
            ms.append(m)
        return accs, ms


def _ef_pairs(xhats, es) -> list:
    """Decoded buckets + their EF inputs -> [(xhat, m = e - xhat)], the
    residual subtracted per bucket on the caller's side."""
    return [(x, e - x) for x, e in zip(xhats, es)]


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
        return self.encode_rows_buckets([x2d], [keys])[0]

    def encode_rows_buckets(self, es, keys):
        """encode_rows of every bucket of a step: each bucket quantized
        per unit, then every bucket's codes in one fields_pack launch."""
        qs = [self.comp._quantize(x.to(torch.float32), k)
              for x, k in zip(es, keys)]
        words = ops.fields_pack_units_buckets(
            [q.to(torch.int32) + self.comp.levels for q, _ in qs],
            [self.entry_bits] * len(qs))
        return [_stat_and_words(nrm, w) for (_, nrm), w in zip(qs, words)]

    def decode_rows(self, payloads, d: int):
        return self.decode_rows_buckets([payloads], [d])[0]

    def decode_rows_buckets(self, payloads_list, dims):
        """Every bucket's codes in one fields_unpack launch, then the
        dequantization per bucket."""
        splits = [_split(p) for p in payloads_list]
        codes = ops.fields_unpack_units_buckets(
            [w for _, w in splits], dims, [self.entry_bits] * len(dims))
        return _dequantize(codes, self.comp.levels,
                           [nrm / self.comp.levels for nrm, _ in splits])

    def encode_batch(self, x2d, keys):
        if not self.fused:
            return self.encode_rows(x2d, keys)
        return self.encode_buckets([x2d], [keys])[0]

    def encode_buckets(self, es, keys):
        """Fused: one pack launch for all the buckets (up to MAX_BUCKETS);
        per-unit: encode_rows_buckets."""
        if not self.fused:
            return self.encode_rows_buckets(es, keys)
        return [_stat_and_words(nrm, w) for w, nrm in
                ops.qsgd_pack_units_buckets(es, keys, self.comp.levels,
                                            self.entry_bits)]

    def decode_batch(self, payloads, d: int):
        if not self.fused:
            return self.decode_rows(payloads, d)
        return self.decode_buckets([payloads], [d])[0]

    def decode_ef_batch(self, payloads, e2d, d: int):
        if not self.fused:
            return super().decode_ef_batch(payloads, e2d, d)
        nrm, w = _split(payloads)
        return ops.qsgd_unpack_ef_units(w, nrm, e2d, d, self.comp.levels,
                                        self.entry_bits)

    def decode_buckets(self, payloads_list, dims):
        """Fused: one unpack launch for all the buckets (up to
        MAX_BUCKETS)."""
        if not self.fused:
            return super().decode_buckets(payloads_list, dims)
        splits = [_split(p) for p in payloads_list]
        return ops.qsgd_unpack_units_buckets(
            [w for _, w in splits], [nrm for nrm, _ in splits], dims,
            self.comp.levels, self.entry_bits)

    def decode_ef_buckets(self, payloads_list, es, dims):
        if not self.fused:
            return super().decode_ef_buckets(payloads_list, es, dims)
        return _ef_pairs(self.decode_buckets(payloads_list, dims), es)


@dataclasses.dataclass(frozen=True)
class TernGradCodec(WireCodec):
    """f32 unit scale + 2-bit ternary codes (t + 1 in {0, 1, 2})."""
    comp: Compressor = TernGrad()

    def nbytes(self, d: int) -> int:
        return 4 + 4 * words_for(2 * d)

    def encode_rows(self, x2d, keys):
        return self.encode_rows_buckets([x2d], [keys])[0]

    def encode_rows_buckets(self, es, keys):
        """encode_rows of every bucket of a step: each bucket quantized
        per unit, then every bucket's codes in one fields_pack launch."""
        ts = [self.comp._quantize(x.to(torch.float32), k)
              for x, k in zip(es, keys)]
        words = ops.fields_pack_units_buckets(
            [t.to(torch.int32) + 1 for t, _ in ts], [2] * len(ts))
        return [_stat_and_words(s, w) for (_, s), w in zip(ts, words)]

    def decode_rows(self, payloads, d: int):
        return self.decode_rows_buckets([payloads], [d])[0]

    def decode_rows_buckets(self, payloads_list, dims):
        """Every bucket's codes in one fields_unpack launch, then the
        dequantization per bucket."""
        splits = [_split(p) for p in payloads_list]
        codes = ops.fields_unpack_units_buckets(
            [w for _, w in splits], dims, [2] * len(dims))
        return _dequantize(codes, 1, [s for s, _ in splits])

    def encode_batch(self, x2d, keys):
        if not self.fused:
            return self.encode_rows(x2d, keys)
        return self.encode_buckets([x2d], [keys])[0]

    def encode_buckets(self, es, keys):
        """Fused: one pack launch for all the buckets (up to MAX_BUCKETS);
        per-unit: encode_rows_buckets."""
        if not self.fused:
            return self.encode_rows_buckets(es, keys)
        return [_stat_and_words(s, w)
                for w, s in ops.terngrad_pack_units_buckets(es, keys)]

    def decode_batch(self, payloads, d: int):
        if not self.fused:
            return self.decode_rows(payloads, d)
        return self.decode_buckets([payloads], [d])[0]

    def decode_ef_batch(self, payloads, e2d, d: int):
        if not self.fused:
            return super().decode_ef_batch(payloads, e2d, d)
        s, w = _split(payloads)
        return ops.terngrad_unpack_ef_units(w, s, e2d, d)

    def decode_buckets(self, payloads_list, dims):
        """Fused: one unpack launch for all the buckets (up to
        MAX_BUCKETS)."""
        if not self.fused:
            return super().decode_buckets(payloads_list, dims)
        splits = [_split(p) for p in payloads_list]
        return ops.terngrad_unpack_units_buckets(
            [w for _, w in splits], [s for s, _ in splits], dims)

    def decode_ef_buckets(self, payloads_list, es, dims):
        if not self.fused:
            return super().decode_ef_buckets(payloads_list, es, dims)
        return _ef_pairs(self.decode_buckets(payloads_list, dims), es)


@dataclasses.dataclass(frozen=True)
class SignSGDCodec(WireCodec):
    """1 bit per entry (x >= 0). `majority_vote` aggregates n workers'
    payloads on the packed words — the signSGD-with-majority-vote wire
    protocol (Bernstein et al.): only packed signs ever travel."""
    comp: Compressor = SignSGD()

    def nbytes(self, d: int) -> int:
        return 4 * words_for(d)

    def encode_rows(self, x2d, keys):
        return self.encode_rows_buckets([x2d], [keys])[0]

    def encode_rows_buckets(self, es, keys):
        """encode_rows of every bucket of a step: every bucket's signs in
        one bits_pack launch."""
        return [_rows_to_u8(w)
                for w in ops.pack_words_buckets([x >= 0 for x in es])]

    def decode_rows(self, payloads, d: int):
        return self.decode_rows_buckets([payloads], [d])[0]

    def decode_rows_buckets(self, payloads_list, dims):
        """Every bucket's bits in one bits_unpack launch."""
        bits = ops.unpack_words_buckets(
            [_u8_rows_to(p, torch.int32) for p in payloads_list], dims)
        return [(2 * b - 1).to(torch.float32) for b in bits]

    def encode_batch(self, x2d, keys):
        if not self.fused:
            return self.encode_rows(x2d, keys)
        return self.encode_buckets([x2d], [keys])[0]

    def encode_buckets(self, es, keys):
        """Fused: one pack launch for all the buckets (up to MAX_BUCKETS);
        per-unit: encode_rows_buckets."""
        if not self.fused:
            return self.encode_rows_buckets(es, keys)
        return [_rows_to_u8(w) for w in ops.sign_pack_units_buckets(es)]

    def decode_batch(self, payloads, d: int):
        if not self.fused:
            return self.decode_rows(payloads, d)
        return self.decode_buckets([payloads], [d])[0]

    def decode_ef_batch(self, payloads, e2d, d: int):
        if not self.fused:
            return super().decode_ef_batch(payloads, e2d, d)
        return ops.sign_unpack_ef_units(_u8_rows_to(payloads, torch.int32),
                                        e2d, d)

    def decode_buckets(self, payloads_list, dims):
        """Fused: one unpack launch for all the buckets (up to
        MAX_BUCKETS)."""
        if not self.fused:
            return super().decode_buckets(payloads_list, dims)
        return ops.sign_unpack_units_buckets(
            [_u8_rows_to(p, torch.int32) for p in payloads_list], dims)

    def decode_ef_buckets(self, payloads_list, es, dims):
        if not self.fused:
            return super().decode_ef_buckets(payloads_list, es, dims)
        return _ef_pairs(self.decode_buckets(payloads_list, dims), es)

    def majority_vote(self, payloads, d: int) -> torch.Tensor:
        """(n_workers, ..., nbytes(d)) packed payloads -> (..., nbytes(d)):
        bit i of each unit is the majority sign of entry i over the
        workers (ties -> +1, the x >= 0 convention). Fused: bit-sliced
        counting on the packed words of every unit at once (one majority
        launch); otherwise unpack, count, pack (the reference's non-fused
        vote, wire.py:579-594). Zero padding bits vote 0 on both paths, so
        both give the same bytes."""
        return self.majority_vote_buckets([payloads], [d])[0]

    def majority_vote_buckets(self, payloads_list, dims) -> list:
        """majority_vote of every bucket of a step: [(n_workers, ...,
        nbytes(d_i)) payloads] + [d_i] -> [(..., nbytes(d_i))]. Fused:
        every bucket's words in one majority launch; otherwise every
        bucket's rows in one bits_unpack launch, the count per bucket, and
        every vote in one bits_pack launch."""
        if self.fused:
            votes = ops.majority_words_buckets(
                [_u8_rows_to(p.reshape(p.shape[0], -1), torch.int32)
                 for p in payloads_list])
            return [_rows_to_u8(v[None]).reshape(p.shape[1:])
                    for v, p in zip(votes, payloads_list)]
        bits = ops.unpack_words_buckets(
            [_u8_rows_to(p.reshape(-1, p.shape[-1]), torch.int32)
             for p in payloads_list], dims)
        majs = [(2 * b.reshape(p.shape[0], -1, d).sum(dim=0)
                 >= p.shape[0]).to(torch.int32)
                for b, p, d in zip(bits, payloads_list, dims)]
        return [_rows_to_u8(w).reshape(p.shape[1:])
                for w, p in zip(ops.pack_words_buckets(majs), payloads_list)]


@dataclasses.dataclass(frozen=True)
class NaturalCodec(WireCodec):
    """9-bit codes: sign * (exponent + 128), offset by 255 into [0, 510]
    (255 encodes exact zero). Per-unit and fused formats share one path:
    exponent draws per bucket, then one fields_pack launch for all the
    buckets of a step (and one fields_unpack to decode them)."""
    comp: Compressor = NaturalCompression()

    def nbytes(self, d: int) -> int:
        return 4 * words_for(9 * d)

    def encode_rows(self, x2d, keys):
        return self.encode_buckets([x2d], [keys])[0]

    def encode_buckets(self, es, keys):
        codes = []
        for x2d, k in zip(es, keys):
            e, sgn, zero = self.comp._exponents(x2d.to(torch.float32), k)
            codes.append(torch.where(zero, 0, sgn.to(torch.int32)
                                     * (e + self.comp._BIAS + 1)) + 255)
        return [_rows_to_u8(w) for w in
                ops.fields_pack_units_buckets(codes, [9] * len(codes))]

    def decode_rows(self, payloads, d: int):
        return self.decode_buckets([payloads], [d])[0]

    def decode_rows_buckets(self, payloads_list, dims):
        return self.decode_buckets(payloads_list, dims)

    def decode_buckets(self, payloads_list, dims):
        codes = ops.fields_unpack_units_buckets(
            [_u8_rows_to(p, torch.int32) for p in payloads_list], dims,
            [9] * len(dims))
        out = []
        for code in codes:
            code = code - 255
            val = torch.sign(code).to(torch.float32) * pow2(
                code.abs() - (self.comp._BIAS + 1))
            out.append(torch.where(code == 0, 0.0, val))
        return out

    def decode_ef_buckets(self, payloads_list, es, dims):
        return _ef_pairs(self.decode_buckets(payloads_list, dims), es)


@dataclasses.dataclass(frozen=True)
class SparseCodec(WireCodec):
    """k records of (f32 value, ceil(log2 d)-bit index): topk / randomk
    (exact_sim) and the capacity-bounded threshold methods (not). Values
    travel first (4k bytes, or 2k word-padded at wire_dtype="bfloat16"),
    then the packed index leg. Decode scatters the values into zeros at
    their (unique) indices. Per-unit and fused formats share one path.
    Resolves PerDimRatio wrappers (control/policy.py) per unit dimension,
    so adaptive per-bucket ratios wire with each bucket's own k: one
    grouped pack / unpack launch then carries index legs of different k
    and width."""
    comp: Compressor = TopK()
    sim_exact: bool = True

    _SUPPORTS_BF16 = True

    @property
    def exact_sim(self) -> bool:
        return self.sim_exact and self.wire_dtype == "float32"

    def _c(self, d: int) -> Compressor:
        return (self.comp.for_dim(d) if hasattr(self.comp, "for_dim")
                else self.comp)

    def _k(self, d: int) -> int:
        c = self._c(d)
        return _k_of(c.ratio if hasattr(c, "ratio") else c.cap_ratio, d)

    def _vb(self, d: int) -> int:
        """Byte size of the value leg at this wire dtype."""
        return _value_nbytes(self._k(d), self.wire_dtype)

    def nbytes(self, d: int) -> int:
        return self._vb(d) + 4 * words_for(self._k(d) * index_bits(d))

    def payload_bits(self, d: int) -> int:
        if self.wire_dtype == "float32":
            return self._c(d).payload_bits(d)
        return self._k(d) * (16 + index_bits(d))

    def encode_rows(self, x2d, keys):
        return self.encode_buckets([x2d], [keys])[0]

    def encode_buckets(self, es, keys):
        """Records per bucket, then every index leg in one pack launch."""
        recs = [self._c(x2d.shape[1]).encode(x2d.to(torch.float32), k)
                for x2d, k in zip(es, keys)]
        words = ops.fields_pack_units_buckets(
            [r["idx"] for r in recs], [index_bits(x.shape[1]) for x in es])
        return [torch.cat([_val_rows_to_u8(r["val"], self.wire_dtype),
                           _rows_to_u8(w)], dim=1)
                for r, w in zip(recs, words)]

    def decode_rows(self, payloads, d: int):
        return self.decode_buckets([payloads], [d])[0]

    def decode_rows_buckets(self, payloads_list, dims):
        return self.decode_buckets(payloads_list, dims)

    def decode_buckets(self, payloads_list, dims):
        """Every index leg in one unpack launch, then the scatter per
        bucket."""
        idxs = ops.fields_unpack_units_buckets(
            [_u8_rows_to(p[:, self._vb(d):], torch.int32)
             for p, d in zip(payloads_list, dims)],
            [self._k(d) for d in dims], [index_bits(d) for d in dims])
        out = []
        for p, d, idx in zip(payloads_list, dims, idxs):
            val = _u8_rows_to_vals(p[:, :self._vb(d)], self._k(d),
                                   self.wire_dtype)
            idx = idx.to(torch.int64)
            # a field can point past the unit only in corrupted bytes; the
            # reference's scatter drops such entries, here they land in a
            # spare column cut off after the scatter
            spare = int((1 << index_bits(d)) > d)
            z = torch.zeros((p.shape[0], d + spare), dtype=torch.float32,
                            device=p.device)
            if spare:
                idx = idx.clamp_max(d)
            out.append(z.scatter_(1, idx, val)[:, :d])
        return out

    def decode_ef_buckets(self, payloads_list, es, dims):
        return _ef_pairs(self.decode_buckets(payloads_list, dims), es)


def wire_codec(comp: Compressor, wire_dtype: str = "float32",
               fused: bool = True, integrity: bool = False) -> WireCodec:
    """The WireCodec materializing `comp`'s payloads. Raises ValueError for
    a compressor with no wire format, or a bf16 cast of a codec without
    value records (the reference's errors). `fused=False` runs the batch
    entry points through the per-unit rows; `integrity=True` adds the
    Fletcher-32 header word to every fused message."""
    kw = dict(fused=fused, wire_dtype=wire_dtype, integrity=integrity)
    base = comp.base if hasattr(comp, "base") else comp  # PerDimRatio
    if isinstance(base, (TopK, RandomK)):
        return SparseCodec(comp=comp, **kw)
    if isinstance(base, (ThresholdV, AdaptiveThreshold)):
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

    @property
    def payload_nbytes(self) -> int:
        return self.total_nbytes - self.header_nbytes


def _layouts(schedule, codec: WireCodec, unit_dim) -> Tuple[MessageLayout,
                                                             ...]:
    """Layouts of every message, bucket b's units `unit_dim(b.dim)` wide."""
    plan = schedule.plan
    outs = []
    for msg in schedule.messages:
        header = 4 * (1 + int(codec.integrity) + len(msg.bucket_ids))
        off = header
        offs, unb = [], []
        for bi in msg.bucket_ids:
            b = plan.buckets[bi]
            nb = codec.nbytes(unit_dim(b.dim))
            offs.append(off)
            unb.append(nb)
            off += b.n * nb
        outs.append(MessageLayout(msg.bucket_ids, tuple(offs), tuple(unb),
                                  header, off, checksum=codec.integrity))
    return tuple(outs)


@functools.lru_cache(maxsize=256)
def message_layouts(schedule, codec: WireCodec) -> Tuple[MessageLayout, ...]:
    """Static layouts of every fused message of (schedule, codec)."""
    return _layouts(schedule, codec, lambda d: d)


def _shard_dim(d: int, n_workers: int) -> int:
    """Owned-shard length of a d-entry unit on n workers (ceil; the last
    worker's shard is short when n does not divide d: the true per-worker
    sizes are min(ds, d - w * ds), which bits.comm_report charges)."""
    return -(-d // n_workers)


@functools.lru_cache(maxsize=256)
def shard_message_layouts(schedule, codec: WireCodec,
                          n_workers: int) -> Tuple[MessageLayout, ...]:
    """message_layouts for the rs-stream path: each bucket's unit payload
    is sized on the OWNED SHARD (ceil(d / n) entries), since under
    compress -> reduce-scatter -> allgather each worker encodes only the
    shard it owns."""
    return _layouts(schedule, codec, lambda d: _shard_dim(d, n_workers))


@functools.lru_cache(maxsize=1024)
def layout_chunks(layout: MessageLayout,
                  chunk_bytes: Optional[float]) -> Tuple[Tuple, ...]:
    """Static chunk table of one message buffer: (bucket_positions,
    byte_start, byte_stop) tuples, runs of whole bucket regions grouped
    under `chunk_bytes` (ops.chunk_runs), so every chunk decodes with
    whole-bucket unpack launches the hop it arrives. Chunk 0 carries the
    header bytes along (receivers use the static layout)."""
    ends = layout.offsets[1:] + (layout.total_nbytes,)
    runs = ops.chunk_runs([e - o for o, e in zip(layout.offsets, ends)],
                          chunk_bytes)
    return tuple((run, 0 if run[0] == 0 else layout.offsets[run[0]],
                  ends[run[-1]]) for run in runs)


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


def _receive_buffer(buf, layout: MessageLayout, faults, key, tag: int):
    """The receive leg of one fused message (B, total) under fault
    injection (the reference's wire.py:951-969): corrupt the bytes past
    the header with (B, 2) keys, verify the Fletcher-32 word, with resend
    put back the sender's clean copy where it failed, and note the (B,)
    verdicts. A pass-through injector returns `buf` itself."""
    rbuf = faults.corrupt(buf, key, tag=tag, start=layout.header_nbytes)
    if rbuf is buf:
        return buf
    return _verify_received(rbuf, buf, layout, faults, tag)


def _verify_received(rbuf, clean, layout: MessageLayout, faults, tag: int):
    """Verify received message bytes (B, total) or (total,) against their
    Fletcher-32 word, with resend put back the sender's `clean` copy where
    it failed, and note the verdicts under `tag`. Without a checksum
    layout the bytes pass unverified."""
    if layout.checksum:
        ok = verify_message(rbuf, layout)
        if getattr(faults, "resend", False):
            rbuf = torch.where(ok[..., None], rbuf, clean)
        faults.note(tag, ok)
    return rbuf


def execute_schedule_wire(schedule, codec: WireCodec, grads, key,
                          post: Optional[Callable] = None,
                          wire_key: Optional[Callable] = None,
                          decode_local: bool = True, recorder=None,
                          faults=None):
    """Stream a CommSchedule through REAL wire buffers: encode every bucket
    of the schedule (codec.encode_buckets: one pack launch for all of them
    under every codec but the dense one, which launches none), then per
    message concatenate its payload rows into one
    uint8 buffer behind the header, decode every bucket back out of its
    buffer (codec.decode_buckets: one unpack launch each, one for all of
    them under the fused QSGD, natural and sparse codecs and the per-unit
    codecs) and apply `post(payload_rows, xhat, unit_keys, d) -> y` (None:
    y = xhat) bucket by bucket, or, where the post has one, its bucket-list
    form `post.buckets([payload_rows], [xhat], [unit_keys], [d]) -> [y]`
    once over every bucket in order. Unit keys pass through `wire_key`
    (e.g. the rank fold) before encode. `decode_local=False` skips the
    local decode for a post that does not read xhat (it gets None).
    Returns (tree, buffers); sum(8 * buf.numel()) is the measured wire
    truth. `recorder` marks compress (the grouped encode, one interval
    for every message), pack (each message's buffer), decode (the grouped
    decode) and, with a post, collective; the allgather post.buckets
    marks its gathers and the mean as collective and its decode as
    decode. `faults` corrupts each message's RECEIVED bytes after pack
    (_receive_buffer, the step key `key` per row and the message index
    as tag): decode and post read the received bucket regions, the
    returned buffers stay the sender's clean copies."""
    return _execute_wire(schedule, codec, grads, None, key, post, wire_key,
                         decode_local, recorder, faults)


def execute_schedule_wire_with_state(schedule, codec: WireCodec, grads,
                                     state, key,
                                     post: Optional[Callable] = None,
                                     wire_key: Optional[Callable] = None,
                                     recorder=None, faults=None):
    """Error-feedback twin of execute_schedule_wire: per unit e = x + m is
    encoded, and decode threads through codec.decode_ef_buckets (the
    unpack launches of decode_buckets plus the caller-side residual
    m' = e - xhat per bucket); post, if given, maps (payload, xhat, keys,
    d) to the output, or its bucket-list form the whole step, as in
    execute_schedule_wire. Returns (tree, m_tree, buffers). `recorder`
    marks the stages as in execute_schedule_wire, plus ef_update once the
    residuals are written. `faults` corrupts the RECEIVED bytes only: the
    residual is sender-side state, taken from the clean regions
    (decode_ef_buckets), while xhat and post read the received ones (one
    more grouped decode_buckets call when the injector touches bytes),
    so corruption can poison a step's decoded gradient but never the
    error-feedback discipline (the reference's wire.py:1134-1150)."""
    return _execute_wire(schedule, codec, grads, state, key, post, wire_key,
                         True, recorder, faults)


def _message_attrs(schedule, codec) -> list:
    """Each message's span attribution (TraceRecorder.mark keywords)."""
    plan = schedule.plan
    return [dict(message=mi, bucket_ids=msg.bucket_ids,
                 dims=tuple(plan.buckets[bi].dim for bi in msg.bucket_ids),
                 n_units=sum(plan.buckets[bi].n for bi in msg.bucket_ids),
                 codec=codec.name)
            for mi, msg in enumerate(schedule.messages)]


def _execute_wire(schedule, codec, grads, state, key, post, wire_key,
                  decode_local, recorder=None, faults=None):
    rec = _active(recorder)
    plan = schedule.plan
    leaves, batched = plan._inputs(grads, key)
    B = leaves[0].shape[0]
    need = plan.needs_flat
    flat = plan._flat(leaves) if need else None
    if state is not None:
        sleaves, _ = plan._inputs(state, key)
        mflat = plan._flat(sleaves) if need else None
    keys = plan._keys(key, leaves[0].device)
    step = f"repro/msg0-{schedule.num_messages - 1}"   # grouped scopes
    if rec is not None:
        rec.begin(leaves[0], label="grads_ready")
        attrs = _message_attrs(schedule, codec)
    # every bucket's encode input and key for the whole schedule, encoded
    # in one call (one pack launch under the grouped codecs), then message
    # by message
    bs = [plan.buckets[bi] for msg in schedule.messages
          for bi in msg.bucket_ids]
    es = [plan._gather_runs(leaves, flat, b) for b in bs]
    if state is not None:
        es = [e + plan._gather_runs(sleaves, mflat, b)
              for e, b in zip(es, bs)]
    kbs = [plan._bucket_keys(keys, b) for b in bs]
    wkbs = kbs if wire_key is None else [wire_key(k) for k in kbs]
    with _scope(rec, step + "/compress"):
        pays = codec.encode_buckets(es, wkbs)
    if rec is not None:
        rec.mark_group(pays, "compress", attrs)
    if state is None:   # only the EF decode reads the encode inputs again
        es = flat = None
    # every message buffer, then every bucket's region of its buffer (the
    # received buffer's under faults); each payload is let go once it is
    # in its buffer
    fkeys = None if faults is None else key.reshape(-1, 2)
    buffers, regions, clean, touched = [], [], [], False
    for mi, (msg, layout) in enumerate(zip(schedule.messages,
                                           message_layouts(schedule,
                                                           codec))):
        with _scope(rec, f"repro/msg{mi}/pack"):
            mats = [pays.pop(0).reshape(B, -1) for _ in msg.bucket_ids]
            buf = _message_buffer(layout, mats)
        if rec is not None:
            rec.mark(buf, "pack", **attrs[mi])
        del mats
        buffers.append(buf if batched else buf[0])
        rbuf = (buf if faults is None
                else _receive_buffer(buf, layout, faults, fkeys, mi))
        got = [_bucket_region(rbuf, layout, j, plan.buckets[bi].n)
               for j, bi in enumerate(msg.bucket_ids)]
        regions += got
        if faults is not None and state is not None:
            touched |= rbuf is not buf
            clean += got if rbuf is buf else [
                _bucket_region(buf, layout, j, plan.buckets[bi].n)
                for j, bi in enumerate(msg.bucket_ids)]
        del rbuf, got
    # decode every bucket of the step in one call (one unpack launch under
    # every fused codec with a kernel and every per-unit codec),
    # then post in bucket order, so collectives inside post keep their
    # order, and scatter, each bucket's rows let go once scattered
    dims = [b.dim for b in bs]
    if state is not None:
        mout = ([None] * len(leaves), plan._new_flat(leaves) if need else None)
        with _scope(rec, step + "/decode"):
            # the residual from the sender's clean regions; a receiver
            # whose bytes were touched decodes its own regions
            dec = codec.decode_ef_buckets(clean if touched else regions, es,
                                          dims)
            if touched:
                recv = codec.decode_buckets(regions, dims)
        if rec is not None:
            rec.mark_group([x for x, _ in dec], "decode", attrs)
        for b, (_, mn) in zip(bs, dec):
            plan._scatter_runs(*mout, b, mn)
        if rec is not None:
            rec.mark_group([mn for _, mn in dec], "ef_update", attrs)
        xhats = recv if touched else [x for x, _ in dec]
        del dec, clean
    elif decode_local:
        with _scope(rec, step + "/decode"):
            xhats = codec.decode_buckets(regions, dims)
        if rec is not None:
            rec.mark_group(xhats, "decode", attrs)
    else:
        xhats = [None] * len(bs)
    if post is None:
        ys = xhats
    elif hasattr(post, "buckets"):        # the whole step in one call
        mark = None if rec is None else (
            lambda dep, stage: rec.mark_group(dep, stage, attrs))
        with _scope(rec, step + "/collective"):
            ys = post.buckets(regions, xhats, kbs, dims, mark=mark)
    else:                                 # each message's own collective
        ys, i = [], 0
        for mi, msg in enumerate(schedule.messages):
            j = i + len(msg.bucket_ids)
            with _scope(rec, f"repro/msg{mi}/collective"):
                ys += [post(regions[k], xhats[k], kbs[k], dims[k])
                       for k in range(i, j)]
            if rec is not None:
                rec.mark(ys[i:j], "collective", **attrs[mi])
            i = j
    ys, xhats = list(ys), None
    out = ([None] * len(leaves), plan._new_flat(leaves) if need else None)
    for i, b in enumerate(bs):
        plan._scatter_runs(*out, b, ys[i])
        ys[i] = None
    tree = plan._assemble(*out, batched)
    if state is None:
        return tree, tuple(buffers)
    return tree, plan._assemble(*mout, batched), tuple(buffers)


# ---- streaming collectives: the chunked ring across ranks -------------------

def execute_schedule_stream(schedule, codec: WireCodec,
                            post: Optional[Callable], grads, state, key, *,
                            group=None, n_workers: int, mode: str = "ring",
                            wire_key: Optional[Callable] = None,
                            chunk_bytes: Optional[float] = None,
                            recorder=None, faults=None):
    """Stream a CommSchedule through the chunked ring across the ranks of
    `group` (the reference's wire.py:1234-1529).

    The twin of execute_schedule_wire: per fused message the packed uint8
    buffer moves hop by hop around the ranks (n - 1 collectives.ring_shift
    steps of each chunk of layout_chunks(layout, chunk_bytes)) instead of
    one blocking all_gather, and every arriving chunk is decoded the hop
    it arrives, all its buckets in one decode_accumulate_buckets call (one
    grouped unpack launch), into slotted (n, n_units, d) accumulators at
    the source rank (rank - h) mod n. Messages run in schedule order as a
    depth-2 pipeline: prepare(m + 1) (gather, the rs reduce-scatter, one
    encode_buckets call, the buffer) is issued before finish(m) (the own
    decode, with EF, the hops, then the mean and `post`). Eager PyTorch
    keeps program order, so no barrier is needed.

    mode="ring": every rank's full-unit payload circulates; the mean over
    the rank axis of each accumulator (aggregation.worker_mean's order)
    then `post(xm2d, unit_keys)` (None: the mean) gives the allgather wire
    path's bits for every codec.

    mode="rs": each bucket's dense units, padded to n * ceil(d / n), are
    reduce-scattered (collectives.reduce_scatter, rank-order sums, / n),
    the padding of the own shard masked to +0.0, and only the own shard is
    encoded (shard_message_layouts); the packed shards circulate and the
    gathered shards, concatenated and trimmed to d, are the mean. Under
    error feedback only the owned slice of each residual row is live.

    Error feedback (state given): e = x + m is encoded and m' = e -
    decode(own payload), local to the encode leg, as on the allgather wire
    path. `wire_key` maps unit keys before encode (the rank fold). Returns
    (tree, buffers), or (tree, m_tree, buffers) with state; the buffers
    are this rank's own messages.

    `recorder` marks each message's compress and pack (its own encode
    launch and buffer), decode (the own payload) and ef_update, a hop
    span per ring hop (n_messages x (n - 1) a step) and collective (the
    mean and post); None or a disabled recorder runs the uninstrumented
    ops.

    `faults` (duck-typed, resil.FaultInjector) corrupts each ARRIVING hop
    (the reference's wire.py:1445-1462): the hop's chunks concatenated,
    corrupt_hop under the step `key` with tag (mi << 12) | h past the
    header (bit flips, truncation, a dropped or a duplicated stale hop),
    verified on arrival with a checksum layout, optionally resent (the
    clean arrived copy) and noted; the hop is decoded from the possibly
    corrupted chunks and forwarded as received. A duplicated hop is a
    VALID stale message: its checksum passes (catching it needs sequence
    numbers). An injector with prob 0 runs the ops of faults=None."""
    if mode not in ("ring", "rs"):
        raise ValueError(f"mode must be 'ring' or 'rs', got {mode!r}")
    rank, n = dist.get_rank(group), dist.get_world_size(group)
    if n != n_workers:
        raise ValueError(f"n_workers={n_workers} but the group has {n} ranks")
    if key.dim() != 1:
        raise ValueError("the streaming collectives take one (2,) key: each "
                         "rank holds one gradient tree")
    with_state = state is not None
    plan = schedule.plan
    leaves, _ = plan._inputs(grads, key)
    dev = leaves[0].device
    need = plan.needs_flat
    flat = plan._flat(leaves) if need else None
    if with_state:
        sleaves, _ = plan._inputs(state, key)
        mflat = plan._flat(sleaves) if need else None
    keys = plan._keys(key, dev)
    hop_faults = faults is not None and faults.touches(hop=True)
    out = ([None] * len(leaves), plan._new_flat(leaves) if need else None)
    mout = ([None] * len(leaves), plan._new_flat(leaves) if need else None)
    layouts = (message_layouts(schedule, codec) if mode == "ring"
               else shard_message_layouts(schedule, codec, n))
    buffers = []
    rec = _active(recorder)
    if rec is not None:
        rec.begin(leaves[0], label="grads_ready")
        attrs = _message_attrs(schedule, codec)

    def prepare(mi, msg, layout):
        bs = [plan.buckets[bi] for bi in msg.bucket_ids]
        xs = [plan._gather_runs(leaves, flat, b) for b in bs]
        ms = ([plan._gather_runs(sleaves, mflat, b) for b in bs]
              if with_state else [None] * len(bs))
        if mode == "ring":
            dims = [b.dim for b in bs]
            es = [x + m for x, m in zip(xs, ms)] if with_state else xs
            mps = [None] * len(bs)
        else:
            dims = [_shard_dim(b.dim, n) for b in bs]
            es, mps = [], []
            for b, x, m, ds in zip(bs, xs, ms, dims):
                pad = n * ds - b.dim
                shard = collectives.reduce_scatter(F.pad(x, (0, pad)),
                                                   group) / n
                # the padding enters as exact zeros; the mask pins that
                # nothing phantom reaches encode
                own = (rank * ds + torch.arange(ds, device=dev)) < b.dim
                shard = torch.where(own, shard, 0.0)
                if with_state:
                    mp = F.pad(m, (0, pad))
                    es.append(shard + mp[:, rank * ds:(rank + 1) * ds])
                    mps.append(mp)
                else:
                    es.append(shard)
                    mps.append(None)
        kbs = [plan._bucket_keys(keys, b) for b in bs]
        wkbs = kbs if wire_key is None else [wire_key(k) for k in kbs]
        with _scope(rec, f"repro/msg{mi}/compress"):
            mats = codec.encode_buckets(es, wkbs)
        if rec is not None:
            rec.mark(mats, "compress", **attrs[mi])
        with _scope(rec, f"repro/msg{mi}/pack"):
            buf = _message_buffer(layout, [p.reshape(1, -1)
                                           for p in mats])[0]
        if rec is not None:
            rec.mark(buf, "pack", **attrs[mi])
        buffers.append(buf)
        return dict(mi=mi, bs=bs, layout=layout, buf=buf, es=es, mps=mps,
                    dims=dims, kbs=kbs)

    def finish(p):
        mi, bs, layout, buf, dims = (p["mi"], p["bs"], p["layout"], p["buf"],
                                     p["dims"])
        with _scope(rec, f"repro/msg{mi}/decode"):
            accs = [torch.zeros((n, b.n, d), dtype=torch.float32,
                                device=dev) for b, d in zip(bs, dims)]
            own = [_bucket_region(buf[None], layout, j, b.n)
                   for j, b in enumerate(bs)]
            if with_state:
                accs, mns = codec.decode_accumulate_ef_buckets(
                    own, p["es"], accs, rank, dims)
            else:
                accs = codec.decode_accumulate_buckets(own, accs, rank, dims)
        if rec is not None:
            rec.mark(accs, "decode", **attrs[mi])
            if with_state:
                rec.mark(mns, "ef_update", **attrs[mi])
        chunks = layout_chunks(layout, chunk_bytes)
        cur = [buf[s:e] for _, s, e in chunks]

        def decode_chunk(c, src):
            run, start, _ = chunks[c]
            pays = [cur[c][layout.offsets[j] - start:
                           layout.offsets[j] - start
                           + bs[j].n * layout.unit_nbytes[j]]
                    .reshape(bs[j].n, layout.unit_nbytes[j]) for j in run]
            codec.decode_accumulate_buckets(pays, [accs[j] for j in run],
                                            src, [dims[j] for j in run])

        for h in range(1, n):
            src = (rank - h) % n
            with _scope(rec, f"repro/msg{mi}/hop{h}"):
                # the whole hop arrives; under hop faults it is faulted as
                # one message (the chunks tile it), verified, resent and
                # noted, `stale` being what this rank held before the hop
                stale = torch.cat(cur) if hop_faults else None
                cur = [collectives.ring_shift(c, group) for c in cur]
                if hop_faults:
                    arrived = torch.cat(cur)
                    tag = (mi << 12) | h
                    rbuf = faults.corrupt_hop(arrived, stale, key, tag=tag,
                                              start=layout.header_nbytes)
                    if rbuf is not arrived:
                        rbuf = _verify_received(rbuf, arrived, layout,
                                                faults, tag)
                        cur = [rbuf[s:e] for _, s, e in chunks]
                    del arrived, rbuf
                del stale
                for c in range(len(chunks)):
                    decode_chunk(c, src)
            if rec is not None:
                rec.mark([cur[-1], accs[-1]], "hop", label=f"hop{h} m{mi}",
                         **attrs[mi])
        with _scope(rec, f"repro/msg{mi}/collective"):
            _collect(p, bs, dims, accs, mns if with_state else None)
        if rec is not None:
            rec.mark(accs, "collective", **attrs[mi])

    def _collect(p, bs, dims, accs, mns):
        """The mean (ring) or the gathered shards (rs), post, and the
        scatter of each bucket's output and residual."""
        for j, b in enumerate(bs):
            if mode == "ring":
                xm = collectives.rank_sum(accs[j]) / n
            else:
                xm = accs[j].permute(1, 0, 2).reshape(b.n, -1)[:, :b.dim]
            plan._scatter_runs(*out, b, xm if post is None
                               else post(xm, p["kbs"][j]))
            if with_state:
                if mode == "ring":
                    m_new = mns[j]
                else:
                    ds = dims[j]
                    m_new = p["mps"][j].clone()
                    m_new[:, rank * ds:(rank + 1) * ds] = mns[j]
                    m_new = m_new[:, :b.dim]
                plan._scatter_runs(*mout, b, m_new)

    # the depth-2 pipeline: message m + 1's compute leg is issued before
    # message m's collective leg
    pending = None
    for mi, (msg, layout) in enumerate(zip(schedule.messages, layouts)):
        prepared = prepare(mi, msg, layout)
        if pending is not None:
            finish(pending)
        pending = prepared
    if pending is not None:
        finish(pending)
    tree = plan._assemble(*out, False)
    if with_state:
        return tree, plan._assemble(*mout, False), tuple(buffers)
    return tree, tuple(buffers)
