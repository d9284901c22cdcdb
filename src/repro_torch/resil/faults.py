"""Data-plane fault injection for packed wire buffers (the JAX package's
resil/faults.py).

A FaultInjector perturbs the uint8 bytes a receiver SEES, after encode
and pack and before decode, where a real fabric corrupts them. The
sender-side buffer (the measured wire truth, EF residuals) always stays
clean; see core.wire._receive_buffer.

Draws are pure functions of (key, spec.seed, message / hop tag) through
the reference's key chain, fold_in(key, 0xFA17), then the seed masked to
31 bits, then the tag, and its split / randint / bernoulli draws
(repro_torch.random, jax's bits), so the corrupted bytes are the
reference's bit for bit and a faulted run replays exactly. The simulated
wire path is batched over workers: `corrupt` takes a (B, nbytes) batch
of buffers with (B, 2) keys (one row a worker, as the reference's vmap
sees them) or one (nbytes,) buffer with a (2,) key. Draws are made on the
host and only the touched bytes are written on the buffers' device.

The injector is duck-typed against sim.scenario.CorruptionSpec (fields
prob / mode / n_bits / seed), so this module never imports repro_torch.sim.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.random import (_scalar_uniform, _split_rows, fold_in,
                                randint)

#: modes acting on any received message (serialized or ring)
BYTE_MODES = ("bitflip", "truncate")
#: modes only meaningful for a ring hop (need the ring's topology)
HOP_MODES = ("drop_hop", "dup_hop")
CORRUPTION_MODES = BYTE_MODES + HOP_MODES


class FaultInjector:
    """Per-step injector: corrupt buffers, collect the integrity verdicts
    the executors note, and hand them back stacked via `take_flags()`.

    `resend=True` models re-encode-and-resend: a message whose checksum
    fails is replaced by the sender's clean copy, so the decoded values
    match the clean run bitwise while the verdict stream still records
    the detection.
    """

    def __init__(self, spec, *, resend: bool = False):
        if spec.mode not in CORRUPTION_MODES:
            raise ValueError(f"unknown corruption mode {spec.mode!r}; "
                             f"expected one of {CORRUPTION_MODES}")
        self.spec = spec
        self.resend = bool(resend)
        self._events = []

    def touches(self, hop: bool = False) -> bool:
        """Whether corrupt (hop=False) or corrupt_hop (hop=True) can
        change a buffer; False means it returns its input itself."""
        if float(self.spec.prob) <= 0.0:
            return False
        return hop or self.spec.mode not in HOP_MODES

    # ---- seeded draws ----------------------------------------------------
    def _keys(self, key: torch.Tensor, tag: int) -> torch.Tensor:
        """(B, 2) per-row draw keys of (B, 2) step keys."""
        k = fold_in(key.cpu(), 0xFA17)
        k = fold_in(k, int(self.spec.seed) & 0x7FFFFFFF)
        return fold_in(k, int(tag))

    def _hits(self, k: torch.Tensor) -> np.ndarray:
        """bernoulli(k, prob) per row: uniform(k, ()) < f32(prob)."""
        return (_scalar_uniform(k) < float(np.float32(self.spec.prob))
                ).numpy()

    def _dirty(self, buf: torch.Tensor, kd: torch.Tensor, hit, start: int
               ) -> torch.Tensor:
        """`buf` with the byte mode applied to the hit rows (a copy)."""
        out = buf.clone()
        size = buf.shape[1]
        for b in np.nonzero(hit)[0].tolist():
            if self.spec.mode == "bitflip":
                nb = int(self.spec.n_bits)
                k1, k2 = _split_rows(kd[b:b + 1], 2)[0]
                pos = randint(k1, (nb,), start, size).tolist()
                bit = randint(k2, (nb,), 0, 8).tolist()
                orig = buf[b, pos].cpu().tolist()
                # in draw order from the unflipped bytes, the last write
                # to a repeated position winning (the reference's scatter)
                for p, o, s in zip(pos, orig, bit):
                    out[b, p] = o ^ (1 << s)
            else:
                cut = int(randint(kd[b], (), start, size))
                out[b, cut:] = 0
        return out

    # ---- executor hooks --------------------------------------------------
    def corrupt(self, buf: torch.Tensor, key: torch.Tensor, *, tag: int,
                start: int = 0) -> torch.Tensor:
        """Maybe-corrupt received message buffers: (B, nbytes) uint8 with
        (B, 2) keys, or (nbytes,) with a (2,) key. `start` floors the
        perturbed span (the header words before the checksummed region
        stay intact). Returns `buf` ITSELF when this injector cannot
        touch it (prob 0 or a hop-only mode): the executors' fast path."""
        if not self.touches():
            return buf
        one = buf.dim() == 1
        b2, k2 = (buf[None], key.reshape(1, 2)) if one else (buf, key)
        ks = _split_rows(self._keys(k2, tag), 2)
        out = self._dirty(b2, ks[:, 1], self._hits(ks[:, 0]), start)
        return out[0] if one else out

    def corrupt_hop(self, arrived: torch.Tensor, stale: torch.Tensor,
                    key: torch.Tensor, *, tag: int, start: int = 0
                    ) -> torch.Tensor:
        """Maybe-corrupt one ARRIVING ring hop (nbytes,) under the step
        key (2,). `stale` is the content this rank held before the hop
        (what a duplicated hop re-delivers). drop_hop zeroes the message,
        detected because the init=1 Fletcher-32 of zeros is nonzero;
        dup_hop delivers `stale`, a VALID stale message whose checksum
        passes (catching it needs sequence numbers)."""
        if float(self.spec.prob) <= 0.0:
            return arrived
        if self.spec.mode in BYTE_MODES:
            return self.corrupt(arrived, key, tag=tag, start=start)
        hit = bool(self._hits(self._keys(key.reshape(1, 2), tag))[0])
        if not hit:
            return arrived.clone()
        return (torch.zeros_like(arrived) if self.spec.mode == "drop_hop"
                else stale.clone())

    # ---- verdict stream --------------------------------------------------
    def note(self, tag: int, ok: torch.Tensor) -> None:
        """Record one message's integrity verdict (True = passed): a (B,)
        bool tensor on the batched path, a 0-d one on a rank."""
        self._events.append(ok)

    def take_flags(self) -> torch.Tensor:
        """Drain the verdict stream -> bool (B, n_noted) on the batched
        path (worker, then message, the reference's vmap order), or
        (n_noted,) on a rank; zero-length when nothing was noted."""
        ev, self._events = self._events, []
        if not ev:
            return torch.zeros((0,), dtype=torch.bool)
        return torch.stack(ev, dim=-1)
