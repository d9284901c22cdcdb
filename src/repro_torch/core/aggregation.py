"""Bidirectional compressed gradient aggregation, the paper's Algorithm 1
(the JAX package's core/aggregation.py):

  worker i:  g_i -> Q_W(g_i) -> send
  master  :  Q_M( (1/n) Σ_i Q_W(g_i) )

`compressed_allreduce` runs it across the ranks of a torch.distributed
process group, each rank holding its own gradient tree; every rank plays
master with the same key, so all ranks return the same result. The
reference's shard_map axis becomes the group: `_worker_key` folds the
rank into each unit key, and every collective is an all_gather followed
by rank-order arithmetic (core/collectives.py). Strategies:

  dense          the plain mean (optionally renormalized over `alive`).
  simulated      Q_W then the dense mean of the decoded units.
  allgather      all_gather the encoded payloads; every rank decodes all
                 n and averages. With wire=True the packed bytes of each
                 bucket cross the collective and the receive leg decodes
                 all n x n_units rows with the per-unit codec, one launch
                 per bucket.
  rs_compress_ag reduce-scatter the dense gradient, compress the owned
                 shard, all_gather the compressed shards.
  shared_random  Random-k with the shared unit key: only the k values move.
  ring           wire-only: the allgather wire path's packed message
                 buffers moved hop by hop around the ranks, each hop's
                 chunks decoded the hop they arrive
                 (wire.execute_schedule_stream); bit-identical to
                 allgather with wire=True.
  rs_stream      wire-only: compress -> reduce-scatter -> allgather, each
                 rank encoding only the shard it owns and the packed shards
                 riding the ring.

With `telemetry_plan` (a control.telemetry measurement plan) both entry
points return a third element, the step's TelemetryState increment
measured on the gradients against the aggregate (control/telemetry.py
`measure`). `compressed_allreduce(recorder=)` (obs.trace.TraceRecorder)
marks the executed pipeline's spans. `faults=` (resil.FaultInjector,
wire=True only) corrupts the bytes each receiver sees (core/wire.py
_receive_buffer, or each arriving ring hop); the caller drains the
verdicts with faults.take_flags(), and aggregate_simulated_workers
appends the step's counters {"messages", "corrupt_detected", "resends"}
as its last return.

`aggregate_simulated_workers` is the paper-repro harness: worker
gradients carry a leading worker axis n on one device. The per-worker
pass is ONE batched execution over all n workers (the reference vmaps
it): worker i's unit keys derive from fold_in(key, i), so for stochastic
compressors it equals compressed_allreduce(strategy='simulated') in
distribution, not bit for bit (as in the reference: there the rank is
folded into each unit key instead). With wire=True every worker's
compressed units travel as real packed message buffers (core/wire.py),
bit-identical to the sim path. The worker mean is summed in worker order,
((w0 + w1) + w2) + ... then divided by n, so it does not depend on a
reduction kernel's order; with `alive` it is the reference's tensordot
with the survivor weights, which XLA's CPU dot computes as a worker-order
fma chain, w0 g0 then fma(w_i, g_i, acc), and so does the port.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.convert import tree_leaves, tree_map
from repro_torch.core.collectives import (all_gather, rank_mean, rank_sum,
                                          reduce_scatter)
from repro_torch.core.compressors import (Compressor, Identity, RandomK,
                                          _f32, _k_of)
from repro_torch.core.granularity import Granularity
from repro_torch.core.plan import UnitPlan, build_plan
from repro_torch.core.schedule import CommSchedule, build_schedule
from repro_torch.core.wire import (execute_schedule_wire,
                                   execute_schedule_wire_with_state,
                                   wire_codec)
from repro_torch.kernels.ref import fma_f32
from repro_torch.random import fold_in

STRATEGIES = ("dense", "simulated", "allgather", "rs_compress_ag",
              "shared_random", "ring", "rs_stream")

#: strategies executed by the streaming ring collective (wire=True only)
STREAM_STRATEGIES = ("ring", "rs_stream")

_MASTER_FOLD = 0x5EED


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    """Static configuration of the compressed-communication stack (the
    reference's fields; see its docstring for each)."""
    qw: Compressor = Identity()
    qm: Compressor = Identity()
    granularity: Granularity = Granularity("layerwise")
    strategy: str = "simulated"
    error_feedback: bool = False
    wire_dtype: str = "float32"
    fusion_bytes: Optional[float] = None
    integrity: bool = False

    def __post_init__(self):
        if self.strategy not in STRATEGIES:
            raise ValueError(f"unknown strategy {self.strategy!r}")
        if self.strategy == "shared_random" and not isinstance(self.qw,
                                                               RandomK):
            raise ValueError("shared_random requires a RandomK worker "
                             "compressor")
        if self.error_feedback and self.strategy not in (
                "simulated", "allgather", "ring", "rs_stream"):
            raise ValueError("error feedback supports simulated/allgather/"
                             "ring/rs_stream only")
        if self.fusion_bytes is not None and not float(self.fusion_bytes) >= 0:
            raise ValueError(
                f"fusion_bytes must be >= 0 or None, got {self.fusion_bytes!r}")


def no_compression() -> CompressionConfig:
    return CompressionConfig(strategy="dense")


def worker_mean(g: torch.Tensor) -> torch.Tensor:
    """Mean over the leading worker axis, summed in worker order (the sum
    of two or more workers divided in place: one buffer, not two)."""
    if g.shape[0] == 1:
        return g[0] / 1
    return rank_sum(g).div_(g.shape[0])


def _survivor_mean(g: torch.Tensor, alive) -> torch.Tensor:
    """The reference's tensordot(alive / sum(alive), g) over the leading
    worker axis, as XLA's CPU dot computes it: w0 * g0, then
    fma(w_i, g_i, acc) in worker order (f32)."""
    w = torch.tensor([float(bool(a)) for a in alive], dtype=torch.float32)
    w = (w / w.sum()).to(g.device)
    g32 = g.to(torch.float32)
    acc = w[0] * g32[0]
    for i in range(1, g32.shape[0]):
        acc = fma_f32(g32[i], w[i], acc)
    return acc.to(g.dtype)


def _master(cfg: CompressionConfig):
    """Q_M on bucket rows with the master key of each unit (identical on
    every rank, so every rank computes the same output)."""
    if type(cfg.qm) is Identity:
        return lambda xm, ukeys: xm
    return lambda xm, ukeys: cfg.qm.sim(xm, fold_in(ukeys, _MASTER_FOLD))


def _wire_codec_for(cfg: CompressionConfig, allgather_available=True):
    """The wire codec of cfg.qw, validated for the strategy (the
    reference's errors): wire=True runs simulated and allgather only, and
    strategy='simulated' refuses a codec whose payload is not bit-exact
    against sim (capacity-bounded records, or the lossy bf16 value cast).
    `allgather_available=False` is the simulated-worker harness, which
    has no allgather wire path to point the caller at."""
    if cfg.strategy not in ("simulated", "allgather") + STREAM_STRATEGIES:
        raise ValueError(
            f"wire=True supports the simulated/allgather/ring/rs_stream "
            f"strategies, not {cfg.strategy!r}")
    codec = wire_codec(cfg.qw, wire_dtype=cfg.wire_dtype,
                       integrity=cfg.integrity)
    if cfg.strategy == "simulated" and not codec.exact_sim:
        hint = ("run it under strategy='allgather', whose collective "
                "carries the real (capacity-bounded / bf16-cast) payload"
                if allgather_available else "drop wire=True")
        raise ValueError(
            f"{cfg.qw.name}: this wire format is not bit-exact against "
            f"sim (capacity-bounded records, or the lossy bfloat16 value "
            f"cast) while strategy='simulated' promises the exact "
            f"operator — {hint}")
    return codec


# ---- across ranks: compressed_allreduce ------------------------------------

def _wire(x: torch.Tensor, cfg: CompressionConfig) -> torch.Tensor:
    """The dense wire dtype of the simulated / rs / shared legs."""
    return x.to(torch.bfloat16) if cfg.wire_dtype == "bfloat16" else x


def _cast_payload(payload: dict, cfg: CompressionConfig) -> dict:
    """bf16 wire for the float legs of the payload records (indices and
    quantized ints untouched)."""
    if cfg.wire_dtype != "bfloat16":
        return payload
    return {k: v.to(torch.bfloat16) if v.is_floating_point() else v
            for k, v in payload.items()}


def _gather_records(payload: dict, group) -> dict:
    """Every rank's (n_units, ...) records -> (n * n_units, ...), in rank
    order."""
    return {k: all_gather(v, group).reshape((-1,) + tuple(v.shape[1:]))
            for k, v in payload.items()}


def _decode_gathered(qw, payload: dict, d: int, cfg, dtype, group):
    """all_gather the rows' records and decode all of them -> (n, n_units,
    d) in rank order."""
    n_units = next(iter(payload.values())).shape[0]
    rec = _gather_records(_cast_payload(payload, cfg), group)
    return qw.decode(rec, d, dtype).reshape(-1, n_units, d)


def _unit_simulated(cfg, group, wkey):
    master = _master(cfg)

    def fn(x, ukeys):
        xw = cfg.qw.sim(x, wkey(ukeys))
        return master(rank_mean(_wire(xw, cfg), group).to(x.dtype), ukeys)
    return fn


def _unit_simulated_ef(cfg, group, wkey):
    master = _master(cfg)

    def fn(x, m, ukeys):
        e = x + m
        xw = cfg.qw.sim(e, wkey(ukeys))
        xm = rank_mean(_wire(xw, cfg), group).to(x.dtype)
        return master(xm, ukeys), e - xw
    return fn


def _unit_allgather(cfg, group, wkey):
    master = _master(cfg)

    def fn(x, ukeys):
        payload = cfg.qw.encode(x, wkey(ukeys))
        dec = _decode_gathered(cfg.qw, payload, x.shape[1], cfg, x.dtype,
                               group)
        return master(worker_mean(dec), ukeys)
    return fn


def _unit_allgather_ef(cfg, group, wkey):
    master = _master(cfg)

    def fn(x, m, ukeys):
        d = x.shape[1]
        e = x + m
        payload = cfg.qw.encode(e, wkey(ukeys))
        m_new = e - cfg.qw.decode(_cast_payload(payload, cfg), d, x.dtype)
        dec = _decode_gathered(cfg.qw, payload, d, cfg, x.dtype, group)
        return master(worker_mean(dec), ukeys), m_new
    return fn


def _unit_rs_compress_ag(cfg, group, wkey, rank: int, n: int):
    master = _master(cfg)

    def fn(x, ukeys):
        d = x.shape[1]
        xp = _wire(F.pad(x, (0, (-d) % n)), cfg)
        ds = xp.shape[1] // n
        # reduce-scatter: this rank owns the rank-order sum of its chunk
        shard = reduce_scatter(xp, group).to(x.dtype) / n
        # positions >= d are padding: pinned to zero before encode, and
        # the decoded tail forced back to zero before the trim
        own = (rank * ds + torch.arange(ds, device=x.device)) < d
        shard = torch.where(own, shard, 0.0)
        dec = _decode_gathered(cfg.qw, cfg.qw.encode(shard, wkey(ukeys)), ds,
                               cfg, x.dtype, group)
        gmask = (torch.arange(n * ds, device=x.device) < d).reshape(n, 1, ds)
        dec = torch.where(gmask, dec, 0.0)
        xm = dec.permute(1, 0, 2).reshape(x.shape[0], n * ds)[:, :d]
        return master(xm, ukeys)
    return fn


def _unit_shared_random(cfg, group):
    qw, master = cfg.qw, _master(cfg)

    def fn(x, ukeys):
        d = x.shape[1]
        idx = qw._indices(d, ukeys.to(x.device))   # the SHARED unit keys
        vals = x.gather(1, idx)
        if qw.scale:
            vals = vals * _f32(d / _k_of(qw.ratio, d), vals)
        vals = rank_mean(_wire(vals, cfg), group).to(x.dtype)
        return master(torch.zeros_like(x).scatter_(1, idx, vals), ukeys)
    return fn


def _wire_post(cfg, group, codec):
    """The post-decode leg of the wire pipeline: the collective + master
    compression of _unit_simulated / _unit_allgather with Q_W replaced by
    the bit-exact payload round trip (simulated) or the packed bytes
    through the collective (allgather). The allgather post also has the
    bucket-list form `post.buckets` (execute_schedule_wire calls it): the
    step's all_gathers in bucket order, then ONE decode_rows_buckets call
    over every gathered bucket, then the worker mean and Q_M per bucket."""
    master = _master(cfg)
    if cfg.strategy == "simulated":
        def post(payload, xhat, ukeys, d):
            xm = rank_mean(_wire(xhat, cfg), group).to(xhat.dtype)
            return master(xm, ukeys)
        return post

    # allgather: the packed uint8 payload rows cross the collective; the
    # gathered rows go once decoded and each bucket's decoded rows once
    # averaged
    def post_buckets(payloads, xhats, ukeys_list, dims, mark=None):
        """`mark(dep, stage)` (a recorder's grouped mark) stamps the
        gathers and the mean as collective, the decode as decode."""
        n = dist.get_world_size(group)
        rows = [all_gather(p, group).reshape(-1, p.shape[-1])
                for p in payloads]
        if mark is not None:
            mark(rows, "collective")
        decs = codec.decode_rows_buckets(rows, dims)
        del rows
        if mark is not None:
            mark(decs, "decode")
        out = []
        for i, (ukeys, d) in enumerate(zip(ukeys_list, dims)):
            dec, decs[i] = decs[i], None
            out.append(master(worker_mean(dec.reshape(n, -1, d)), ukeys))
        if mark is not None:
            mark(out, "collective")
        return out

    def post(payload, xhat, ukeys, d):
        return post_buckets([payload], [xhat], [ukeys], [d])[0]
    post.buckets = post_buckets
    return post


def _executor(plan: UnitPlan, cfg: CompressionConfig,
              schedule: Optional[CommSchedule]):
    """What execution runs through: an explicit CommSchedule, the schedule
    compiled from cfg.fusion_bytes, or the bare plan (all bit-identical)."""
    if schedule is not None:
        return schedule
    if cfg.fusion_bytes is not None:
        return build_schedule(plan, cfg.fusion_bytes)
    return plan


def _faults_need_wire(faults, wire: bool) -> None:
    """The reference's refusal of fault injection off the wire."""
    if faults is not None and not wire:
        raise ValueError("fault injection acts on PACKED wire bytes — "
                         "pass wire=True")


def compressed_allreduce(grads, stacked, cfg: CompressionConfig, group,
                         key: torch.Tensor, n_workers: int, ef_state=None,
                         plan: Optional[UnitPlan] = None,
                         schedule: Optional[CommSchedule] = None,
                         telemetry_plan=None,
                         telemetry_entire_model: bool = True,
                         wire: bool = False, recorder=None,
                         stream_chunk_bytes: Optional[float] = None,
                         faults=None, alive=None):
    """Aggregate this rank's gradient tree with bidirectional compression
    across the ranks of `group` (a torch.distributed process group, None
    for the default one) -> (grads_hat, new_ef_state), identical on every
    rank. `n_workers` must be the group's size; `key` (2,) is the same on
    every rank. `wire=True` materializes Q_W as real packed message
    buffers (per-bucket messages unless cfg.fusion_bytes or `schedule`
    says otherwise); under allgather their bucket regions cross the
    collective. Strategies ring / rs_stream need wire=True and run the
    schedule through the streaming collective
    (CommSchedule.execute_streaming); `stream_chunk_bytes` sets their hop
    granularity (None: whole messages). `alive` (strategy='dense' only)
    renormalizes the mean over the ranks whose flag is set. With
    `telemetry_plan` the result is (grads_hat, new_ef_state,
    telemetry_inc): this rank's gradients measured against the aggregate
    (the caller takes the mean over the group); `telemetry_entire_model`
    False skips the flat counterfactual leg. `recorder` (duck-typed,
    obs.trace.TraceRecorder) threads through to the executor: dispatch or
    message spans, or the wire path's stage spans (the streaming
    collectives' hop spans too); the dense strategy records nothing, as in
    the reference. `faults` (resil.FaultInjector; wire=True only)
    corrupts what this rank receives under the step key: each message's
    bucket regions before the allgather post gathers them (the reference's
    wire.py:1038-1057), or each arriving ring hop; drain its verdicts
    with faults.take_flags()."""
    agg, ef = _allreduce(grads, stacked, cfg, group, key, n_workers,
                         ef_state, plan, schedule, wire, recorder,
                         stream_chunk_bytes, faults, alive)
    if telemetry_plan is None:
        return agg, ef
    from repro_torch.control.telemetry import measure
    return agg, ef, measure(telemetry_plan, cfg.qw, grads, key,
                            grads_hat=agg,
                            entire_model=telemetry_entire_model)


def _allreduce(grads, stacked, cfg, group, key, n_workers, ef_state, plan,
               schedule, wire, recorder, stream_chunk_bytes, faults, alive):
    """compressed_allreduce without the telemetry leg."""
    if cfg.strategy in STREAM_STRATEGIES and not wire:
        raise ValueError(
            f"strategy {cfg.strategy!r} is the streaming collective over "
            f"PACKED wire buffers — pass wire=True (the unpacked payload "
            f"records have no single buffer to ring-permute)")
    _faults_need_wire(faults, wire)
    rank, n = dist.get_rank(group), dist.get_world_size(group)
    if n != n_workers:
        raise ValueError(f"n_workers={n_workers} but the group has {n} ranks")
    if alive is not None and cfg.strategy != "dense":
        raise ValueError(
            "partial participation (alive=...) is implemented for the "
            "dense strategy here; for compressed aggregation use the "
            "simulated-worker harness (aggregate_simulated_workers)")
    if plan is None and schedule is not None:
        plan = schedule.plan

    if cfg.strategy == "dense":
        if wire:
            raise ValueError(
                "wire=True with strategy='dense': the dense allreduce "
                "moves raw tensors — there is no compressed payload to "
                "pack; use strategy='simulated' with an identity "
                "compressor for a packed dense-f32 baseline")
        if alive is None:
            return tree_map(lambda g: rank_mean(_wire(g, cfg), group)
                            .to(g.dtype), grads), ef_state
        me = float(bool(alive[rank]))
        denom = float(sum(1.0 for a in alive if a))
        # the reference's jitted `psum(g) / denom` is a multiply by
        # f32(1 / denom) under XLA
        recip = torch.tensor(1.0, dtype=torch.float32) / denom
        return tree_map(lambda g: (rank_sum(all_gather(
            _wire(g, cfg) * me, group)) * recip).to(g.dtype),
            grads), ef_state

    if not tree_leaves(grads):                       # nothing to aggregate
        return grads, ef_state
    if cfg.error_feedback and ef_state is None:
        raise ValueError("error_feedback=True requires ef_state")
    if plan is None:
        plan = build_plan(grads, stacked, cfg.granularity)
    ex = _executor(plan, cfg, schedule)

    def wkey(ukeys):
        return fold_in(ukeys, rank)

    if wire:
        codec = _wire_codec_for(cfg)
        sched = (ex if isinstance(ex, CommSchedule)
                 else build_schedule(plan, 0.0))
        if cfg.strategy in STREAM_STRATEGIES:
            kw = dict(wire=codec, group=group, n_workers=n,
                      mode="ring" if cfg.strategy == "ring" else "rs",
                      wire_key=wkey, chunk_bytes=stream_chunk_bytes,
                      recorder=recorder, faults=faults)
            if cfg.error_feedback:
                agg, ef, _bufs = sched.execute_streaming_with_state(
                    _master(cfg), grads, ef_state, key, **kw)
                return agg, ef
            agg, _bufs = sched.execute_streaming(_master(cfg), grads, key,
                                                 **kw)
            return agg, ef_state
        post = _wire_post(cfg, group, codec)
        if cfg.error_feedback:
            agg, ef, _bufs = execute_schedule_wire_with_state(
                sched, codec, grads, ef_state, key, post, wkey,
                recorder=recorder, faults=faults)
            return agg, ef
        agg, _bufs = execute_schedule_wire(
            sched, codec, grads, key, post, wkey,
            decode_local=cfg.strategy == "simulated", recorder=recorder,
            faults=faults)
        return agg, ef_state

    if cfg.error_feedback:
        fn = (_unit_simulated_ef if cfg.strategy == "simulated"
              else _unit_allgather_ef)(cfg, group, wkey)
        return ex.execute_with_state(fn, grads, ef_state, key,
                                     recorder=recorder)
    if cfg.strategy == "simulated":
        fn = _unit_simulated(cfg, group, wkey)
    elif cfg.strategy == "allgather":
        fn = _unit_allgather(cfg, group, wkey)
    elif cfg.strategy == "rs_compress_ag":
        fn = _unit_rs_compress_ag(cfg, group, wkey, rank, n)
    else:  # shared_random
        fn = _unit_shared_random(cfg, group)
    return ex.execute(fn, grads, key, recorder=recorder), ef_state


def aggregate_simulated_workers(worker_grads, stacked,
                                cfg: CompressionConfig, key: torch.Tensor,
                                ef_state=None,
                                plan: Optional[UnitPlan] = None,
                                schedule: Optional[CommSchedule] = None,
                                telemetry_plan=None,
                                telemetry_entire_model: bool = True,
                                wire: bool = False, faults=None,
                                alive=None):
    """Single-device realization of Algorithm 1: `worker_grads` leaves
    carry a leading worker axis n. Returns (grads_hat, new_ef_state).
    `plan` (built from the per-worker tree) skips re-deriving the unit
    partition; `schedule` or cfg.fusion_bytes streams the worker pass
    through a CommSchedule (bit-identical), a schedule's plan taking
    precedence over `plan`. `wire=True` materializes each worker's
    compression pass as real bit-packed message buffers (per-bucket
    messages unless a schedule says otherwise); the master Q_M pass stays
    dense. A codec that is not sim-exact raises ValueError under
    wire=True. `alive` (n host-side flags) renormalizes the mean over the
    surviving workers, and a dead worker's EF residual stays at its old
    value (its payload never reached the reduce). With `telemetry_plan`
    the result is (grads_hat, new_ef_state, telemetry_inc), measured on
    the workers' mean gradient against the aggregate. `faults`
    (resil.FaultInjector; wire=True only) corrupts each worker's RECEIVED
    message bytes under its worker key, message index as tag (EF
    residuals stay the sender's); the result then grows a LAST element,
    the step's counters {"messages", "corrupt_detected", "resends"} as
    int32 0-d tensors, summed over workers and messages (the reference's
    aggregation.py:611-619)."""
    _faults_need_wire(faults, wire)
    out, new_ef, flags = _aggregate_workers(worker_grads, stacked, cfg, key,
                                            ef_state, plan, schedule, wire,
                                            alive, faults)
    rets = [out, new_ef]
    if telemetry_plan is not None:
        from repro_torch.control.telemetry import measure
        gbar = tree_map(worker_mean, worker_grads)
        rets.append(measure(telemetry_plan, cfg.qw, gbar, key, grads_hat=out,
                            entire_model=telemetry_entire_model))
    if faults is not None:
        detected = int((~flags).sum())
        resends = detected if getattr(faults, "resend", False) else 0
        rets.append({k: torch.tensor(v, dtype=torch.int32) for k, v in (
            ("messages", flags.numel()), ("corrupt_detected", detected),
            ("resends", resends))})
    return tuple(rets)


def _aggregate_workers(worker_grads, stacked, cfg, key, ef_state, plan,
                       schedule, wire, alive, faults=None):
    """aggregate_simulated_workers without the telemetry leg -> (grads_hat,
    new_ef_state, flags): the injector's (n, n_messages) verdicts, or an
    empty bool tensor."""
    n = tree_leaves(worker_grads)[0].shape[0]
    if plan is None and schedule is not None:
        plan = schedule.plan
    if plan is None:
        per_worker = tree_map(lambda x: torch.empty(
            x.shape[1:], dtype=x.dtype, device="meta"), worker_grads)
        plan = build_plan(per_worker, stacked, cfg.granularity)
    ex = _executor(plan, cfg, schedule)
    wkeys = fold_in(key[None], torch.arange(n))        # (n, 2) worker keys
    if wire:
        codec = _wire_codec_for(
            cfg if cfg.strategy == "simulated"
            else dataclasses.replace(cfg, strategy="simulated"),
            allgather_available=False)
        sched = (ex if isinstance(ex, CommSchedule)
                 else build_schedule(plan, 0.0))

    if cfg.error_feedback:
        if ef_state is None:
            raise ValueError("error_feedback=True requires ef_state")
        if wire:
            compressed, new_ef, _bufs = execute_schedule_wire_with_state(
                sched, codec, worker_grads, ef_state, wkeys, faults=faults)
        else:
            def fn_ef(x, m, ukeys):
                e = x + m
                q = cfg.qw.sim(e, ukeys)
                return q, e - q
            compressed, new_ef = ex.execute_with_state(fn_ef, worker_grads,
                                                       ef_state, wkeys)
        if alive is not None:
            amask = torch.tensor([bool(a) for a in alive])
            new_ef = tree_map(lambda nm, om: torch.where(
                amask.to(nm.device).reshape((n,) + (1,) * (nm.dim() - 1)),
                nm, om), new_ef, ef_state)
    else:
        if wire:
            compressed, _bufs = execute_schedule_wire(
                sched, codec, worker_grads, wkeys, faults=faults)
        else:
            compressed = ex.execute(cfg.qw.sim, worker_grads, wkeys)
        new_ef = ef_state

    flags = (faults.take_flags() if faults is not None
             else torch.zeros((0,), dtype=torch.bool))
    if alive is None:
        mean = tree_map(worker_mean, compressed)
    else:
        mean = tree_map(lambda g: _survivor_mean(g, alive), compressed)
    if type(cfg.qm) is Identity:
        # Q_M = identity: the master pass returns its input bit for bit,
        # so skip its dispatches (and the per-unit master-key folds)
        return mean, new_ef, flags
    return ex.execute(_master(cfg), mean, key), new_ef, flags
