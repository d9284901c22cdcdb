"""The distributed execution engine (the JAX package's launch/engine.py):
train, prefill and serve steps on a (data, model) or (pod, data, model)
mesh with the paper's compressed gradient aggregation wired in, one rank
process per device of the reference's mesh (rank = d * model + m; (p *
data + d) * model + m on a pod mesh).

train step (on every rank, with this rank's parameter shards):
  1. forward / backward on this data rank's rows of the global batch
     (`train_microbatch` microbatches accumulated in the param dtype), the
     TP and SP collectives inside; FSDP leaves (cfg.use_fsdp) aggregate
     their gradients in the backward hook with Q_W
  2. the paper's Algorithm 1 on the other gradient leaves: Q_W on this
     rank -> the collective over the dp group -> Q_M
     (compressed_allreduce through the engine's cached UnitPlan of the
     SHARD shapes; wire=True packs real message buffers,
     collective='ring' streams them around the ring)
  3. Q_M layer-wise on the FSDP leaves (one key on every rank)
  4. the optimizer update, its state sharded like the params

The engine's DistConfig is the reference's: tp="model", fsdp="data" when
cfg.use_fsdp, dp=("data",) or on a pod mesh ("pod", "data"), sp=True.
The dp group is the data axis' group, or the mesh's flattened (pod, data)
group in pod-major order; dp rank r of n (r = p * data + d) takes rows
[r B / n, (r + 1) B / n) of the global batch, as the reference's data
sharding does, and the step key is fold_in(key(42), step), the
reference's. FSDP stays on "data" (dp[-1]): its hook reduce-scatters over
the data group and sums over the pod group. The loss is averaged over the
dp group in rank order (the reference's pmean); step_guard's finite flag
is reduced by MIN over the model group, then the dp group, so every rank
takes the same branch. Torch has no buffer donation: the step returns new
trees.

With telemetry=True the step also threads a control.TelemetryState: each
rank measures its own gradients against the aggregate, and the increments
are averaged over the dp group in rank order (the reference's pmean)
before they accumulate, so every rank holds the same state.

`init_state` gives each rank its shards (`shard_tree`); `global_tree`
gathers a sharded state back to the reference's global arrays (the
checkpoint file's content).

`build_train_step(tracer=, metrics=)` instruments the step (the
reference's engine.py:323-475): the tracer (obs.trace.TraceRecorder)
marks the aggregation pipeline's spans each step (the caller finalizes
it after the step), and the registry (obs.metrics.MetricsRegistry)
counts the build and gets the plan's and schedule's static gauges.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from repro_torch import random as R
from repro_torch import resolve_device
from repro_torch.convert import (map_tree, tree_leaves, tree_map, tree_paths,
                                 tree_unflatten)
from repro_torch.core.aggregation import (CompressionConfig,
                                          compressed_allreduce)
from repro_torch.core import collectives as C
from repro_torch.core.plan import build_plan
from repro_torch.core.collectives import all_gather as _gather_ranks
from repro_torch.launch.mesh import POD_DP, Mesh, axis_sizes
from repro_torch.models.config import InputShape, ModelConfig
from repro_torch.models.dist import DistConfig
from repro_torch.models.model import Model
from repro_torch.models.params import shard, torch_dtype, unshard
from repro_torch.optim import OptConfig, apply_updates, init_opt_state

# batch entries whose first dim is the batch
_BATCH_ROWS = ("tokens", "targets", "patch_embeds", "frames", "token")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _group_mean_tree(tree, group):
    """The mean over the dp group of every tensor of a tuple of f32
    tensors, summed in rank order then divided by n (the reference's
    pmean): one all_gather of the concatenated fields."""
    n = dist.get_world_size(group)
    if n == 1:
        return tree
    got = C.gather_metrics(torch.cat([t.reshape(-1) for t in tree]), group)
    mean = got[0]
    for i in range(1, n):
        mean = mean + got[i]
    mean = mean / n
    out, off = [], 0
    for t in tree:
        out.append(mean[off:off + t.numel()].reshape(t.shape))
        off += t.numel()
    return type(tree)(*out)


def _partition(tree, mask):
    """(the leaves where mask is True, the others), as two pruned trees in
    the tree's order (the reference's None placeholders, which jax
    flattens away)."""
    t, f = {}, {}
    for k in tree:
        if isinstance(tree[k], dict):
            a, b = _partition(tree[k], mask[k])
            if a:
                t[k] = a
            if b:
                f[k] = b
        elif mask[k]:
            t[k] = tree[k]
        else:
            f[k] = tree[k]
    return t, f


def _merge(a, b):
    """The union of two pruned trees."""
    out = dict(a)
    for k, v in b.items():
        out[k] = _merge(out[k], v) if k in out else v
    return out


def _cache_leaves(tree):
    """Leaves of a cache tree (dicts, tuples and None)."""
    out = []
    map_tree(lambda t: out.append(t), tree)
    return out


class Engine:
    def __init__(self, cfg: ModelConfig, mesh: Mesh, *,
                 comp: Optional[CompressionConfig] = None,
                 opt: Optional[OptConfig] = None,
                 remat: bool = True, device="cuda"):
        self.cfg = cfg
        self.mesh = mesh
        self.sizes = axis_sizes(mesh)
        dp = POD_DP if "pod" in self.sizes else ("data",)
        self.dist = DistConfig(tp="model",
                               fsdp="data" if cfg.use_fsdp else None,
                               dp=dp, sp=True)
        self.model = Model(cfg, self.dist, self.sizes)
        self.comp = comp
        self.opt = opt or OptConfig()
        self.remat = remat
        self.device = resolve_device(device)
        self.dp_size = mesh.axis_size(dp)
        self.tp_size = self.sizes.get("model", 1)
        self.group = mesh.group(dp)          # the dp group (flattened)
        self.model_group = mesh.group("model")
        self._plans: Dict[Any, tuple] = {}

    def bind(self) -> None:
        """Bind the mesh's axes for the model code (every step does)."""
        self.mesh.bind()

    # ---- shards -------------------------------------------------------------
    def _index(self) -> Dict[str, int]:
        return {a: self.mesh.axis_index(a) for a in self.mesh.axis_names}

    def opt_pspecs(self) -> Dict:
        """The optimizer state's partition: moments like the params."""
        pp = self.model.param_pspecs()
        if self.opt.name == "sgd":
            return {}
        if self.opt.name == "momentum":
            return {"m": pp}
        return {"m": pp, "v": pp, "count": ()}

    def state_pspecs(self) -> Dict:
        return {"params": self.model.param_pspecs(),
                "opt": self.opt_pspecs()}

    def shard_tree(self, tree, pspecs):
        """This rank's blocks of a global tree under `pspecs` (a tree of
        partitions; () for a scalar), on the engine's device."""
        index = self._index()
        return tree_map(lambda t, sp: shard(t, sp, self.sizes, index)
                        .to(self.device), tree, pspecs)

    def global_tree(self, tree, pspecs):
        """The global arrays of a sharded tree, on every rank (collective:
        every rank calls it): each sharded dim gathered over its axis."""
        groups = {"data": self.mesh.group("data"), "model": self.model_group}

        def gather(t, axis):
            return _gather_ranks(t, groups[axis])
        return tree_map(lambda t, sp: unshard(t, sp, self.sizes, gather),
                        tree, pspecs)

    def global_like(self) -> Dict:
        """Meta tensors of the global {"params", "opt"} state (a
        checkpoint's structure, shapes and dtypes)."""
        params = self.model.param_shapes()
        return {"params": params, "opt": init_opt_state(self.opt, params)}

    def local_shapes(self) -> Dict:
        """Meta tensors of this rank's parameter shards (the gradient
        shapes the train step sees; the reference's _local_param_sds)."""
        def local(t, sp):
            shape = list(t.shape)
            for i, ax in enumerate(sp):
                if ax is not None:
                    shape[i] //= self.sizes.get(ax, 1)
            return torch.empty(shape, dtype=t.dtype, device="meta")
        return tree_map(local, self.model.param_shapes(),
                        self.model.param_pspecs())

    # ---- input shapes (meta tensors, no storage) ---------------------------
    def batch_shapes(self, shape: InputShape) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len
        if shape.kind == "decode":
            return {"token": _meta((B,), torch.int32),
                    "pos": _meta((), torch.int32)}
        out = {"tokens": _meta((B, S), torch.int32)}
        if shape.kind == "train":
            out["targets"] = _meta((B, S), torch.int32)
        dt = torch_dtype(cfg.dtype)
        if cfg.arch_type == "vlm":
            out["patch_embeds"] = _meta((B, cfg.frontend_seq, cfg.d_model),
                                        dt)
        if cfg.arch_type == "audio":
            out["frames"] = _meta((B, cfg.frontend_seq, cfg.d_model), dt)
        return out

    def _dpp(self, shape: InputShape):
        """The batch dim's axis: "data" (("pod", "data") on a pod mesh), or
        None (every rank takes the whole batch) when the global batch does
        not divide the dp ranks."""
        if shape.global_batch % self.dp_size != 0:
            return None
        dp = tuple(self.dist.dp)
        return dp if len(dp) > 1 else dp[0]

    def batch_pspecs(self, shape: InputShape) -> Dict[str, tuple]:
        """Each entry's partition, one mesh axis or None per dim (the
        reference's PartitionSpecs as tuples)."""
        dpp = self._dpp(shape)
        return {k: (() if k == "pos" else (dpp,) + (None,) * (v.dim() - 1))
                for k, v in self.batch_shapes(shape).items()}

    def _rank(self) -> int:
        """This rank's index along the dp axes (p * data + d on a pod
        mesh)."""
        return self.mesh.axis_index(tuple(self.dist.dp)) \
            if self.dp_size > 1 else 0

    def local_batch(self, batch: Dict[str, torch.Tensor],
                    sharded: bool = True) -> Dict[str, torch.Tensor]:
        """This rank's rows [r B / n, (r + 1) B / n) of every batch entry
        of a global batch (the whole batch when `sharded` is False)."""
        if not sharded or self.dp_size == 1:
            return dict(batch)
        r, n = self._rank(), self.dp_size
        out = {}
        for k, v in batch.items():
            if k in _BATCH_ROWS:
                if v.shape[0] % n:
                    raise ValueError(f"batch entry {k!r} has {v.shape[0]} "
                                     f"rows, not a multiple of {n} ranks")
                per = v.shape[0] // n
                v = v[r * per:(r + 1) * per]
            out[k] = v
        return out

    # ---- plans ------------------------------------------------------------
    def measurement_plan(self):
        """The layer-wise UnitPlan telemetry is measured over (the whole
        gradient tree, independent of the active execution granularity,
        so a controller's TelemetryState keeps its shape across
        decisions). Cached: the same object the step uses."""
        if "measure" not in self._plans:
            from repro_torch.control.telemetry import measurement_plan
            self._plans["measure"] = measurement_plan(
                self.local_shapes(), self.model.stacked())
        return self._plans["measure"]

    def comm_plans(self, comp: Optional[CompressionConfig] = None):
        """(rest_plan, fsdp_plan): the static UnitPlans the train step
        compresses through, built from this rank's SHARD shapes (the
        params with the tp / fsdp partition applied) and cached on the
        engine, so the step and every caller before it (the CLI's summary,
        comm_report, comm_sched) share one plan object. fsdp_plan is None
        when no leaf is aggregated in the FSDP hook or Q_M is the identity
        (no master pass runs on those leaves)."""
        comp = comp or self.comp or CompressionConfig(strategy="dense")
        key = (comp.granularity, comp.qm.name)
        if key not in self._plans:
            fsdp_mask = self.model.fsdp_mask()
            g_fsdp, g_rest = _partition(self.local_shapes(), fsdp_mask)
            s_fsdp, s_rest = _partition(self.model.stacked(), fsdp_mask)
            rest = (build_plan(g_rest, s_rest, comp.granularity)
                    if tree_leaves(g_rest) else None)
            master = comp.qm is not None and comp.qm.name != "identity"
            fsdp = (build_plan(g_fsdp, s_fsdp, comp.granularity)
                    if master and tree_leaves(g_fsdp) else None)
            self._plans[key] = (rest, fsdp)
        return self._plans[key]

    def _aggregate_grads(self, grads, key: torch.Tensor,
                         comp: Optional[CompressionConfig] = None,
                         schedule=None, wire: bool = False, recorder=None):
        """Algorithm 1 over the dp group on the leaves outside the FSDP
        hook, through the engine's cached plan; `schedule` (a CommSchedule
        of that plan) or comp.fusion_bytes streams it through the
        backward-ordered message schedule (bit-identical numerics);
        wire=True packs real message buffers. The FSDP leaves arrive
        compressed, scattered and averaged by the hook; Q_M runs on them
        layer-wise with fold_in(key, 0x5EED), the same on every rank.
        `recorder` (duck-typed, obs.trace.TraceRecorder) marks the
        compressed aggregation's spans."""
        comp = comp if comp is not None else self.comp
        fsdp_mask = self.model.fsdp_mask()
        g_fsdp, g_rest = _partition(grads, fsdp_mask)
        _, s_rest = _partition(self.model.stacked(), fsdp_mask)
        if comp is None or comp.strategy == "dense":
            agg, _ = compressed_allreduce(
                g_rest, s_rest, comp or CompressionConfig(strategy="dense"),
                self.group, key, self.dp_size, wire=wire)
            return _merge(g_fsdp, agg)
        rest_plan, fsdp_plan = self.comm_plans(comp)
        agg, _ = compressed_allreduce(g_rest, s_rest, comp, self.group, key,
                                      self.dp_size, plan=rest_plan,
                                      schedule=schedule, wire=wire,
                                      recorder=recorder)
        if fsdp_plan is not None:
            g_fsdp = fsdp_plan.execute(comp.qm.sim, g_fsdp,
                                       R.fold_in(key, 0x5EED))
        return _merge(g_fsdp, agg)

    # ---- train step ---------------------------------------------------------
    def build_train_step(self, lr_schedule=None, *,
                         comp: Optional[CompressionConfig] = None,
                         telemetry: bool = False,
                         telemetry_entire_model: bool = True,
                         schedule=None, wire: bool = False,
                         collective: Optional[str] = None,
                         tracer=None, metrics=None,
                         step_guard: bool = False) -> "TrainStep":
        """The train step: step(params, opt_state, global_batch, step) ->
        (params, opt_state, metrics), metrics {"loss", "lr"} (f32 0-d
        tensors, equal on every rank) and with step_guard "skipped" (1.0
        where the update was dropped).

        `comp` overrides the engine's CompressionConfig for this step.
        `schedule`: a fusion-bytes number (compiled against the engine's
        cached plan; 0 per-bucket messages, math.inf one message) or a
        CommSchedule of that plan. `wire=True` aggregates through real
        bit-packed message buffers (bit-identical numerics). `collective`
        'allgather' or 'ring' picks the wire collective's topology (needs
        wire=True and a compression config). `step_guard=True` drops the
        update (params and optimizer state keep their values) when the
        loss or any aggregated gradient is non-finite on any rank.

        With `telemetry=True` the step takes and returns a
        control.TelemetryState: (params, opt, batch, step, telem) ->
        (params, opt, metrics, telem'), where telem' accumulates this
        step's measurement (this rank's gradients against the aggregate,
        under the step key) averaged over the dp group: absolute second
        moments are per-rank averages, and the ratio statistics every
        policy reads are exact. `telemetry_entire_model=False` drops the
        flat counterfactual compression pass (only GranularitySwitchPolicy
        reads it).

        The engine threads no error-feedback state (nor does the
        reference's): a config with error_feedback raises the reference's
        ValueError here, where the reference raises it at its first step.

        `tracer` (duck-typed, obs.trace.TraceRecorder) marks the gradient
        aggregation's per-message and per-stage spans every step (call
        tracer.finalize_step after the step; on the card its marks are
        CUDA events and finalize synchronizes once). `metrics`
        (obs.metrics.MetricsRegistry) gets `engine/step_builds` and the
        static gauges `engine/n_dispatches`, `n_units`, `n_messages`,
        `fusion_bytes` and `wire_bits_per_step` at build time. Both None
        (or disabled) leave the step's ops untouched.
        """
        comp_eff = comp if comp is not None else self.comp
        if collective is not None:
            if collective not in ("allgather", "ring"):
                raise ValueError(
                    f"collective must be None, 'allgather' or 'ring'; "
                    f"got {collective!r}")
            if not wire or comp_eff is None or comp_eff.strategy == "dense":
                raise ValueError(
                    "collective= picks the wire collective's topology: it "
                    "requires wire=True and a compression config")
            comp_eff = dataclasses.replace(comp_eff, strategy=collective)
        if comp_eff is not None and comp_eff.strategy != "dense" \
                and comp_eff.error_feedback:
            raise ValueError("error_feedback=True requires ef_state")
        if schedule is not None:
            from repro_torch.launch.comm_sched import resolve_schedule
            rest_plan, _ = self.comm_plans(comp_eff)
            schedule = resolve_schedule(rest_plan, schedule)
        if lr_schedule is None:
            lr = torch.tensor(self.opt.lr, dtype=torch.float32)
            lr_schedule = (lambda s: lr)
        if metrics is not None and getattr(metrics, "enabled", False):
            self._build_gauges(metrics, comp_eff, schedule)
        return TrainStep(self, lr_schedule, comp_eff, schedule, wire,
                         step_guard, telemetry, telemetry_entire_model,
                         tracer)

    def _build_gauges(self, metrics, comp, schedule) -> None:
        """The reference's engine.py:450-475: a build counter and the
        static plan / schedule gauges of the step being built."""
        metrics.inc("engine/step_builds")
        rest_plan, _ = self.comm_plans(comp)
        if rest_plan is None:
            return
        metrics.gauge("engine/n_dispatches", rest_plan.num_dispatches)
        metrics.gauge("engine/n_units", rest_plan.num_units)
        # an explicit schedule wins; else the config's fusion_bytes
        if schedule is None and comp is not None and \
                comp.fusion_bytes is not None:
            from repro_torch.core.schedule import build_schedule
            schedule = build_schedule(rest_plan, comp.fusion_bytes)
        if schedule is not None:
            metrics.gauge("engine/n_messages", schedule.num_messages)
            metrics.gauge("engine/fusion_bytes",
                          min(schedule.fusion_bytes, 2.0 ** 63))
        if comp is not None and comp.strategy != "dense":
            from repro_torch.control.telemetry import payload_bits_per_step
            metrics.gauge("engine/wire_bits_per_step",
                          payload_bits_per_step(rest_plan, comp.qw))

    # ---- inference steps ----------------------------------------------------
    def build_prefill(self, shape: InputShape, cache_len: int = None):
        """The prefill step on this rank: fn(params, global_batch) -> (this
        data rank's rows' last logits over this rank's vocab shard, this
        rank's cache shard: `cache_pspecs`, the slots over the model axis).
        `cache_len` sizes the cache beyond the prompt (the serve loop's
        generation slots). A global batch that does not divide the data
        ranks runs whole on every rank. `gather_logits` assembles the
        vocab."""
        model, sharded = self.model, self._dpp(shape) is not None

        def step_fn(params, batch):
            self.bind()
            return model.prefill(params, self.local_batch(batch, sharded),
                                 R.key(0), remat=self.remat,
                                 cache_len=cache_len)
        return step_fn

    def build_serve_step(self, shape: InputShape):
        """One decode step on this rank: fn(params, {"token": (B,), "pos"},
        cache) -> (this rank's logits, its cache, written in place)."""
        model, sharded = self.model, self._dpp(shape) is not None

        def step_fn(params, batch, cache):
            self.bind()
            b = self.local_batch(batch, sharded)
            return model.decode_step(params, b["token"], batch["pos"], cache)
        return step_fn

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """This data rank's rows -> the global batch's rows, on every rank
        of the dp group (a decode loop's next tokens)."""
        if self.dp_size == 1:
            return x
        g = _gather_ranks(x.contiguous(), self.group)
        return torch.cat(list(g.unbind(0)), dim=0)

    def gather_logits(self, logits: torch.Tensor) -> torch.Tensor:
        """(B_local, V_local) logits of this rank's vocab shard -> the
        (B_local, V) logits over the whole (padded) vocab, on every rank of
        the model group."""
        if self.tp_size == 1:
            return logits
        g = _gather_ranks(logits.contiguous(), self.model_group)
        return torch.cat(list(g.unbind(0)), dim=-1)

    # ---- memory -------------------------------------------------------------
    def memory_estimate(self, shape: InputShape) -> Dict[str, float]:
        """The reference's analytic per-device estimate, term for term
        (its TPU-target terms: params, optimizer state, gradients, the
        saved residual stack, per-layer transients, one loss chunk, KV
        cache), in bytes."""
        cfg = self.cfg
        bt = 2 if cfg.dtype == "bfloat16" else 4
        tp = self.sizes.get("model", 1)
        dpn = self.dp_size
        chips = tp * dpn
        n_params = cfg.param_count()
        shard = tp * (dpn if cfg.use_fsdp else 1)
        params = n_params * bt / shard
        opt_mult = {"sgd": 0, "momentum": 1, "adam": 2}[self.opt.name]
        opt = n_params * 4 * opt_mult / shard
        B_l = max(1, shape.global_batch // dpn)
        d = cfg.d_model
        est = {"params": params, "opt_state": opt}
        if shape.kind == "train":
            est["grads"] = params
            mb = max(1, cfg.train_microbatch)
            B_mb = max(1, B_l // mb)
            S_l = shape.seq_len // tp
            est["residual_stack"] = cfg.n_layers * B_mb * S_l * d * bt
            layer_params = (n_params - 2 * cfg.vocab * d) / max(1,
                                                                cfg.n_layers)
            gathered_w = (layer_params * bt / tp) if cfg.use_fsdp else 0
            est["layer_transients"] = (gathered_w
                                       + 4 * B_mb * shape.seq_len * d * bt)
            est["loss_chunk"] = 8192 * (self.model.vocab_padded // tp) * 4 * 2
        elif shape.kind == "prefill":
            est["activations"] = 4 * B_l * shape.seq_len * d * bt
            cache = self.model.cache_shapes(shape.seq_len, shape.global_batch)
            est["cache"] = sum(x.numel() * x.element_size() / chips
                               for x in _cache_leaves(cache))
            if cfg.use_fsdp:
                est["layer_transients"] = ((n_params - 2 * cfg.vocab * d)
                                           / max(1, cfg.n_layers) * bt / tp)
        else:
            cache = self.model.cache_shapes(shape.seq_len, shape.global_batch)
            est["cache"] = sum(x.numel() * x.element_size() / chips
                               for x in _cache_leaves(cache))
            est["activations"] = 8 * B_l * d * 4
        est["total"] = sum(est.values())
        est["fits_16g"] = est["total"] <= 16e9
        return est

    def init_state(self, seed: int = 0):
        """This rank's shards of Model.init(key(seed)) and the optimizer's
        zero state on the engine's device. The draws are made on the CPU,
        so every rank cuts its shards from the same global params (not the
        reference's draws: tests convert the reference's init_state); at
        full width draw on the device with `self.model.init(key,
        device=...)` and `shard_tree` instead."""
        params = self.shard_tree(self.model.init(R.key(seed), device="cpu"),
                                 self.model.param_pspecs())
        return params, init_opt_state(self.opt, params)


class TrainStep:
    """Engine.build_train_step's step. Calling it runs `grads`, then
    `aggregate`, then `update`; the three stages are public so a caller
    can time them apart."""

    def __init__(self, engine: Engine, lr_schedule, comp, schedule,
                 wire: bool, step_guard: bool, telemetry: bool = False,
                 telemetry_entire_model: bool = True, tracer=None):
        self.engine = engine
        self.tracer = tracer
        self.lr_schedule = lr_schedule
        self.comp = comp
        self.schedule = schedule
        self.wire = wire
        self.step_guard = step_guard
        self.telemetry = telemetry
        self.telemetry_entire_model = telemetry_entire_model

    @staticmethod
    def key(step) -> torch.Tensor:
        return R.fold_in(R.key(42), int(step))

    def grads(self, params, batch, step):
        """(this rank's f32 loss, its gradient tree in the param dtype) on
        its data rank's rows of the global batch; with cfg.train_microbatch
        > 1 the rows split into microbatches whose gradients add up in the
        param dtype and then scale by 1 / mb, as the reference's scan (the
        FSDP hook compresses and scatters per microbatch). The FSDP
        leaves' gradients come out of the hook aggregated."""
        eng = self.engine
        eng.bind()
        model, key = eng.model, self.key(step)
        b = eng.local_batch(batch)
        paths, leaves = tree_paths(params), tree_leaves(params)
        hook = self.comp if eng.dist.fsdp is not None else None

        def value_and_grad(bi):
            p = [l.detach().requires_grad_(True) for l in leaves]
            loss = model.loss(tree_unflatten(paths, p), bi, key, comp=hook,
                              remat=eng.remat)
            return loss.detach(), torch.autograd.grad(loss, p)

        rows = b["tokens"].shape[0]
        mb = min(max(1, eng.cfg.train_microbatch), rows)
        if mb == 1:
            loss, g = value_and_grad(b)
            return loss, tree_unflatten(paths, list(g))
        if rows % mb:
            # the reference's reshape to (mb, rows // mb) fails here too
            raise ValueError(f"train_microbatch={mb}: {rows} rows a rank do "
                             f"not split into {mb} equal microbatches")
        per = rows // mb
        acc = [torch.zeros_like(l) for l in leaves]
        lsum = torch.zeros((), dtype=torch.float32, device=eng.device)
        for i in range(mb):
            li, gi = value_and_grad({k: v[i * per:(i + 1) * per]
                                     for k, v in b.items()})
            acc = [a + g for a, g in zip(acc, gi)]
            lsum = lsum + li
        inv = 1.0 / mb
        grads = [g * torch.tensor(inv, dtype=g.dtype, device=g.device)
                 for g in acc]
        return lsum * inv, tree_unflatten(paths, grads)

    def aggregate(self, grads, step):
        """The gradient tree aggregated over the dp group."""
        self.engine.bind()
        return self.engine._aggregate_grads(grads, self.key(step), self.comp,
                                            schedule=self.schedule,
                                            wire=self.wire,
                                            recorder=self.tracer)

    def update(self, params, opt_state, loss, agg, step):
        """The optimizer update (dropped on every rank when step_guard
        sees a non-finite loss or aggregated gradient on any of them) ->
        (params, opt_state, metrics)."""
        eng = self.engine
        lr = self.lr_schedule(int(step))
        finite = True
        if self.step_guard:
            ok = torch.isfinite(loss)
            for leaf in tree_leaves(agg):
                ok = ok & torch.isfinite(leaf).all()
            ok = ok.to(torch.int32)
            if eng.tp_size > 1:
                ok = C.gather_metrics(ok, eng.model_group).min()
            finite = bool(C.gather_metrics(ok, eng.group).min() > 0)
        if finite:
            params, opt_state = apply_updates(eng.opt, params, agg,
                                              opt_state, lr)
        losses = C.gather_metrics(loss.to(torch.float32), eng.group)
        mean = losses[0]
        for i in range(1, losses.shape[0]):
            mean = mean + losses[i]
        metrics = {"loss": mean / losses.shape[0],
                   "lr": torch.as_tensor(lr, dtype=torch.float32)}
        if self.step_guard:
            metrics["skipped"] = 0.0 if finite else 1.0
        return params, opt_state, metrics

    def measure(self, grads, agg, step, telem):
        """telem + this step's telemetry increment, averaged over the data
        group."""
        from repro_torch.control.telemetry import accumulate, measure
        eng = self.engine
        qw = (self.comp or CompressionConfig(strategy="dense")).qw
        inc = measure(eng.measurement_plan(), qw, grads, self.key(step),
                      grads_hat=agg,
                      entire_model=self.telemetry_entire_model)
        if eng.tp_size > 1:      # the reference's pmean over every axis
            inc = _group_mean_tree(inc, eng.model_group)
        return accumulate(telem, _group_mean_tree(inc, eng.group))

    def __call__(self, params, opt_state, batch, step, telem=None):
        self.engine.bind()
        loss, grads = self.grads(params, batch, step)
        agg = self.aggregate(grads, step)
        if self.telemetry:
            telem = self.measure(grads, agg, step, telem)
        del grads
        out = self.update(params, opt_state, loss, agg, step)
        return out + (telem,) if self.telemetry else out
