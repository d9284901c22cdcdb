"""The data-parallel execution engine (the JAX package's launch/engine.py
on a data-only mesh): train, prefill and serve steps with the paper's
compressed gradient aggregation wired in, one rank process per worker.

train step (on every rank of the mesh's data group):
  1. forward / backward on this rank's rows of the global batch
     (`train_microbatch` microbatches accumulated in the param dtype)
  2. the paper's Algorithm 1 on the gradient tree: Q_W on this rank ->
     the collective over the data group -> Q_M (compressed_allreduce,
     through the engine's cached UnitPlan; wire=True packs real message
     buffers, collective='ring' streams them around the ring)
  3. the optimizer update, the same on every rank

Rank r of n takes rows [r B / n, (r + 1) B / n) of the global batch, as
the reference's data sharding does, and the step key is
fold_in(key(42), step), the reference's. The loss is averaged over the
data group in rank order (the reference's pmean); step_guard's finite
flag is reduced by MIN over the group, so every rank takes the same
branch. Torch has no buffer donation: the step returns new trees.

With telemetry=True the step also threads a control.TelemetryState: each
rank measures its own gradients against the aggregate, and the increments
are averaged over the data group in rank order (the reference's pmean)
before they accumulate, so every rank holds the same state.

The reference's tensor- and sequence-parallel axes and FSDP are ROADMAP
Queue 1 item 4b: a mesh with model > 1 or a pod axis, and cfg.use_fsdp,
raise. The trace recorder and metrics registry (tracer=, metrics=) are
item 6.
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
from repro_torch.core.plan import build_plan
from repro_torch.core.wire import not_ported
from repro_torch.launch.mesh import ITEM_4B, Mesh, axis_sizes
from repro_torch.models.config import InputShape, ModelConfig
from repro_torch.models.dist import DistConfig
from repro_torch.models.model import Model
from repro_torch.models.params import torch_dtype
from repro_torch.optim import OptConfig, apply_updates, init_opt_state

ITEM_6 = "item 6 (obs/)"
# batch entries whose first dim is the batch
_BATCH_ROWS = ("tokens", "targets", "patch_embeds", "frames", "token")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _group_values(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's 0-d `x`, in rank order -> (n,). A step's metric
    reductions, kept out of the collectives' wire counters."""
    n = dist.get_world_size(group)
    out = torch.empty((n,), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x.reshape(1).contiguous(), group=group)
    return out


def _group_mean_tree(tree, group):
    """The mean over the data group of every tensor of a tuple of f32
    tensors, summed in rank order then divided by n (the reference's
    pmean): one all_gather of the concatenated fields."""
    n = dist.get_world_size(group)
    if n == 1:
        return tree
    flat = torch.cat([t.reshape(-1) for t in tree])
    got = torch.empty((n * flat.numel(),), dtype=flat.dtype,
                      device=flat.device)
    dist.all_gather_into_tensor(got, flat.contiguous(), group=group)
    got = got.reshape(n, -1)
    mean = got[0]
    for i in range(1, n):
        mean = mean + got[i]
    mean = mean / n
    out, off = [], 0
    for t in tree:
        out.append(mean[off:off + t.numel()].reshape(t.shape))
        off += t.numel()
    return type(tree)(*out)


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
        if "pod" in self.sizes or self.sizes.get("model", 1) > 1:
            raise not_ported("a tensor-parallel or pod mesh", ITEM_4B)
        if cfg.use_fsdp:
            raise not_ported("FSDP (cfg.use_fsdp)", ITEM_4B)
        # no TP axis on a data-only mesh (the port's DistConfig has none)
        self.dist = DistConfig(dp=("data",))
        self.model = Model(cfg, self.dist, self.sizes)
        self.comp = comp
        self.opt = opt or OptConfig()
        self.remat = remat
        self.device = resolve_device(device)
        self.dp_size = self.sizes["data"]
        self.group = mesh.group("data")
        self._plans: Dict[Any, tuple] = {}

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
        """The batch dim's axis: "data", or None (every rank takes the
        whole batch) when the global batch does not divide the ranks."""
        if shape.global_batch % self.dp_size != 0:
            return None
        return "data"

    def batch_pspecs(self, shape: InputShape) -> Dict[str, tuple]:
        """Each entry's partition, one mesh axis or None per dim (the
        reference's PartitionSpecs as tuples)."""
        dpp = self._dpp(shape)
        return {k: (() if k == "pos" else (dpp,) + (None,) * (v.dim() - 1))
                for k, v in self.batch_shapes(shape).items()}

    def _rank(self) -> int:
        return dist.get_rank(self.group) if self.dp_size > 1 else 0

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
                self.model.param_shapes(), self.model.stacked())
        return self._plans["measure"]

    def comm_plans(self, comp: Optional[CompressionConfig] = None):
        """(rest_plan, fsdp_plan): the static UnitPlans the train step
        compresses through, built from the parameter shapes (a data-only
        mesh shards no leaf) and cached on the engine, so the step and
        every caller before it (the CLI's summary, comm_report,
        comm_sched) share one plan object. fsdp_plan is None: no leaf is
        aggregated in an FSDP backward hook here."""
        comp = comp or self.comp or CompressionConfig(strategy="dense")
        key = comp.granularity
        if key not in self._plans:
            shapes = self.model.param_shapes()
            rest = (build_plan(shapes, self.model.stacked(), comp.granularity)
                    if tree_leaves(shapes) else None)
            self._plans[key] = (rest, None)
        return self._plans[key]

    def _aggregate_grads(self, grads, key: torch.Tensor,
                         comp: Optional[CompressionConfig] = None,
                         schedule=None, wire: bool = False, recorder=None):
        """Algorithm 1 over the data group, through the engine's cached
        plan; `schedule` (a CommSchedule of that plan) or
        comp.fusion_bytes streams it through the backward-ordered message
        schedule (bit-identical numerics); wire=True packs real message
        buffers."""
        if recorder is not None:
            raise not_ported("the trace recorder (recorder=)", ITEM_6)
        comp = comp if comp is not None else self.comp
        stacked = self.model.stacked()
        if comp is None or comp.strategy == "dense":
            agg, _ = compressed_allreduce(
                grads, stacked, comp or CompressionConfig(strategy="dense"),
                self.group, key, self.dp_size, wire=wire)
            return agg
        rest_plan, _ = self.comm_plans(comp)
        agg, _ = compressed_allreduce(grads, stacked, comp, self.group, key,
                                      self.dp_size, plan=rest_plan,
                                      schedule=schedule, wire=wire)
        return agg

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
        under the step key) averaged over the data group: absolute second
        moments are per-rank averages, and the ratio statistics every
        policy reads are exact. `telemetry_entire_model=False` drops the
        flat counterfactual compression pass (only GranularitySwitchPolicy
        reads it).

        The engine threads no error-feedback state (nor does the
        reference's): a config with error_feedback raises the reference's
        ValueError here, where the reference raises it at its first step.
        """
        if tracer is not None or metrics is not None:
            raise not_ported("the trace recorder and metrics registry "
                             "(tracer=, metrics=)", ITEM_6)
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
        return TrainStep(self, lr_schedule, comp_eff, schedule, wire,
                         step_guard, telemetry, telemetry_entire_model)

    # ---- inference steps ----------------------------------------------------
    def build_prefill(self, shape: InputShape, cache_len: int = None):
        """The prefill step on this rank: fn(params, global_batch) -> (this
        rank's rows' last logits, this rank's cache). `cache_len` sizes
        the cache beyond the prompt (the serve loop's generation slots).
        A global batch that does not divide the ranks runs whole on every
        rank."""
        model, sharded = self.model, self._dpp(shape) is not None

        def step_fn(params, batch):
            return model.prefill(params, self.local_batch(batch, sharded),
                                 R.key(0), remat=self.remat,
                                 cache_len=cache_len)
        return step_fn

    def build_serve_step(self, shape: InputShape):
        """One decode step on this rank: fn(params, {"token": (B,), "pos"},
        cache) -> (this rank's logits, its cache, written in place)."""
        model, sharded = self.model, self._dpp(shape) is not None

        def step_fn(params, batch, cache):
            b = self.local_batch(batch, sharded)
            return model.decode_step(params, b["token"], batch["pos"], cache)
        return step_fn

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
        """Params from Model.init(key(seed)) and the optimizer's zero state
        on the engine's device. The draws are made on the CPU, so every
        device starts from the same params (not the reference's draws:
        tests convert the reference's init_state); at full width draw on
        the device with `self.model.init(key, device=...)` instead."""
        params = tree_map(lambda t: t.to(self.device),
                          self.model.init(R.key(seed), device="cpu"))
        return params, init_opt_state(self.opt, params)


class TrainStep:
    """Engine.build_train_step's step. Calling it runs `grads`, then
    `aggregate`, then `update`; the three stages are public so a caller
    can time them apart."""

    def __init__(self, engine: Engine, lr_schedule, comp, schedule,
                 wire: bool, step_guard: bool, telemetry: bool = False,
                 telemetry_entire_model: bool = True):
        self.engine = engine
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
        its rows of the global batch; with cfg.train_microbatch > 1 the
        rows split into microbatches whose gradients add up in the param
        dtype and then scale by 1 / mb, as the reference's scan."""
        eng = self.engine
        model, key = eng.model, self.key(step)
        b = eng.local_batch(batch)
        paths, leaves = tree_paths(params), tree_leaves(params)

        def value_and_grad(bi):
            p = [l.detach().requires_grad_(True) for l in leaves]
            loss = model.loss(tree_unflatten(paths, p), bi, key,
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
        """The gradient tree aggregated over the data group."""
        return self.engine._aggregate_grads(grads, self.key(step), self.comp,
                                            schedule=self.schedule,
                                            wire=self.wire)

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
            finite = bool(_group_values(ok.to(torch.int32), eng.group)
                          .min() > 0)
        if finite:
            params, opt_state = apply_updates(eng.opt, params, agg,
                                              opt_state, lr)
        losses = _group_values(loss.to(torch.float32), eng.group)
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
        return accumulate(telem, _group_mean_tree(inc, eng.group))

    def __call__(self, params, opt_state, batch, step, telem=None):
        loss, grads = self.grads(params, batch, step)
        agg = self.aggregate(grads, step)
        if self.telemetry:
            telem = self.measure(grads, agg, step, telem)
        del grads
        out = self.update(params, opt_state, loss, agg, step)
        return out + (telem,) if self.telemetry else out
