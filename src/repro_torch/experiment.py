"""The paper's experiment on the port: data-parallel momentum SGD with
simulated workers, layer-wise vs entire-model compression (the JAX
package's benchmarks/common.py), and its controller-driven form
(`cnn_controller`, `train_cnn_with_controller`: the same step through a
control.Controller's decision cache, with the telemetry leg) and the
error-feedback variant of benchmarks/figures.py (`train_cnn_ef`).

Same signatures, seeds and key derivation as the reference: the data of
step i comes from fold_in(key, i), its aggregation key is
fold_in(key, 10_000 + i), and the test batch from fold_in(key, 999_999).
Per-worker gradients come from a loop over the contiguous batch shards.
The reference's train_cnn aggregates on its sim path. Here compressed
aggregation goes through real wire payloads
(aggregate_simulated_workers(..., wire=True)) whenever the codec is
bit-identical to sim — every compressor but the capacity-bounded
thresholds — so the numerics are the reference's either way and on the
card those steps run the hand-written pack/unpack kernels.

`train_cnn_ranks` is the same experiment across the real ranks of a
process group (launch/mesh.py starts them): rank r takes shard r of every
global batch, and the ranks aggregate with compressed_allreduce, so every
rank applies the same update.

`train_lm` is the repo's quickstart (examples/quickstart.py:23-52) on the
port: a causal LM of any attention family (models/model.py) trained by
Algorithm 1 over simulated workers, each worker's gradient from its
contiguous batch shard, the update p - lr * g; the aggregation goes
through real wire payloads where the codec is sim-exact, as in train_cnn.

Float32 convolutions and matmuls run in full precision: train_cnn and
train_lm turn TF32 off (cuDNN would otherwise convolve in TF32 on the
card), and train_lm also cuBLAS's reduced-precision bf16 reductions.
"""
from __future__ import annotations

import time
from typing import Dict, Iterator, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.configs.resnet9_cifar import ALEXNET, MLP, RESNET9, CNNConfig
from repro_torch.control import (CompressionDecision, Controller, Policy,
                                 accumulate, measurement_plan)
from repro_torch.convert import (tree_leaves, tree_map, tree_paths,
                                 tree_unflatten)
from repro_torch.core.aggregation import (STREAM_STRATEGIES,
                                          CompressionConfig,
                                          aggregate_simulated_workers,
                                          compressed_allreduce, worker_mean)
from repro_torch.core.compressors import Identity, make_compressor
from repro_torch.core.granularity import Granularity, stacked_mask
from repro_torch.core.wire import wire_codec
from repro_torch.data.synthetic import (classification_batch, lm_batches,
                                        patches_stub)
from repro_torch.models.cnn import cnn_accuracy, cnn_loss, init_cnn
from repro_torch.models.config import ModelConfig
from repro_torch.models.dist import DistConfig
from repro_torch.models.model import Model
from repro_torch.optim.schedules import piecewise_linear
from repro_torch.random import fold_in
from repro_torch.random import key as make_key

MODELS = {"resnet9": RESNET9, "alexnet": ALEXNET, "mlp": MLP}
# per-model stable peak LRs (the reference's values)
LR = {"resnet9": 0.01, "alexnet": 0.05, "mlp": 0.01}


def _momentum_step(params, vel, g, lr, momentum, nesterov):
    """The (heavy-ball / nesterov) SGD update of the reference."""
    vel = tree_map(lambda v, gg: momentum * v + gg, vel, g)
    upd = (tree_map(lambda gg, v: gg + momentum * v, g, vel)
           if nesterov else vel)
    params = tree_map(lambda p, u: p - lr * u, params, upd)
    return params, vel


def worker_grads(cfg: CNNConfig, params: Dict, batch: Dict, workers: int):
    """Per-worker gradients over `workers` contiguous batch shards ->
    (tree with a leading worker axis, (workers,) losses)."""
    paths = tree_paths(params)
    per = batch["labels"].shape[0] // workers
    grads, losses = [], []
    for w in range(workers):
        shard = {k: v[w * per:(w + 1) * per] for k, v in batch.items()}
        p = tree_map(lambda t: t.detach().requires_grad_(True), params)
        loss = cnn_loss(cfg, p, shard)
        grads.append(torch.autograd.grad(loss, tree_leaves(p)))
        losses.append(loss.detach())
    stacked = [torch.stack([g[i] for g in grads]) for i in range(len(paths))]
    return tree_unflatten(paths, stacked), torch.stack(losses)


def train_step(cfg: CNNConfig, comp: Optional[CompressionConfig], params,
               vel, batch, key, lr, *, workers: int = 4,
               momentum: float = 0.9, nesterov: bool = False,
               telemetry_plan=None, telemetry_entire_model: bool = True):
    """One Algorithm-1 step -> (params, vel, mean worker loss), and with
    `telemetry_plan` (needs `comp`) the step's TelemetryState increment as
    a fourth element."""
    wg, losses = worker_grads(cfg, params, batch, workers)
    if comp is None:
        out = (tree_map(worker_mean, wg),)
    else:
        wire = wire_codec(comp.qw, wire_dtype=comp.wire_dtype).exact_sim
        out = aggregate_simulated_workers(
            wg, stacked_mask(params), comp, key, wire=wire,
            telemetry_plan=telemetry_plan,
            telemetry_entire_model=telemetry_entire_model)
    params, vel = _momentum_step(params, vel, out[0], lr, momentum,
                                 nesterov)
    if telemetry_plan is None:
        return params, vel, losses.mean()
    return params, vel, losses.mean(), out[2]


def _full_precision() -> None:
    """Full-precision f32 and bf16 matmuls on the card: no TF32 (cuBLAS,
    cuDNN) and no reduced-precision bf16 reductions."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def train_cnn(model: str, comp: Optional[CompressionConfig], *,
              steps: int = 120, batch: int = 64, workers: int = 4,
              lr_peak: Optional[float] = None, momentum: float = 0.9,
              nesterov: bool = False, seed: int = 0,
              device="cuda") -> Tuple[float, float]:
    """Returns (final_test_accuracy, final_test_loss)."""
    dev = resolve_device(device)
    _full_precision()
    cfg = MODELS[model]
    lr_peak = LR[model] if lr_peak is None else lr_peak
    key = make_key(seed)
    params = init_cnn(cfg, key, device=dev)
    vel = tree_map(torch.zeros_like, params)
    sched = piecewise_linear(lr_peak, steps, max(1, steps // 8))
    for i in range(steps):
        b = classification_batch(fold_in(key, i), batch, device=dev)
        params, vel, _ = train_step(
            cfg, comp, params, vel, b, fold_in(key, 10_000 + i),
            sched(i).to(dev), workers=workers, momentum=momentum,
            nesterov=nesterov)
    test = classification_batch(fold_in(key, 999_999), 256, device=dev)
    with torch.no_grad():
        return (float(cnn_accuracy(cfg, params, test)),
                float(cnn_loss(cfg, params, test)))


def train_cnn_ranks(model: str, comp: CompressionConfig, *, group=None,
                    steps: int = 120, batch: int = 64,
                    lr_peak: Optional[float] = None, momentum: float = 0.9,
                    nesterov: bool = False, seed: int = 0, device="cuda"):
    """train_cnn on this rank of `group` (None: the default group), the
    global batch of `batch` split over the ranks; aggregation is
    compressed_allreduce(comp), with error feedback when comp asks for
    it, through real wire payloads wherever the strategy carries them
    (allgather, the streaming ring / rs_stream, and simulated with a
    sim-exact codec). Returns
    (final_test_accuracy, final_test_loss, params), the same on every
    rank."""
    dev = resolve_device(device)
    _full_precision()
    rank, n = dist.get_rank(group), dist.get_world_size(group)
    if batch % n:
        raise ValueError(f"batch {batch} does not split over {n} ranks")
    cfg = MODELS[model]
    lr_peak = LR[model] if lr_peak is None else lr_peak
    key = make_key(seed)
    params = init_cnn(cfg, key, device=dev)
    vel = tree_map(torch.zeros_like, params)
    ef = (tree_map(torch.zeros_like, params) if comp.error_feedback
          else None)
    stacked = stacked_mask(params)
    wire = comp.strategy in ("allgather",) + STREAM_STRATEGIES or (
        comp.strategy == "simulated"
        and wire_codec(comp.qw, wire_dtype=comp.wire_dtype).exact_sim)
    sched = piecewise_linear(lr_peak, steps, max(1, steps // 8))
    per = batch // n
    for i in range(steps):
        b = classification_batch(fold_in(key, i), batch, device=dev)
        shard = {k: v[rank * per:(rank + 1) * per] for k, v in b.items()}
        p = tree_map(lambda t: t.detach().requires_grad_(True), params)
        loss = cnn_loss(cfg, p, shard)
        g = tree_unflatten(tree_paths(params),
                           torch.autograd.grad(loss, tree_leaves(p)))
        g, ef = compressed_allreduce(g, stacked, comp, group,
                                     fold_in(key, 10_000 + i), n,
                                     ef_state=ef, wire=wire)
        params, vel = _momentum_step(params, vel, g, sched(i).to(dev),
                                     momentum, nesterov)
    test = classification_batch(fold_in(key, 999_999), 256, device=dev)
    with torch.no_grad():
        return (float(cnn_accuracy(cfg, params, test)),
                float(cnn_loss(cfg, params, test)), params)


def compare_granularities(model: str, qname: str, *, steps=120, seed=0,
                          nesterov=False, device="cuda",
                          **qkw) -> Dict[str, float]:
    """The paper's core comparison for one (model, compressor, params)."""
    out = {}
    for gran in ("layerwise", "entire_model"):
        comp = CompressionConfig(qw=make_compressor(qname, **qkw),
                                 granularity=Granularity(gran))
        out[gran], _ = train_cnn(model, comp, steps=steps, seed=seed,
                                 nesterov=nesterov, device=device)
    out["baseline"], _ = train_cnn(model, None, steps=steps, seed=seed,
                                   nesterov=nesterov, device=device)
    return out


def csv_line(name: str, t_us: float, derived: str):
    print(f"{name},{t_us:.1f},{derived}")


def train_cnn_ef(model: str, comp: CompressionConfig, steps: int = 100, *,
                 device="cuda", params=None, batch_fn=None):
    """benchmarks/figures.py's train_cnn variant threading error-feedback
    state: plain SGD (error feedback with heavy-ball momentum
    double-counts the re-injected residuals), EF memory with a leading
    worker axis of 4, key(0), batches of 64 and the LR schedule of
    train_cnn. Returns (final_test_accuracy, None). `params` replaces the
    init and `batch_fn(key, n)` the batch draws (tests feed the
    reference's)."""
    dev = resolve_device(device)
    _full_precision()
    cfg = MODELS[model]
    key = make_key(0)
    if params is None:
        params = init_cnn(cfg, key, device=dev)
    if batch_fn is None:
        batch_fn = lambda k, n: classification_batch(k, n, device=dev)
    efs = (tree_map(lambda x: torch.zeros((4,) + tuple(x.shape),
                                          dtype=x.dtype, device=x.device),
                    params) if comp.error_feedback else None)
    sm = stacked_mask(params)
    wire = wire_codec(comp.qw, wire_dtype=comp.wire_dtype).exact_sim
    sched = piecewise_linear(LR[model], steps, max(1, steps // 8))
    for i in range(steps):
        b = batch_fn(fold_in(key, i), 64)
        wg, _ = worker_grads(cfg, params, b, 4)
        g, efs = aggregate_simulated_workers(
            wg, sm, comp, fold_in(key, 10_000 + i), ef_state=efs, wire=wire)
        lr = sched(i).to(dev)
        params = tree_map(lambda p, gg: p - lr * gg, params, g)
    test = batch_fn(fold_in(key, 999_999), 256)
    with torch.no_grad():
        return float(cnn_accuracy(cfg, params, test)), None


# ---- the controller-driven study (the adaptive control loop over the same
# simulated-worker Algorithm-1 step train_cnn takes) ---------------------------

def dense_decision() -> CompressionDecision:
    """No-compression decision (identity Q_W / Q_M == the plain gradient
    mean)."""
    return CompressionDecision(qw=Identity(), qm=Identity())


def cnn_controller(model: str, policy: Policy, *,
                   base: Optional[CompressionDecision] = None,
                   workers: int = 4, momentum: float = 0.9,
                   nesterov: bool = False, replan_every: int = 10,
                   collect_telemetry: Optional[bool] = None,
                   cache: Optional[dict] = None) -> Controller:
    """A Controller whose data plane is train_step for the decision's
    config (the reference's jitted simulated-worker step), with the
    telemetry leg when the policy reads it. The measurement plan comes
    from the model's shapes (an init on the meta device). Pass one shared
    `cache` dict across controllers to reuse built steps over a study
    sweep."""
    cfg = MODELS[model]
    shapes = init_cnn(cfg, make_key(0), device="meta")
    sm = stacked_mask(shapes)
    mplan = measurement_plan(shapes, sm)
    collect = (policy.needs_telemetry if collect_telemetry is None
               else bool(collect_telemetry))
    em = getattr(policy, "needs_entire_model", True)

    def build(decision: CompressionDecision):
        comp = decision.to_config()

        def step(params, vel, batch, key, lr, telem):
            out = train_step(cfg, comp, params, vel, batch, key, lr,
                             workers=workers, momentum=momentum,
                             nesterov=nesterov,
                             telemetry_plan=mplan if collect else None,
                             telemetry_entire_model=em)
            if collect:
                telem = accumulate(telem, out[3])
            return out[0], out[1], telem
        return step

    # tag = every build input besides the decision (see engine_controller)
    return Controller(policy, build, base or dense_decision(), mplan,
                      replan_every=replan_every, collect_telemetry=collect,
                      cache=cache,
                      cache_tag=("cnn", model, workers, momentum, nesterov,
                                 em))


def train_cnn_with_controller(model: str, ctrl: Controller, *,
                              steps: int = 120, batch: int = 64,
                              lr_peak: Optional[float] = None,
                              seed: int = 0,
                              device="cuda") -> Tuple[float, float]:
    """train_cnn's loop driven through a Controller: the same data stream,
    keys and LR schedule, the step fetched from the decision cache every
    iteration and telemetry fed back at re-plan boundaries. Returns
    (final_test_accuracy, final_test_loss)."""
    dev = resolve_device(device)
    _full_precision()
    cfg = MODELS[model]
    lr_peak = LR[model] if lr_peak is None else lr_peak
    key = make_key(seed)
    params = init_cnn(cfg, key, device=dev)
    vel = tree_map(torch.zeros_like, params)
    sched = piecewise_linear(lr_peak, steps, max(1, steps // 8))
    for i in range(steps):
        b = classification_batch(fold_in(key, i), batch, device=dev)
        fn = ctrl.step_fn()
        params, vel, telem = fn(params, vel, b, fold_in(key, 10_000 + i),
                                sched(i).to(dev), ctrl.telemetry)
        ctrl.observe(telem, i)
    test = classification_batch(fold_in(key, 999_999), 256, device=dev)
    with torch.no_grad():
        return (float(cnn_accuracy(cfg, params, test)),
                float(cnn_loss(cfg, params, test)))


# ---- the causal LMs: examples/quickstart.py's experiment ---------------------

def lm_worker_grads(model: Model, params: Dict, batch: Dict,
                    key: torch.Tensor, workers: int):
    """Per-worker gradients of model.loss over `workers` contiguous shards
    of every batch entry -> (tree with a leading worker axis, (workers,)
    f32 losses). Each worker's gradients are copied into the stacked
    leaves as soon as they exist, so one worker's set lives at a time."""
    paths = tree_paths(params)
    leaves = tree_leaves(params)
    per = batch["tokens"].shape[0] // workers
    stacked = [torch.empty((workers,) + tuple(l.shape), dtype=l.dtype,
                           device=l.device) for l in leaves]
    losses = []
    for w in range(workers):
        shard = {k: v[w * per:(w + 1) * per] for k, v in batch.items()}
        p = [l.detach().requires_grad_(True) for l in leaves]
        loss = model.loss(tree_unflatten(paths, p), shard, key)
        for out, g in zip(stacked, torch.autograd.grad(loss, p)):
            out[w].copy_(g)
        losses.append(loss.detach())
    return tree_unflatten(paths, stacked), torch.stack(losses)


def lm_train_step(model: Model, comp: Optional[CompressionConfig], params,
                  batch, key, lr: float, *, workers: int = 4,
                  wire: Optional[bool] = None):
    """One Algorithm-1 step of quickstart's `step` -> (params, mean worker
    loss): the worker gradients under `key`, aggregate_simulated_workers
    (comp None: the plain worker mean), then p - lr * g. `wire` None takes
    the wire path wherever the codec is sim-exact."""
    wg, losses = lm_worker_grads(model, params, batch, key, workers)
    if comp is None:
        g = tree_map(worker_mean, wg)
    else:
        if wire is None:
            wire = wire_codec(comp.qw, wire_dtype=comp.wire_dtype).exact_sim
        g, _ = aggregate_simulated_workers(wg, model.stacked(), comp, key,
                                           wire=wire)
    del wg
    return tree_map(lambda p, gg: p - lr * gg, params, g), losses.mean()


def lm_batch(cfg: ModelConfig, data, key, batch: int, device):
    """The next batch of `data`, with the VLM's patch embeddings (drawn
    from `key`) beside the tokens."""
    b = next(data)
    if cfg.arch_type == "vlm":
        b["patch_embeds"] = patches_stub(key, batch, cfg.frontend_seq,
                                         cfg.d_model, device=device)
    return b


def train_lm(cfg: ModelConfig, comp: Optional[CompressionConfig], *,
             steps: int = 40, workers: int = 4, lr: float = 0.3,
             batch: int = 8, seq: int = 32, seed: int = 0, device="cuda",
             data: Optional[Iterator[Dict]] = None):
    """examples/quickstart.py's `train` on the port: params from
    key(seed), batches from lm_batches(cfg.vocab, batch, seq, seed + 1),
    the loss of each batch under key(9) before step i, whose key is
    fold_in(key(2), i). `data` replaces the batch stream (dicts of
    (batch, seq) "tokens" / "targets" on the device): the Markov chain's
    (vocab, vocab) matrix does not fit a host at a full-width vocab.
    Returns (first loss, last loss, seconds, params); the seconds cover
    the steps (init and data excluded), synchronized."""
    dev = resolve_device(device)
    _full_precision()
    model = Model(cfg, DistConfig())
    params = model.init(make_key(seed), device=dev)
    if data is None:
        data = lm_batches(cfg.vocab, batch, seq, seed=seed + 1, device=dev)
    loss_key = make_key(9)
    first = last = None
    seconds = 0.0
    for i in range(steps):
        b = lm_batch(cfg, data, fold_in(make_key(seed + 1), i), batch, dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        with torch.no_grad():
            last = float(model.loss(params, b, loss_key))
        first = last if first is None else first
        params, _ = lm_train_step(model, comp, params, b,
                                  fold_in(make_key(2), i), lr,
                                  workers=workers)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        seconds += time.perf_counter() - t0
    return first, last, seconds, params
