"""The paper's experiment on the port: data-parallel momentum SGD with
simulated workers, layer-wise vs entire-model compression (the JAX
package's benchmarks/common.py:26-91).

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

Float32 convolutions and matmuls run in full precision: train_cnn turns
TF32 off (cuDNN would otherwise convolve in TF32 on the card).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.configs.resnet9_cifar import ALEXNET, MLP, RESNET9, CNNConfig
from repro_torch.convert import (tree_leaves, tree_map, tree_paths,
                                 tree_unflatten)
from repro_torch.core.aggregation import (STREAM_STRATEGIES,
                                          CompressionConfig,
                                          aggregate_simulated_workers,
                                          compressed_allreduce, worker_mean)
from repro_torch.core.compressors import make_compressor
from repro_torch.core.granularity import Granularity, stacked_mask
from repro_torch.core.wire import wire_codec
from repro_torch.data.synthetic import classification_batch
from repro_torch.models.cnn import cnn_accuracy, cnn_loss, init_cnn
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
               momentum: float = 0.9, nesterov: bool = False):
    """One Algorithm-1 step -> (params, vel, mean worker loss)."""
    wg, losses = worker_grads(cfg, params, batch, workers)
    if comp is None:
        g = tree_map(worker_mean, wg)
    else:
        wire = wire_codec(comp.qw, wire_dtype=comp.wire_dtype).exact_sim
        g, _ = aggregate_simulated_workers(wg, stacked_mask(params), comp,
                                           key, wire=wire)
    params, vel = _momentum_step(params, vel, g, lr, momentum, nesterov)
    return params, vel, losses.mean()


def train_cnn(model: str, comp: Optional[CompressionConfig], *,
              steps: int = 120, batch: int = 64, workers: int = 4,
              lr_peak: Optional[float] = None, momentum: float = 0.9,
              nesterov: bool = False, seed: int = 0,
              device="cuda") -> Tuple[float, float]:
    """Returns (final_test_accuracy, final_test_loss)."""
    dev = resolve_device(device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
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
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
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
