"""Recovery policies: wiring corruption DETECTION to ACTION (the JAX
package's resil/recovery.py).

RecoveryConfig names the four policies the resilience plane implements:

  resend                 a message whose Fletcher-32 check fails is
                         replaced by the sender's clean re-encode
                         (the sender still holds the clean buffer —
                         core.wire._receive_buffer);
  dense_fallback_after   after N CONSECUTIVE steps with detected
                         corruption, drop the compressed wire entirely
                         and aggregate dense (no packed bytes => nothing
                         for the fault plane to corrupt);
  step_guard             a non-finite loss or aggregated gradient skips
                         the parameter update AND rolls the EF residual
                         back to its pre-step value (a skipped step must
                         not advance error memory);
  straggler_timeout_us   workers whose straggler delay exceeds the
                         timeout are dropped from the step; the mean
                         renormalizes over survivors and their EF rows
                         freeze (partial participation).

RecoveryManager is the host-side controller: it drains the per-step
fault counters, applies the fallback policy, feeds the obs counters
(resil/corrupt_detected, resil/resends, resil/steps_skipped), and
exposes its decision state as a checkpointable dict.

`train_resilient` is the loop threading all of it through SimCluster,
with atomic checkpoints (params + EF + PRNG key + manager state) and the
bitwise replay contract: train N steps == train k, kill, resume, train
N-k, asserted leaf for leaf by the fault campaign (repro_torch/faults.py)
and tests/test_torch_resil.py. The reference's jit cache over (n, per,
fallback, alive) is a plain eager step here.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.convert import (tree_leaves, tree_map, tree_paths,
                                 tree_unflatten)
from repro_torch.random import fold_in
from repro_torch.random import key as make_key


@dataclasses.dataclass(frozen=True)
class RecoveryConfig:
    resend: bool = True
    dense_fallback_after: Optional[int] = None
    step_guard: bool = True
    straggler_timeout_us: Optional[float] = None

    def __post_init__(self):
        if (self.dense_fallback_after is not None
                and self.dense_fallback_after < 1):
            raise ValueError(f"dense_fallback_after must be >= 1 or None:"
                             f" {self.dense_fallback_after}")
        if (self.straggler_timeout_us is not None
                and self.straggler_timeout_us < 0):
            raise ValueError(f"negative straggler timeout: "
                             f"{self.straggler_timeout_us}")


class RecoveryManager:
    """Host-side recovery controller + obs counter sink.

    It consumes concrete per-step counters, keeps running totals, and
    flips `fallback_active` once `dense_fallback_after` consecutive
    corrupted steps have been seen (the next step then aggregates dense).
    `metrics` is the duck-typed obs.MetricsRegistry (None = counters kept
    locally only).
    """

    _COUNTERS = ("resil/corrupt_detected", "resil/resends",
                 "resil/steps_skipped")

    def __init__(self, config: RecoveryConfig, *, metrics=None):
        self.config = config
        self.metrics = metrics
        self.counters: Dict[str, int] = {k: 0 for k in self._COUNTERS}
        self.consecutive_failures = 0
        self.fallback_active = False

    def observe(self, *, detected: int = 0, resends: int = 0,
                skipped: int = 0) -> None:
        """Fold one step's counters in and update the fallback decision."""
        detected, resends, skipped = (int(detected), int(resends),
                                      int(skipped))
        self.counters["resil/corrupt_detected"] += detected
        self.counters["resil/resends"] += resends
        self.counters["resil/steps_skipped"] += skipped
        if self.metrics is not None:
            self.metrics.inc("resil/corrupt_detected", detected)
            self.metrics.inc("resil/resends", resends)
            self.metrics.inc("resil/steps_skipped", skipped)
        if not self.fallback_active:
            self.consecutive_failures = (self.consecutive_failures + 1
                                         if detected > 0 else 0)
            after = self.config.dense_fallback_after
            if after is not None and self.consecutive_failures >= after:
                self.fallback_active = True

    # ---- checkpointable decision state -----------------------------------
    def state(self) -> Dict[str, np.ndarray]:
        """The manager's full decision state as an int64 leaf dict,
        checkpointed next to params / EF so a resumed run replays the
        SAME fallback decisions (part of the bitwise contract)."""
        s = {k.replace("/", "_"): np.asarray(v, np.int64)
             for k, v in self.counters.items()}
        s["consecutive_failures"] = np.asarray(self.consecutive_failures,
                                               np.int64)
        s["fallback_active"] = np.asarray(int(self.fallback_active),
                                          np.int64)
        return s

    def restore(self, state: Dict) -> None:
        for k in self._COUNTERS:
            self.counters[k] = int(np.asarray(state[k.replace("/", "_")]))
        self.consecutive_failures = int(
            np.asarray(state["consecutive_failures"]))
        self.fallback_active = bool(
            int(np.asarray(state["fallback_active"])))


# ---- the resilient training loop ---------------------------------------------

_CKPT_TAG = "resil"
_STEP_RE = re.compile(r"_(\d+)_s\d+\.npz$")


def _finite_tree(tree) -> bool:
    return all(bool(torch.isfinite(leaf).all()) for leaf in tree_leaves(tree))


def _key_data(key: torch.Tensor) -> np.ndarray:
    """A key as the reference's checkpoint stores it (uint32 key data)."""
    return key.cpu().numpy().astype(np.uint32)


def runner_grads(runner, params, wbatch, key, n: int):
    """Each of n workers' runner.loss and its gradient on the worker's
    slice of `wbatch` under fold_in(key, w) -> (gradient tree with a
    leading worker axis, (n,) losses)."""
    paths, leaves = tree_paths(params), tree_leaves(params)
    keys = fold_in(key[None], torch.arange(n))
    grads, losses = [], []
    for w in range(n):
        b = {k: v[w] for k, v in wbatch.items()}
        p = [t.detach().requires_grad_(True) for t in leaves]
        loss = runner.loss(tree_unflatten(paths, p), b, keys[w])
        grads.append(torch.autograd.grad(loss, p))
        losses.append(loss.detach())
    stacked = [torch.stack([g[i] for g in grads]) for i in range(len(paths))]
    return tree_unflatten(paths, stacked), torch.stack(losses)


def train_resilient(runner, scenario, comp, *, steps: int, lr: float = 0.02,
                    seed: int = 0, recovery: RecoveryConfig = None,
                    ckpt_dir: Optional[str] = None, ckpt_every: int = 0,
                    resume: bool = False, metrics=None, grad_hook=None):
    """Train `steps` steps of simulated-multi-worker compressed SGD under
    `scenario`, with the full recovery stack.

    `runner` follows the campaign protocol (repro_torch/scenarios.py):
    `categories`, `global_batch`, `init(key)` (params on the runner's
    device), `loss(params, batch, key)`, `worker_batch(key, props, per)`.
    `comp` is the CompressionConfig; the aggregate runs wire=True so the
    scenario's CorruptionSpec has real packed bytes to corrupt.

    Every draw is a pure function of (seed, step index): batches from
    fold_in(key0, 100 + i), the step from fold_in(key0, 10_000 + i), the
    aggregate from its fold_in(., 0xA), worker w's loss from its
    fold_in(., w). So resuming from a checkpoint at step k replays steps
    k..N bit for bit: `train_resilient(..., steps=N)` ==
    `train_resilient(..., steps=k, ckpt_every=k)` then
    `train_resilient(..., steps=N, resume=True)`, leaf for leaf.
    Checkpoints (atomic, digest-verified) carry params, EF residuals, the
    key data and the RecoveryManager's state under tag "resil".

    `grad_hook(worker_grads, step_key)` optionally perturbs the
    per-worker gradients before aggregation (the step-guard tests inject
    a non-finite step through it). Returns a result dict (final params,
    EF, per-step losses, counters, manager, accounting)."""
    from repro_torch.ckpt import (latest_checkpoint, load_checkpoint,
                                  save_checkpoint)
    from repro_torch.core import stacked_mask
    from repro_torch.core.aggregation import _survivor_mean, worker_mean
    from repro_torch.data import dirichlet_proportions
    from repro_torch.sim import SimCluster, init_ef

    recovery = RecoveryConfig() if recovery is None else recovery
    manager = RecoveryManager(recovery, metrics=metrics)
    cluster = SimCluster(scenario, comp)
    key0 = make_key(seed)

    params = runner.init(key0)
    dev = tree_leaves(params)[0].device
    sm = stacked_mask(params)
    n_max = max([scenario.n_workers]
                + [ev.world_size for ev in scenario.rescales])
    alpha = scenario.dirichlet_alpha
    props_all = (dirichlet_proportions(fold_in(key0, 0xD), n_max,
                                       runner.categories, alpha, device=dev)
                 if alpha is not None
                 else torch.full((n_max, runner.categories),
                                 1.0 / runner.categories, device=dev))
    start = 0
    ef = init_ef(params, scenario.n_workers)

    if resume:
        if not ckpt_dir:
            raise ValueError("resume=True requires ckpt_dir")
        path = latest_checkpoint(ckpt_dir, tag=_CKPT_TAG)
        if path is None:
            raise ValueError(f"resume=True but no '{_CKPT_TAG}' "
                             f"checkpoint under {ckpt_dir!r}")
        start = int(_STEP_RE.search(path).group(1))
        like = {
            "params": params,
            "ef": init_ef(params, scenario.world_size_at(start - 1)
                          if start > 0 else scenario.n_workers),
            "key": _key_data(key0),
            "manager": manager.state(),
        }
        ck_step, restored = load_checkpoint(path, like=like)
        assert ck_step == start
        params = restored["params"]
        ef = restored["ef"]
        key0 = torch.from_numpy(
            restored["key"].numpy().astype(np.int64))
        manager.restore({k: v.numpy() for k, v in
                         restored["manager"].items()})

    injector = cluster.injector(resend=recovery.resend)

    def step(params, ef, wbatch, key, n, fallback, alive):
        wg, losses = runner_grads(runner, params, wbatch, key, n)
        if grad_hook is not None:
            wg = grad_hook(wg, key)
        akey = fold_in(key, 0xA)
        info = {"messages": 0, "corrupt_detected": 0, "resends": 0}
        if fallback:
            # dense fallback: the compressed wire is abandoned, so
            # Algorithm 1 degenerates to the (survivor-weighted) plain
            # mean; EF residuals are carried untouched
            g = (tree_map(worker_mean, wg) if alive is None
                 else tree_map(lambda x: _survivor_mean(x, alive), wg))
            new_ef = ef
        else:
            out = cluster.aggregate(
                wg, sm, akey, ef_state=ef if comp.error_feedback else None,
                wire=True, faults=injector, alive=alive)
            g = out[0]
            new_ef = out[1] if comp.error_feedback else ef
            if injector is not None:
                info = {k: int(v) for k, v in out[-1].items()}
        del wg
        loss = losses.sum() / losses.numel()
        new_params = tree_map(lambda p, u: p - lr * u, params, g)
        skipped = 0
        if recovery.step_guard:
            if not (bool(torch.isfinite(loss)) and _finite_tree(g)):
                new_params, new_ef, skipped = params, ef, 1
        return new_params, new_ef, loss, skipped, info

    losses = []
    for i in range(start, steps):
        n, ef, _changed = cluster.maybe_rescale(i, ef)
        per = max(1, runner.global_batch // n)
        wbatch = runner.worker_batch(fold_in(key0, 100 + i), props_all[:n],
                                     per)
        alive = cluster.alive_mask(i, recovery.straggler_timeout_us)
        params, ef, loss, skipped, info = step(
            params, ef, wbatch, fold_in(key0, 10_000 + i), n,
            manager.fallback_active, alive)
        losses.append(float(loss))
        manager.observe(detected=info["corrupt_detected"],
                        resends=info["resends"], skipped=skipped)
        if metrics is not None:
            metrics.observe("resil/loss", float(loss))
            metrics.inc("resil/steps")
        if ckpt_dir and ckpt_every and (i + 1) % ckpt_every == 0:
            save_checkpoint(ckpt_dir, i + 1, {
                "params": params, "ef": ef, "key": _key_data(key0),
                "manager": manager.state(),
            }, tag=_CKPT_TAG)

    return {
        "params": params,
        "ef": ef,
        "losses": losses,
        "counters": dict(manager.counters),
        "fallback_active": manager.fallback_active,
        "manager": manager,
        "accounting": cluster.accounting,
    }
