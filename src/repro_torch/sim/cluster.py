"""SimCluster: the fault-injection harness around the simulated-worker
Algorithm-1 path (the JAX package's sim/cluster.py).

Design rule (the contract tests/test_torch_scenarios.py pins): faults
NEVER touch the aggregation's numerics. `aggregate` is a pass-through to
core.aggregation.aggregate_simulated_workers, bit-identical always. The
scenario acts on the planes around it:

  TIME   `step_accounting` prices one step's communication per worker
         through the deterministic alpha-beta pipeline model
         (core.schedule.simulate_schedule) at that worker's LINK, with
         the fusion threshold control.FusionPolicy picks for that link,
         plus the scenario's straggler delay draws, all charged into
         exposed comm. The synchronous allreduce waits for the slowest
         worker, so the step's exposed comm is the max over workers.

  SHAPE  `maybe_rescale` applies the scenario's elastic world-size
         events between steps: EF residual state (leading worker axis)
         is round-tripped THROUGH a real ckpt/ checkpoint and re-bucketed
         onto the new world size without losing residual mass (departing
         worker i folds into surviving slot i % new_n; joiners start at
         zero). A rescale to the current size returns the state bit for
         bit.

  DATA   non-IID shard skew lives in data/synthetic.py (Dirichlet
         proportions and the skewed samplers); the campaign wires it to
         `scenario.dirichlet_alpha`.
"""
from __future__ import annotations

import shutil
import tempfile
import weakref
from typing import Dict, List, Optional

import torch

from repro_torch.ckpt import load_checkpoint, save_checkpoint
from repro_torch.convert import tree_map
from repro_torch.core.aggregation import (CompressionConfig,
                                          aggregate_simulated_workers)
from repro_torch.core.plan import UnitPlan
from repro_torch.core.schedule import build_schedule, simulate_schedule
from repro_torch.sim.scenario import LinkSpec, Scenario


def init_ef(params_like, n_workers: int):
    """Zero EF residual state with the leading worker axis the simulated-
    worker path threads: one residual per worker per leaf, on each leaf's
    device."""
    return tree_map(lambda p: torch.zeros((n_workers,) + tuple(p.shape),
                                          dtype=p.dtype, device=p.device),
                    params_like)


def _rebucket_rows(x: torch.Tensor, new_n: int) -> torch.Tensor:
    """Re-bucket one EF leaf (old_n, ...) onto `new_n` worker slots.

    new_n == old_n: the identity (returned untouched). Scale down:
    departing worker i folds into surviving slot i % new_n (every old row
    lands in exactly one new row). Scale up: surviving slots keep their
    rows, joiners start at zero."""
    old_n = x.shape[0]
    if new_n == old_n:
        return x
    rest = tuple(x.shape[1:])
    if new_n > old_n:
        pad = torch.zeros((new_n - old_n,) + rest, dtype=x.dtype,
                          device=x.device)
        return torch.cat([x, pad], dim=0)
    extra = (-old_n) % new_n
    if extra:
        x = torch.cat([x, torch.zeros((extra,) + rest, dtype=x.dtype,
                                      device=x.device)], dim=0)
    return x.reshape((-1, new_n) + rest).sum(dim=0)


class SimCluster:
    """Scenario-driven wrapper over the simulated-worker aggregation.

    `ckpt_dir` hosts the EF-rescale checkpoints (a temporary directory,
    removed with the cluster, when omitted). `accounting` holds one entry
    per priced step for the campaign's telemetry export.
    """

    def __init__(self, scenario: Scenario, cfg: CompressionConfig, *,
                 ckpt_dir: Optional[str] = None):
        self.scenario = scenario
        self.cfg = cfg
        self._ckpt_dir = ckpt_dir
        self.accounting: List[Dict] = []

    # ---- numerics plane: the bit-identical pass-through ------------------
    def aggregate(self, worker_grads, stacked, key, *, ef_state=None,
                  plan=None, schedule=None, telemetry_plan=None,
                  telemetry_entire_model=True, wire=False, faults=None,
                  alive=None):
        """EXACTLY aggregate_simulated_workers, the arguments passed
        straight through. `faults` (an `injector()`) corrupts the packed
        bytes each receiver decodes and `alive` (an `alive_mask(...)`)
        renormalizes the mean over surviving workers; both default to
        None, the bit-identical pass-through."""
        return aggregate_simulated_workers(
            worker_grads, stacked, self.cfg, key, ef_state=ef_state,
            plan=plan, schedule=schedule, telemetry_plan=telemetry_plan,
            telemetry_entire_model=telemetry_entire_model, wire=wire,
            faults=faults, alive=alive)

    # ---- wire plane: corruption injection + partial participation --------
    def injector(self, *, resend: bool = False):
        """The resil.FaultInjector realizing the scenario's
        CorruptionSpec, or None at identity (prob 0), so callers can hand
        it straight to `aggregate(faults=...)` and keep the fault-free
        path untouched."""
        spec = self.scenario.corruption
        if spec.is_identity():
            return None
        from repro_torch.resil import FaultInjector
        return FaultInjector(spec, resend=resend)

    def alive_mask(self, step: int, timeout_us: Optional[float]):
        """Partial participation under a straggler timeout: worker i is
        alive iff its straggler delay draw at `step` is within
        `timeout_us`. None (or everyone or no one timing out) returns
        None, full participation. numpy bools, decided on the host."""
        if timeout_us is None:
            return None
        n = self.scenario.world_size_at(step)
        delays = self.scenario.straggler.draws(step, n)
        alive = delays <= float(timeout_us)
        if not alive.any() or alive.all():
            return None
        return alive

    # ---- shape plane: elastic world size through ckpt/ -------------------
    @property
    def ckpt_dir(self) -> str:
        if self._ckpt_dir is None:
            self._ckpt_dir = tempfile.mkdtemp(prefix="simcluster_ef_")
            weakref.finalize(self, shutil.rmtree, self._ckpt_dir, True)
        return self._ckpt_dir

    def rescale_ef(self, ef_state, new_n: int, *, step: int = 0):
        """Re-bucket EF residuals onto `new_n` workers THROUGH a ckpt/
        round trip: save the (old_n, ...) state as a real checkpoint,
        restore it, then re-bucket rows. The round trip is lossless, so
        new_n == old_n returns a bit-identical state."""
        if ef_state is None:
            return None
        path = save_checkpoint(self.ckpt_dir, step, ef_state, tag="ef")
        _, restored = load_checkpoint(path, like=ef_state)
        return tree_map(lambda x: _rebucket_rows(x, new_n), restored)

    def maybe_rescale(self, step: int, ef_state):
        """Apply the scenario's rescale events due exactly at `step`.
        Returns (world_size, ef_state, changed)."""
        n = self.scenario.world_size_at(step)
        due = [ev for ev in self.scenario.rescales if ev.step == step]
        if not due:
            return n, ef_state, False
        prev = (self.scenario.world_size_at(step - 1) if step > 0
                else self.scenario.n_workers)
        if n == prev:
            return n, ef_state, False
        return n, self.rescale_ef(ef_state, n, step=step), True

    # ---- time plane: per-link alpha-beta pricing + straggler draws -------
    def link_fusion_bytes(self, plan: UnitPlan,
                          link: LinkSpec) -> Optional[float]:
        """The comm-schedule fusion threshold control.FusionPolicy picks
        for THIS link's alpha / beta (None = the config's own threshold,
        for non-layerwise plans where there is nothing to fuse)."""
        from repro_torch.control.policy import (CompressionDecision,
                                                FusionPolicy)
        decision = CompressionDecision.from_config(self.cfg)
        picked = FusionPolicy(alpha_us=link.alpha_us,
                              gbps=link.gbps).decide({}, decision, plan)
        return picked.fusion_bytes

    def step_accounting(self, step: int, plan: UnitPlan, *,
                        backward_us: Optional[float] = None,
                        compress_gbps: float = 25.0) -> Dict:
        """Price one step's communication under the scenario: each
        worker's wire through simulate_schedule at its link, fused at its
        FusionPolicy threshold, plus its straggler delay (exposed time);
        the step's exposed comm is the per-worker max. Appends and returns
        the accounting entry (model numbers, deterministic)."""
        n = self.scenario.world_size_at(step)
        delays = self.scenario.straggler.draws(step, n)
        workers = []
        for i in range(n):
            link = self.scenario.link(i)
            fb = self.link_fusion_bytes(plan, link)
            sched = build_schedule(plan, fb if fb is not None else 0.0)
            sim = simulate_schedule(sched, qw=self.cfg.qw,
                                    alpha_us=link.alpha_us, gbps=link.gbps,
                                    compress_gbps=compress_gbps,
                                    backward_us=backward_us)
            workers.append({
                "worker": i,
                "alpha_us": link.alpha_us,
                "gbps": link.gbps,
                "fusion_bytes": fb,
                "n_messages": sim["n_messages"],
                "t_total_us": sim["t_total_us"],
                "model_exposed_us": sim["exposed_comm_us"],
                "straggler_delay_us": float(delays[i]),
                "exposed_us": sim["exposed_comm_us"] + float(delays[i]),
            })
        entry = {
            "step": int(step),
            "world_size": n,
            "workers": workers,
            "exposed_comm_us": max(w["exposed_us"] for w in workers),
            "t_step_us": max(w["t_total_us"] + w["straggler_delay_us"]
                             for w in workers),
            "straggler_hits": int(sum(1 for d in delays if d > 0)),
        }
        self.accounting.append(entry)
        return entry

    def exposed_comm_total_us(self) -> float:
        return sum(e["exposed_comm_us"] for e in self.accounting)
