"""The fault-injected scenario campaign on the port (the JAX package's
benchmarks/scenarios.py, the same configs, scenarios, cells and report).

The paper's layer-wise vs entire-model verdict, re-asked under hostile
system conditions through the SimCluster harness (repro_torch.sim): for
each registry config x scenario x top-k ratio x granularity cell, train a
few steps of simulated-multi-worker compressed SGD (Algorithm 1 with
error feedback) while the scenario injects heterogeneous per-worker links
(each priced by the alpha-beta model at its own FusionPolicy threshold),
straggler delays, elastic world-size events (EF residuals re-bucketed
through a real checkpoint round trip, 4 -> 2 -> 4) and Dirichlet non-IID
shards. Per-step loss and exposed-comm telemetry flow through one
obs.MetricsRegistry a cell, whose snapshot is in the report. The verdict
of a (config, scenario, ratio) pair compares the final losses with a 2%
tie margin.

The CNN cells' init and data are the reference's draws; the LM cells'
inits are torch draws (ROADMAP Queue 3 item 3), so their losses are the
port's own. The report goes to chiprun_out/scenarios.json unless --out
says otherwise; it never rewrites the repository's BENCH_scenarios.json.

Run:  python -m repro_torch.scenarios [--device cpu] [--steps N]
      [--out PATH]
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import zlib
from pathlib import Path
from typing import Dict, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.configs.registry import get_smoke
from repro_torch.configs.resnet9_cifar import RESNET9
from repro_torch.convert import tree_leaves, tree_map
from repro_torch.core import (CompressionConfig, Granularity, build_plan,
                              make_compressor, stacked_mask)
from repro_torch.data import (dirichlet_proportions, make_markov,
                              noniid_classification_batch,
                              noniid_markov_lm_batch)
from repro_torch.models import DistConfig, Model
from repro_torch.models.cnn import cnn_loss, init_cnn
from repro_torch.obs import MetricsRegistry
from repro_torch.random import fold_in
from repro_torch.random import normal
from repro_torch.resil.recovery import runner_grads
from repro_torch.sim import (LinkSpec, RescaleEvent, Scenario, SimCluster,
                             StragglerSpec, init_ef)

STEPS = 16
RATIOS = (0.01, 0.25)          # the ratio ladder's hostile and mild ends
GLOBAL_BATCH = {"cnn": 32, "lm": 8}
SEQ = 16
LR = 0.02
TIE_MARGIN = 0.02

CONFIGS = ("resnet9", "mamba2-1.3b", "qwen3-moe-235b-a22b", "whisper-base")
OUT = Path(__file__).resolve().parents[2] / "chiprun_out" / "scenarios.json"


def scenarios_for(steps: int) -> Tuple[Scenario, ...]:
    """The reference's three scenarios, the elastic one's rescale events
    at a third and two thirds of `steps`."""
    return (
        Scenario(name="clean", n_workers=4),
        Scenario(
            name="hetero_straggler", n_workers=4,
            links=(LinkSpec(alpha_us=20.0, gbps=25.0),
                   LinkSpec(alpha_us=50.0, gbps=12.5),
                   LinkSpec(alpha_us=120.0, gbps=5.0),
                   LinkSpec(alpha_us=400.0, gbps=1.25)),
            straggler=StragglerSpec(prob=0.25, delay_us=5000.0, seed=7)),
        Scenario(
            name="elastic_noniid", n_workers=4,
            rescales=(RescaleEvent(step=max(1, steps // 3), world_size=2),
                      RescaleEvent(step=max(2, 2 * steps // 3),
                                   world_size=4)),
            dirichlet_alpha=0.3),
    )


SCENARIOS = scenarios_for(STEPS)


# ---- per-config runners: init / per-worker loss / skewed worker batches ------

class _CnnRunner:
    categories = 10
    global_batch = GLOBAL_BATCH["cnn"]

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)

    def init(self, key):
        return init_cnn(RESNET9, key, device=self.device)

    def loss(self, params, batch, key):
        return cnn_loss(RESNET9, params, batch)

    def worker_batch(self, key, props, per):
        return noniid_classification_batch(key, props, per,
                                           device=self.device)


class _LmRunner:
    global_batch = GLOBAL_BATCH["lm"]

    def __init__(self, arch, device="cuda"):
        self.device = resolve_device(device)
        self.cfg = get_smoke(arch)
        self.model = Model(self.cfg, DistConfig())
        self.categories = self.cfg.vocab
        self.trans = make_markov(self.cfg.vocab, seed=0, device="cpu")

    def init(self, key):
        return self.model.init(key, device=self.device)

    def loss(self, params, batch, key):
        return self.model.loss(params, batch, key)

    def worker_batch(self, key, props, per):
        b = noniid_markov_lm_batch(key, self.trans, props, per, SEQ,
                                   device=self.device)
        if self.cfg.arch_type == "audio":
            n = props.shape[0]
            b["frames"] = 0.02 * normal(
                fold_in(key, 0xF),
                (n, per, self.cfg.frontend_seq, self.cfg.d_model)
            ).to(self.device)
        return b


def _runner(config: str, device="cuda"):
    return (_CnnRunner(device) if config == "resnet9"
            else _LmRunner(config, device))


# ---- the campaign cell: one (config, scenario, ratio, granularity) run -------

def _step(runner, params, ef, wbatch, key, sm, cluster: SimCluster):
    """One Algorithm-1 step: each worker's gradient under fold_in(key, w),
    the scenario's aggregate under fold_in(key, 0xA) (error feedback),
    p - LR * g -> (params, ef, mean worker loss)."""
    n = next(iter(wbatch.values())).shape[0]
    wg, losses = runner_grads(runner, params, wbatch, key, n)
    g, ef = cluster.aggregate(wg, sm, fold_in(key, 0xA), ef_state=ef)
    params = tree_map(lambda p, u: p - LR * u, params, g)
    return params, ef, losses.mean()


def cell_key(text: str) -> torch.Tensor:
    """jax.random.key(zlib.crc32(text))'s key data, [0, crc] (crc32, not
    hash(): str hashes are salted per process)."""
    return torch.tensor([0, zlib.crc32(text.encode())], dtype=torch.int64)


def _run_cell(config: str, runner, scenario: Scenario, ratio: float,
              gran: str, steps: int) -> Dict:
    comp = CompressionConfig(qw=make_compressor("topk", ratio=ratio),
                             granularity=Granularity(gran),
                             error_feedback=True)
    cluster = SimCluster(scenario, comp)
    reg = MetricsRegistry()
    # the granularity is deliberately NOT in the key: the lw and em cells
    # of a verdict pair share init, shard proportions and batch draws
    key = cell_key(f"{config}|{scenario.name}|{ratio}")
    params = runner.init(key)
    dev = tree_leaves(params)[0].device
    sm = stacked_mask(params)
    plan = build_plan(params, sm, Granularity(gran))
    n_max = max([scenario.n_workers]
                + [ev.world_size for ev in scenario.rescales])
    alpha = scenario.dirichlet_alpha
    props_all = (dirichlet_proportions(fold_in(key, 0xD), n_max,
                                       runner.categories, alpha, device=dev)
                 if alpha is not None
                 else torch.full((n_max, runner.categories),
                                 1.0 / runner.categories, device=dev))
    n = scenario.n_workers
    ef = init_ef(params, n)
    losses = []
    for i in range(steps):
        n, ef, changed = cluster.maybe_rescale(i, ef)
        if changed:
            reg.inc("scenario/rescales")
        per = max(1, runner.global_batch // n)
        wbatch = runner.worker_batch(fold_in(key, 100 + i), props_all[:n],
                                     per)
        params, ef, loss = _step(runner, params, ef, wbatch,
                                 fold_in(key, 10_000 + i), sm, cluster)
        acct = cluster.step_accounting(i, plan)
        loss = float(loss)
        losses.append(loss)
        reg.observe("scenario/loss", loss)
        reg.observe("scenario/exposed_comm_us", acct["exposed_comm_us"])
        reg.observe("scenario/t_step_us", acct["t_step_us"])
        reg.inc("scenario/steps")
        reg.inc("scenario/straggler_hits", acct["straggler_hits"])
        reg.gauge("scenario/world_size", n)
        reg.record(step=i, config=config, scenario=scenario.name,
                   ratio=ratio, granularity=gran)
    tail = losses[-3:]
    return {
        "final_loss": round(sum(tail) / len(tail), 6),
        "first_loss": round(losses[0], 6),
        "loss_curve": [round(v, 4) for v in losses],
        "exposed_comm_total_us": round(cluster.exposed_comm_total_us(), 3),
        "exposed_comm_us_per_step": round(
            cluster.exposed_comm_total_us() / steps, 3),
        "straggler_hits": int(reg.counters["scenario/straggler_hits"]),
        "n_messages_worker0": cluster.accounting[0]["workers"][0][
            "n_messages"],
        "metrics": reg.snapshot(config=config, scenario=scenario.name,
                                ratio=ratio, granularity=gran),
    }


def _verdict(lw: Dict, em: Dict) -> str:
    """Which granularity converged lower, with the tie margin."""
    a, b = lw["final_loss"], em["final_loss"]
    if a < b * (1.0 - TIE_MARGIN):
        return "layerwise"
    if b < a * (1.0 - TIE_MARGIN):
        return "entire_model"
    return "tie"


def scenarios(out_path=None, *, steps: int = STEPS, device="cuda",
              configs=CONFIGS, ratios=RATIOS):
    """Run the campaign and write its report (the reference's keys, plus
    each config's and the whole run's wall seconds) -> the report."""
    dev = resolve_device(device)
    scens = scenarios_for(steps)
    report = {"steps": steps, "ratios": list(ratios), "lr": LR,
              "tie_margin": TIE_MARGIN,
              "scenarios": {s.name: s.describe() for s in scens},
              "configs": {}, "device": str(dev), "seconds": {}}
    t_all = time.perf_counter()
    for config in configs:
        t0 = time.perf_counter()
        runner = _runner(config, dev)
        centry = {}
        for sc in scens:
            sentry = {}
            for ratio in ratios:
                lw = _run_cell(config, runner, sc, ratio, "layerwise", steps)
                em = _run_cell(config, runner, sc, ratio, "entire_model",
                               steps)
                cell = {"layerwise": lw, "entire_model": em,
                        "verdict": _verdict(lw, em)}
                sentry[f"ratio_{ratio}"] = cell
                print(f"{config:24s} {sc.name:18s} r={ratio:<5} "
                      f"lw={lw['final_loss']:.4f} "
                      f"em={em['final_loss']:.4f} "
                      f"verdict={cell['verdict']}", flush=True)
            centry[sc.name] = sentry
        report["configs"][config] = centry
        report["seconds"][config] = time.perf_counter() - t0
    report["seconds"]["total"] = time.perf_counter() - t_all
    path = Path(out_path) if out_path else OUT
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(report, indent=2, sort_keys=True))
    print(f"wrote {path} ({report['seconds']['total']:.1f} s)", flush=True)
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--out", default=None,
                    help=f"report path (default {OUT})")
    args = ap.parse_args(argv)
    scenarios(args.out, steps=args.steps, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
