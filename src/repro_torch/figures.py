"""One benchmark per paper figure (Figures 2-8): layer-wise vs entire-model
test accuracy for each compression method, on the port (the JAX package's
benchmarks/figures.py, same rows and CSV).

Each fig*() prints CSV rows  name,us_per_call,derived  where us_per_call
is the wall time per training step (each row trains three runs:
layer-wise, entire-model and the dense baseline) and `derived` carries
the accuracies: layerwise|entire_model|baseline. Every fig*() takes
`steps` (default STEPS, read at call time) and `device` (default "cuda");
compressed aggregation goes through the wire kernels wherever the codec
is sim-exact (experiment.train_step).

`fig_scenarios(path)` renders the scenario campaign's report
(repro_torch/scenarios.py; chiprun_out/scenarios.json by default) as the
reference's CSV rows, one a (config, scenario, ratio) cell.

Run:  python -m repro_torch.figures [--quick] [--device cpu]
"""
from __future__ import annotations

import argparse
import sys
import time

from repro_torch.core import CompressionConfig, Granularity, make_compressor
from repro_torch.experiment import (compare_granularities, csv_line,
                                    train_cnn_ef)

STEPS = 100


def _run(tag, model, qname, steps=None, device="cuda", nesterov=False,
         **qkw):
    steps = STEPS if steps is None else steps
    t0 = time.time()
    r = compare_granularities(model, qname, steps=steps, nesterov=nesterov,
                              device=device, **qkw)
    us = (time.time() - t0) / (3 * steps) * 1e6
    csv_line(tag, us,
             f"lw={r['layerwise']:.3f}|em={r['entire_model']:.3f}"
             f"|base={r['baseline']:.3f}")
    return r


def fig2_randomk(steps=None, device="cuda"):
    """Fig 2: Random-k on AlexNet/ResNet-9 across ratios."""
    for model in ("mlp", "resnet9"):
        for ratio in (0.01, 0.1, 0.5):
            _run(f"fig2_randomk_{model}_r{ratio}", model, "randomk", steps,
                 device, ratio=ratio)


def fig3_terngrad(steps=None, device="cuda"):
    """Fig 3: TernGrad — per-layer scale beats the single global scale."""
    for model in ("mlp", "resnet9"):
        _run(f"fig3_terngrad_{model}", model, "terngrad", steps, device)


def fig4_qsgd(steps=None, device="cuda"):
    """Fig 4: QSGD (norm per unit)."""
    for model in ("mlp", "resnet9"):
        _run(f"fig4_qsgd_{model}", model, "qsgd", steps, device, levels=4)


def fig5_adaptive(steps=None, device="cuda"):
    """Fig 5: Adaptive Threshold (per-unit max-based threshold)."""
    for model in ("mlp", "resnet9"):
        _run(f"fig5_adaptive_{model}", model, "adaptive_threshold", steps,
             device, alpha=0.05)


def fig6_threshold(steps=None, device="cuda"):
    """Fig 6: Threshold-v — granularity-insensitive by construction."""
    for v in (1e-4, 1e-3, 1e-2):
        _run(f"fig6_threshold_resnet9_v{v}", "resnet9", "threshold_v",
             steps, device, v=v)


def fig7_topk(steps=None, device="cuda"):
    """Fig 7(a,b): Top-k across ratios; Fig 7(c): + Nesterov momentum."""
    for model in ("mlp", "resnet9"):
        for ratio in (0.001, 0.01, 0.1):
            _run(f"fig7_topk_{model}_r{ratio}", model, "topk", steps,
                 device, ratio=ratio)
    _run("fig7c_topk_resnet9_nesterov_r0.01", "resnet9", "topk", steps,
         device, ratio=0.01, nesterov=True)


def fig8_topk_large(steps=None, device="cuda"):
    """Fig 8 proxy: the paper's 'larger/deeper models favor layer-wise'
    finding — AlexNet-style net (more layers than the MLP) at small k."""
    _run("fig8_topk_alexnet_r0.001", "alexnet", "topk", steps, device,
         ratio=0.001)
    _run("fig8_topk_alexnet_r0.01", "alexnet", "topk", steps, device,
         ratio=0.01)


def ef_beyond_paper(steps=None, device="cuda"):
    """Beyond-paper: error feedback at aggressive Top-k 0.1% — the EF
    memory re-injects dropped coordinates (not in the paper's design).
    Plain SGD (EF composes poorly with heavyball momentum — a known
    interaction, reported as-is)."""
    steps = STEPS if steps is None else steps
    for ef in (False, True):
        comp = CompressionConfig(qw=make_compressor("topk", ratio=0.001),
                                 granularity=Granularity("layerwise"),
                                 error_feedback=ef)
        t0 = time.time()
        acc, _ = train_cnn_ef("resnet9", comp, steps=steps, device=device)
        csv_line(f"beyond_ef_topk0.001_resnet9_ef{int(ef)}",
                 (time.time() - t0) / steps * 1e6, f"acc={acc:.3f}")


def fig_scenarios(path=None):
    """Paper-style rendering of the scenario campaign: one CSV row per
    (config, scenario, ratio) cell of the port's campaign report, the
    layer-wise / entire-model final losses, each granularity's exposed
    comm a step and the cell's verdict (the reference's rows); the t_us
    column carries the layer-wise exposed comm."""
    import json
    from repro_torch.scenarios import OUT
    with open(OUT if path is None else path) as f:
        report = json.load(f)
    for config, scenarios_ in sorted(report["configs"].items()):
        for sname, cells in sorted(scenarios_.items()):
            for rkey, cell in sorted(cells.items()):
                lw, em = cell["layerwise"], cell["entire_model"]
                csv_line(
                    f"scenario_{config}_{sname}_{rkey}",
                    lw["exposed_comm_us_per_step"],
                    f"lw={lw['final_loss']:.4f}"
                    f"|em={em['final_loss']:.4f}"
                    f"|em_exposed_us={em['exposed_comm_us_per_step']:.1f}"
                    f"|verdict={cell['verdict']}")


ALL = [fig2_randomk, fig3_terngrad, fig4_qsgd, fig5_adaptive, fig6_threshold,
       fig7_topk, fig8_topk_large, ef_beyond_paper]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--quick", action="store_true",
                    help="30 steps per run instead of STEPS")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    steps = 30 if args.quick else STEPS
    print("name,us_per_call,derived", flush=True)
    for fig in ALL:
        fig(steps, args.device)
        sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
