#!/usr/bin/env python3
"""The program's own witness of a configuration's gradient: its loss and
gradient in the configuration's dtype against the same program in
float32, on one worker's rows of the traffic's first batch, from the
seed's weights. One JSON line a seed, with each leaf's
||g - g_f32|| / ||g_f32||:

    python3 perfbench/witness.py --config mamba2-1.3b \
        --traffic qsgd16-layerwise-w4x2x2048 --seeds 11,12,13

A sound low-precision path reads a few percent on every leaf; a leaf near
100% or above has a gradient no better than one of another direction.
The benchmark's own runs never run this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE.parent / "src"))


def witness(config: dict, traffic: dict, seed: int, dev) -> dict:
    """{"loss" {dtype: loss}, "rel_err" {leaf: relative error}}."""
    import torch
    from pbench import cells, harness, traffic as traffic_mod
    from pbench.program import _nested
    from pbench.ref_step import make_params
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.dist import DistConfig
    from repro_torch.models.model import Model
    fam = cells.family(config["family"])
    lv = fam.leaves(config)
    P = make_params(lv, seed, harness.DTYPES[config["dtype"]], dev)
    b = traffic_mod.batches(traffic, config["vocab_size"], seed, dev)[0]
    rows = traffic["rows_per_worker"]
    batch = {"tokens": b["tokens"][:rows], "targets": b["targets"][:rows]}
    loss, grads = {}, {}
    for dt in (config["dtype"], "float32"):
        model = Model(ModelConfig(name="witness", **fam.program_fields(
            dict(config, dtype=dt))), DistConfig())
        leaves = {k: v.to(harness.DTYPES[dt]).requires_grad_(True)
                  for k, v in P.items()}
        l = model.loss(_nested(leaves), batch, None)
        g = torch.autograd.grad(l, list(leaves.values()))
        loss[dt] = float(l.detach())
        grads[dt] = {k: t.float() for k, t in zip(leaves, g)}
        del model, leaves, l, g
        harness._free()
    lo, hi = grads[config["dtype"]], grads["float32"]
    return {"loss": loss, "rel_err": {
        k: float((lo[k] - hi[k]).norm() / hi[k].norm().clamp_min(1e-30))
        for k in hi}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    import torch
    from pbench import cells, harness
    if not torch.cuda.is_available():
        print("witness.py: no CUDA device", file=sys.stderr)
        return 3
    harness.full_precision()
    config, traffic = cells.config(args.config), cells.traffic(args.traffic)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.monotonic()
        out = witness(config, traffic, seed, torch.device("cuda", 0))
        print(json.dumps({"config": args.config, "traffic": args.traffic,
                          "seed": seed, **out,
                          "seconds": time.monotonic() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
