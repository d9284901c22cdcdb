"""End-to-end training on the port (the JAX package's
examples/train_lm_distributed.py): train a small LM with compressed
communication on a (data, model) mesh of rank processes through the
Engine, top-k(5%) layer-wise over the allgather strategy, Nesterov
momentum with a warmup-then-decay schedule. Rank 0 prints.

Run:  python -m repro_torch.train_lm_distributed [--steps 300]
          [--data 4] [--model 2] [--device cpu]
On the card the ranks share cuda:0 over gloo unless --backend nccl (one
card a rank).
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.convert import tree_leaves
from repro_torch.core import CompressionConfig, Granularity, make_compressor
from repro_torch.data import lm_batches
from repro_torch.launch.engine import Engine
from repro_torch.launch.mesh import make_host_mesh, run_ranks
from repro_torch.models import ModelConfig
from repro_torch.optim import OptConfig, piecewise_linear

CFG = ModelConfig(name="lm-8m", arch_type="dense", n_layers=4, d_model=256,
                  vocab=2048, n_heads=8, n_kv_heads=4, d_head=32, d_ff=512,
                  dtype="float32")


def _rank(rank, n, dev, args):
    say = print if rank == 0 else (lambda *a, **k: None)
    comp = CompressionConfig(qw=make_compressor("topk", ratio=0.05),
                             granularity=Granularity("layerwise"),
                             strategy="allgather")
    eng = Engine(CFG, make_host_mesh(data=args.data, model=args.model),
                 comp=comp, opt=OptConfig(name="momentum", lr=0.3,
                                          nesterov=True), device=dev)
    step = eng.build_train_step(piecewise_linear(0.3, args.steps,
                                                 max(1, args.steps // 10)))
    params, opt_state = eng.init_state()
    n_params = sum(x.numel() for x in tree_leaves(eng.model.param_shapes()))
    say(f"{CFG.name}: {n_params/1e6:.1f}M params on mesh {dict(eng.sizes)}; "
        f"wire strategy={comp.strategy} (payload actually shrinks)",
        flush=True)
    data = lm_batches(CFG.vocab, args.batch, args.seq, seed=0, device="cpu")
    losses = []
    for i in range(args.steps):
        batch = {k: v.to(dev) for k, v in next(data).items()}
        params, opt_state, m = step(params, opt_state, batch, i)
        losses.append(float(m["loss"]))
        if i % 25 == 0 or i == args.steps - 1:
            say(f"step {i:4d}  loss {losses[-1]:.4f}  "
                f"lr {float(m['lr']):.3f}", flush=True)
    return losses


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--data", type=int, default=4)
    ap.add_argument("--model", type=int, default=2)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default="gloo", choices=["gloo", "nccl"])
    args = ap.parse_args(argv)
    run_ranks(_rank, args.data * args.model, backend=args.backend,
              device=args.device, args=(args,), timeout=3600.0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
