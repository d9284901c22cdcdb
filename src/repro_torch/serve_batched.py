"""Batched serving on the port (the JAX package's
examples/serve_batched.py): prefill a batch of prompts, then decode new
tokens greedily with the sequence-sharded KV cache on a (data, model)
mesh of rank processes, through the Engine's prefill and serve steps.
Rank 0 prints.

Run:  python -m repro_torch.serve_batched [--gen 12] [--data 4]
          [--model 2] [--device cpu]
The prompts are uniform tokens from a torch.Generator (not the
reference's draws).
"""
from __future__ import annotations

import argparse
import sys

import torch

from repro_torch import random as R
from repro_torch.launch.engine import Engine
from repro_torch.launch.mesh import make_host_mesh, run_ranks
from repro_torch.launch.serve import generate
from repro_torch.models import ModelConfig

CFG = ModelConfig(name="serve-lm", arch_type="dense", n_layers=4,
                  d_model=128, vocab=512, n_heads=8, n_kv_heads=2,
                  d_head=16, d_ff=256, dtype="float32")
BATCH, PROMPT = 8, 24


def _rank(rank, n, dev, args):
    say = print if rank == 0 else (lambda *a, **k: None)
    eng = Engine(CFG, make_host_mesh(data=args.data, model=args.model),
                 device=dev)
    params, _ = eng.init_state(seed=1)
    g = R.generator(R.key(0))
    prompts = torch.randint(0, CFG.vocab, (BATCH, PROMPT), generator=g)
    res = generate(eng.model, params, {"tokens": prompts.to(dev)},
                   args.gen + 1, engine=eng)
    gen = eng.gather_rows(res["tokens"]).cpu()
    say("prompts:", prompts[:2].tolist())
    say("generated continuations:", gen[:2].tolist())
    say(f"served {BATCH} sequences x {args.gen} tokens on {n} ranks "
        f"(seq-sharded KV cache)", flush=True)
    return gen.numpy()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--gen", type=int, default=12)
    ap.add_argument("--data", type=int, default=4)
    ap.add_argument("--model", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default="gloo", choices=["gloo", "nccl"])
    args = ap.parse_args(argv)
    run_ranks(_rank, args.data * args.model, backend=args.backend,
              device=args.device, args=(args,), timeout=3600.0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
