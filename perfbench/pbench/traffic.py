"""The one generator of training traffic: a traffic file's rows of
uniform random tokens (targets the next token), made on the device from
the run's seed, and the step keys.

A traffic file (perfbench/traffic/<name>.json) holds: `source` (where
its sizes come from), `workers` (simulated workers a step),
`rows_per_worker` and `seq` (each worker's share of a step's rows, of
`seq` tokens), `pool` (distinct batches made at set-up, cycled through
by the steps), `compressor` ({"name", and its fields}), `granularity`,
`lr`, `wire` and `checked_steps` (the first steps, which the plain
reference repeats). Uniform tokens are the
program's own stand-in at a full-width vocabulary (a Markov chain over
200,064 tokens would need a 160 GB matrix).
"""
from __future__ import annotations

from typing import Dict, List

import torch

from pbench.keys import base_key, fold_in

# a stream apart from the weights' for the rows
_ROWS_FOLD = 1
# step keys made at set-up; no window runs more steps
MAX_STEPS = 8192


def rows(traffic: dict) -> int:
    return traffic["workers"] * traffic["rows_per_worker"]


def tokens_per_step(traffic: dict) -> int:
    return rows(traffic) * traffic["seq"]


def batches(traffic: dict, vocab: int, seed: int,
            device) -> List[Dict[str, torch.Tensor]]:
    """`pool` batches of (rows, seq) tokens and their targets."""
    k = fold_in(base_key(seed), _ROWS_FOLD).tolist()
    g = torch.Generator(device=device)
    g.manual_seed(((k[0] << 32) | k[1]) & ((1 << 63) - 1))
    s = torch.randint(0, vocab, (traffic["pool"], rows(traffic),
                                 traffic["seq"] + 1), generator=g,
                      device=device)
    return [{"tokens": b[:, :-1], "targets": b[:, 1:]} for b in s]


def step_keys(seed: int, n: int = MAX_STEPS) -> torch.Tensor:
    """(n, 2) keys: step i's is fold_in(fold_in(key(seed), 2), i)."""
    return fold_in(fold_in(base_key(seed), 2)[None], torch.arange(n))
