"""Smoke-size cells for the CPU tests: a cell of BENCHMARK.json with its
model cut to a few channels and its sequence shortened, everything else
(traffic, compressor, granularity, limits) as the cell has it."""
import sys
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE.parent / "src"))

from pbench import cells  # noqa: E402

SMOKE = {"dense": dict(hidden_size=32, intermediate_size=64,
                       num_attention_heads=2, num_key_value_heads=1,
                       head_dim=16, vocab_size=128),
         "mamba2": dict(d_model=32, n_layer=2, vocab_size=128, d_state=8,
                        headdim=8, norm_group_size=8, chunk_size=4)}
SEQ = 8


def smoke_cell(name: str, dtype: str = "float32", config: str = None,
               traffic: str = None) -> cells.Cell:
    """The cell `name` at smoke size (or, with `config` / `traffic`, a
    cell of those files under `name`'s limits)."""
    full = cells.load(name)
    c = cells.config(config) if config else dict(full.config)
    c.update(SMOKE[c["family"]], dtype=dtype)
    tr = cells.traffic(traffic) if traffic else dict(full.traffic)
    tr.update(seq=SEQ)
    return cells.Cell(name, c, tr, full.limits, cells.family(c["family"]))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Tiny tensors: one intra-op thread, restored after the module (the
    test run's workers share the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
