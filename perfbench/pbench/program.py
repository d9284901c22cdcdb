"""The system under test: the port's Algorithm-1 training step,
`repro_torch.experiment.lm_train_step`, driven with the cell's model,
compressor and granularity. The only module of the benchmark that
imports the program; it hands the program what the benchmark made
(weights, rows, keys) and takes back its parameters and losses.

`Spans` wraps the two module attributes lm_train_step looks up,
`experiment.lm_worker_grads` and `experiment.aggregate_simulated_workers`,
with CUDA-event timers (and, for the first steps, a capture of the
aggregated gradient the update receives); `restore()` puts them back.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch


def _nested(flat: Dict[str, torch.Tensor]) -> dict:
    out: dict = {}
    for path, t in flat.items():
        node = out
        keys = path.split("/")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = t
    return out


def flatten(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """A nested dict of tensors -> {"a/b": tensor}."""
    out = {}
    for k, v in tree.items():
        p = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten(v, p + "/"))
        else:
            out[p] = v
    return out


class Program:
    """The port's model and compression configuration for one cell."""

    def __init__(self, fields: dict, leaves: dict, traffic: dict, device):
        from repro_torch import experiment
        from repro_torch.core.aggregation import CompressionConfig
        from repro_torch.core.compressors import make_compressor
        from repro_torch.core.granularity import Granularity
        from repro_torch.models.config import ModelConfig
        from repro_torch.models.dist import DistConfig
        from repro_torch.models.model import Model
        self.experiment = experiment
        self.device = torch.device(device)
        cfg = ModelConfig(name="perfbench", **fields)
        self.model = Model(cfg, DistConfig())
        shapes = {p: tuple(t.shape) for p, t in
                  flatten(self.model.param_shapes()).items()}
        want = {p: tuple(l.shape) for p, l in leaves.items()}
        if shapes != want:
            raise RuntimeError(f"the program's parameters {shapes} are not "
                               f"the reference's {want}")
        comp = dict(traffic["compressor"])
        self.comp = CompressionConfig(
            qw=make_compressor(comp.pop("name"), **comp),
            granularity=Granularity(traffic["granularity"]))
        self.workers = traffic["workers"]
        self.lr = float(traffic["lr"])
        self.wire = bool(traffic["wire"])

    @staticmethod
    def build_kernels() -> float:
        """Build (or find built) the program's CUDA libraries."""
        from repro_torch.kernels import build
        return build.build_all()

    def tree(self, flat: Dict[str, torch.Tensor]) -> dict:
        return _nested(flat)

    def step(self, tree: dict, batch: dict, key: torch.Tensor):
        """One timed-path step -> (new params, mean worker loss)."""
        return self.experiment.lm_train_step(
            self.model, self.comp, tree, batch, key, self.lr,
            workers=self.workers, wire=self.wire)


class Spans:
    """CUDA-event spans around the program's worker gradients and its
    aggregation, and the capture of the first aggregate."""

    def __init__(self, program: Program, timed: bool):
        self.exp = program.experiment
        self.timed = timed
        self.capture = False
        self.captured: Optional[Dict[str, torch.Tensor]] = None
        self.events: Dict[str, List] = {"grads": [], "aggregate": []}
        self._orig = {"lm_worker_grads": self.exp.lm_worker_grads,
                      "aggregate_simulated_workers":
                      self.exp.aggregate_simulated_workers}
        self.exp.lm_worker_grads = self._wrap("lm_worker_grads", "grads")
        self.exp.aggregate_simulated_workers = self._wrap(
            "aggregate_simulated_workers", "aggregate")

    def _wrap(self, attr: str, span: str):
        orig = self._orig[attr]

        def wrapped(*args, **kwargs):
            if not self.timed:
                out = orig(*args, **kwargs)
            else:
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                with torch.profiler.record_function(f"pb.{span}"):
                    a.record()
                    out = orig(*args, **kwargs)
                    b.record()
                self.events[span].append((a, b))
            if span == "aggregate" and self.capture:
                self.captured = {p: t.detach().to("cpu") for p, t in
                                 flatten(out[0]).items()}
                self.capture = False
            return out
        return wrapped

    def ms(self, span: str) -> List[float]:
        return [a.elapsed_time(b) for a, b in self.events[span]]

    def restore(self) -> None:
        for attr, fn in self._orig.items():
            setattr(self.exp, attr, fn)
