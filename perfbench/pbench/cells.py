"""Finds a cell's files by name. Everything that belongs to one cell,
configuration, traffic mix or per-layer metric is a file of its own:

  perfbench/workloads/<cell>.json    {"config", "traffic", "limits"}
  perfbench/configs/<config>.json    the model's sizes as run, its
                                     `family` and source
  perfbench/traffic/<traffic>.json   the traffic generator's parameters
  perfbench/metrics/<metric>.py      a reader: read(ctx) -> number or None
  perfbench/pbench/ref_<family>.py   the family's plain reference

BENCHMARK.json at the checkout's root says which metrics each cell
reports.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, NamedTuple

HERE = Path(__file__).resolve().parents[1]          # perfbench/
ROOT = HERE.parent
BENCHMARK = ROOT / "BENCHMARK.json"


class Cell(NamedTuple):
    name: str
    config: dict
    traffic: dict
    limits: Dict[str, float]
    family: object


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def config(name: str) -> dict:
    return _json(HERE / "configs" / f"{name}.json")


def traffic(name: str) -> dict:
    return _json(HERE / "traffic" / f"{name}.json")


def family(name: str):
    return importlib.import_module(f"pbench.ref_{name}")


def load(name: str) -> Cell:
    w = _json(HERE / "workloads" / f"{name}.json")
    c = config(w["config"])
    return Cell(name, c, traffic(w["traffic"]), w["limits"],
                family(c["family"]))


def benchmark() -> dict:
    return _json(BENCHMARK)


def metrics_of(cell: str, kind: str, bench: dict = None) -> List[dict]:
    """The `end_to_end` or `per_layer` metrics BENCHMARK.json gives the
    cell: those without `workloads` and those that list it."""
    bench = benchmark() if bench is None else bench
    return [m for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]]


def reader(metric: str) -> Callable:
    """perfbench/metrics/<metric>.py's read(ctx)."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "pbench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
