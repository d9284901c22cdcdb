"""Step analysis: collective-byte parsing and the three-term roofline
(compute / memory / collective) of the dry run (the JAX package's
launch/analysis.py, its field names and JSON schema).

Hardware model: one NVIDIA H100 SXM5 80GB, from NVIDIA's H100 Tensor Core
GPU data sheet (the SXM5 column):
  peak bf16        989 TFLOP/s dense (the sheet's 1,979 is with sparsity)
  HBM3 bandwidth   3.35 TB/s
  NVLink 4         900 GB/s a GPU in total, 450 GB/s each way

ICI_BW, the reference's per-link ICI rate, stands for NVLink's 450 GB/s
each way: the wire model (hlo_cost._wire_bytes) counts the bytes one device
sends, and a GPU sends at most half of its 900 GB/s total. A 16-wide model
axis spans two 8-GPU NVLink domains; one link rate cannot show that (the
roofline does not model it).

The port has no compiled artifact: `analyze_step` takes a
hlo_cost.StepCost that counted one rank's step (the dry run's, on meta
tensors) where the reference's analyze_compiled reads XLA's.
"""
from __future__ import annotations

import dataclasses
import json
import re
from typing import Dict, Optional

from repro_torch.launch.hlo_cost import COLLECTIVES, _shape_bytes

PEAK_FLOPS = 989e12       # H100 SXM5 dense BF16 Tensor Core (data sheet)
HBM_BW = 3.35e12          # H100 SXM5 HBM3 (data sheet)
ICI_BW = 450e9            # NVLink 4: 900 GB/s a GPU, 450 GB/s each way
CARD_BYTES = 80e9         # H100 SXM5 memory (data sheet), --device cpu


def collective_bytes(hlo_text: str) -> Dict[str, int]:
    """Per-op-kind result bytes of every collective in (per-device) HLO.

    We take the RESULT shape as the wire proxy: for all-reduce it equals the
    payload; for all-gather it is the received total; for reduce-scatter the
    sent total is result x n (we report result — conservative).
    'xxx-start' variants (async) are counted; '-done' are not.
    """
    out = {k: 0 for k in COLLECTIVES}
    for line in hlo_text.splitlines():
        s = line.strip()
        if "fusion" in s.split("=")[0]:
            continue
        m = re.match(r"%?[\w.\-]+ = (.+?) (" + "|".join(COLLECTIVES) +
                     r")(-start)?\(", s)
        if m:
            out[m.group(2)] += _shape_bytes(m.group(1))
    return out


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops_per_device: float
    hlo_bytes_per_device: float
    collective_bytes_per_device: float
    collective_breakdown: Dict[str, float]
    model_flops_global: float
    memory_per_device: Dict[str, float]
    raw_cost_analysis: Optional[Dict[str, float]] = None

    @property
    def t_compute(self) -> float:
        return self.hlo_flops_per_device / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes_per_device / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.collective_bytes_per_device / ICI_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        total = self.hlo_flops_per_device * self.chips
        return self.model_flops_global / total if total else 0.0

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d.update(t_compute=self.t_compute, t_memory=self.t_memory,
                 t_collective=self.t_collective, bottleneck=self.bottleneck,
                 useful_flops_ratio=self.useful_flops_ratio)
        return d


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS per step: 6·N·D train, 2·N·D forward (N = active params,
    D = tokens processed globally)."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch  # decode: one token per sequence


def analyze_step(cost, *, arch: str, shape, mesh_name: str, chips: int,
                 cfg) -> Roofline:
    """The Roofline of one rank's step counted by `cost` (a
    hlo_cost.StepCost that ran over it): its flops, HBM-model bytes and
    collectives per device, and its memory_analysis() as the memory per
    device. raw_cost_analysis holds the same counts (the port has no
    separate, loop-unscaled XLA count)."""
    sc = cost.costs()
    return Roofline(
        arch=arch, shape=shape.name, mesh=mesh_name, chips=chips,
        hlo_flops_per_device=sc["flops"], hlo_bytes_per_device=sc["bytes"],
        collective_bytes_per_device=sum(sc["collectives"].values()),
        collective_breakdown=sc["collectives"],
        model_flops_global=model_flops(cfg, shape),
        memory_per_device=cost.memory_analysis(),
        raw_cost_analysis={"flops": sc["flops"],
                           "bytes_accessed": sc["bytes"]})


def save_roofline(r: Roofline, path: str):
    with open(path, "w") as f:
        json.dump(r.to_dict(), f, indent=2)
