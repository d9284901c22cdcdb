"""One run of one cell: set-up, the first steps that the reference
repeats, the measured window, the traced steps, and the comparison.

Set-up builds the program's step once (its model, compressor and
granularity), makes the weights and a pool of row batches on the device
from the seed, and drives the step through the cell's checked steps:
those are the warm-up, through the window's own call and feed, and their
losses, the first aggregated gradient and the parameters' change are
kept for the comparison. The window then drives the same step object
back to back for `seconds`, a CUDA event recorded after each call and
nothing synchronised until its end. Once the window has closed and the
peak memory is read, the program's state is freed and the plain
reference repeats the checked steps.
"""
from __future__ import annotations

import gc
import time
from typing import Dict, List, Optional

import torch

from pbench import check, peaks, traffic as traffic_mod
from pbench.cells import Cell, metrics_of, reader
from pbench.program import Program, Spans, flatten
from pbench.ref_common import plain_matmul
from pbench.ref_step import make_params, step as ref_step
from pbench.tracing import profile_steps

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# steps traced after the window of a --trace 1 run: on the device alone,
# then with the host's operations (to name the idle gaps)
PROFILE_STEPS = 3
NAMED_STEPS = 1
# step-end events made before the window, more made only past them
EVENTS = 1024
# the compressor whose work each roofline's kernels carry
ROOFLINE_COMPRESSOR = {"qsgd_pack": "qsgd", "qsgd_unpack": "qsgd",
                       "fields_pack": "topk", "fields_unpack": "topk"}


def full_precision() -> None:
    """Full-precision f32 and bf16 products on the card (no TF32, no
    reduced-precision bf16 reductions), as the program's LM training
    entry sets them."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def _free() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def change_norms(tree_flat: Dict[str, torch.Tensor], leaves, seed: int,
                 dtype, dev) -> Dict[str, float]:
    """||p - p_0|| a leaf, p_0 the seed's weights made anew."""
    p0 = make_params(leaves, seed, dtype, dev)
    out = {p: float(torch.linalg.vector_norm(
        tree_flat[p].float() - p0[p].float())) for p in p0}
    del p0
    return out


class Run:
    """The program's side of one run of `cell`."""

    def __init__(self, cell: Cell, seed: int, dev):
        self.cell, self.seed, self.dev = cell, seed, torch.device(dev)
        c, tr = cell.config, cell.traffic
        self.leaves = cell.family.leaves(c)
        self.dtype = DTYPES[c["dtype"]]
        self.program = Program(cell.family.program_fields(c), self.leaves,
                               tr, self.dev)
        if self.dev.type == "cuda":
            self.program.build_kernels()
        self.tree = self.program.tree(make_params(self.leaves, seed,
                                                  self.dtype, self.dev))
        self.batches = traffic_mod.batches(tr, c["vocab_size"], seed,
                                           self.dev)
        self.keys = traffic_mod.step_keys(seed)
        self.i = 0

    def step(self):
        tr = self.cell.traffic
        self.tree, loss = self.program.step(
            self.tree, self.batches[self.i % tr["pool"]], self.keys[self.i])
        self.i += 1
        return loss

    def checked(self) -> dict:
        """The checked steps -> {"losses", "g" (the first aggregate, on the
        host), "change" (||p_k - p_0|| a leaf)}."""
        spans = Spans(self.program, timed=False)
        spans.capture = True
        try:
            losses = [self.step() for _ in range(
                self.cell.traffic["checked_steps"])]
        finally:
            spans.restore()
        flat = flatten(self.tree)
        return {"losses": [float(l) for l in losses], "g": spans.captured,
                "change": change_norms(flat, self.leaves, self.seed,
                                       self.dtype, self.dev)}

    def window(self, seconds: float) -> dict:
        """Steps back to back for `seconds` -> {"steps", "window_s",
        "step_ms" (event-timed, a step), "nonfinite"}. The collector is
        off and the step-end events are made beforehand, so that the host
        does the program's work alone."""
        dev = self.dev
        start = torch.cuda.Event(enable_timing=True)
        ends = [torch.cuda.Event(enable_timing=True) for _ in range(EVENTS)]
        bad = torch.zeros((), dtype=torch.int64, device=dev)
        n = 0
        gc.collect()
        gc.freeze()
        gc.disable()
        try:
            torch.cuda.synchronize(dev)
            t0 = time.monotonic()
            start.record()
            while True:
                loss = self.step()
                if n == len(ends):
                    ends.append(torch.cuda.Event(enable_timing=True))
                ends[n].record()
                n += 1
                bad += (~torch.isfinite(loss)).to(torch.int64)
                if time.monotonic() - t0 >= seconds:
                    break
            torch.cuda.synchronize(dev)
            window_s = time.monotonic() - t0
        finally:
            gc.enable()
            gc.unfreeze()
        marks = [start] + ends[:n]
        step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
        return {"steps": n, "window_s": window_s,
                "step_ms": step_ms, "nonfinite": int(bad)}

    def close(self) -> None:
        del self.tree, self.batches, self.program
        _free()


def reference(cell: Cell, seed: int, dev, mm=plain_matmul) -> dict:
    """The plain reference's checked steps from the seed's weights, rows
    and keys -> {"losses", "g" (first aggregate, f32), "change"}."""
    c, tr = cell.config, cell.traffic
    leaves = cell.family.leaves(c)
    dtype = DTYPES[c["dtype"]]
    params = make_params(leaves, seed, dtype, dev)
    batches = traffic_mod.batches(tr, c["vocab_size"], seed, dev)
    keys = traffic_mod.step_keys(seed, tr["checked_steps"])
    losses, g1 = [], None
    for i in range(tr["checked_steps"]):
        b = batches[i % tr["pool"]]
        loss, g, params = ref_step(cell.family, c, leaves, params,
                                   b["tokens"], b["targets"], keys[i], tr,
                                   mm)
        losses.append(loss)
        if g1 is None:
            g1 = {p: t.clone() for p, t in g.items()}
        del g
    del batches
    change = change_norms(params, leaves, seed, dtype, dev)
    return {"losses": losses, "g": g1, "change": change}


def compare(cell: Cell, prog: dict, ref: dict) -> Dict[str, float]:
    return check.numbers(prog["losses"], ref["losses"], prog["g"], ref["g"],
                         prog["change"], ref["change"])


def flops_per_step(cell: Cell) -> float:
    tr = cell.traffic
    return (cell.family.flops_per_token(cell.config, tr["seq"])
            * traffic_mod.tokens_per_step(tr))


def unit_dims(cell: Cell) -> List[int]:
    """The compression units' sizes of one worker (the algorithm's, from
    the reference's leaves)."""
    from pbench.ref_step import units
    leaves = cell.family.leaves(cell.config)
    return [u.dim for u in units(leaves, cell.traffic["granularity"],
                                 torch.zeros(2, dtype=torch.int64))]


class Context:
    """What a metric reader may read: the window (steps, host seconds,
    event-timed step ms), set-up seconds and peak bytes; in a traced run
    also the spans and the profiler's trace."""

    def __init__(self, cell: Cell, window: dict, setup_s: float,
                 peak_bytes: int, spans: Optional[Spans] = None,
                 trace: Optional[dict] = None):
        self.cell = cell
        self.config, self.traffic = cell.config, cell.traffic
        self.steps, self.window_s = window["steps"], window["window_s"]
        self.step_ms = window["step_ms"]
        self.tokens_per_step = traffic_mod.tokens_per_step(cell.traffic)
        self.setup_s, self.peak_bytes = setup_s, peak_bytes
        self.spans = ({k: spans.ms(k) for k in ("grads", "aggregate")}
                      if spans is not None else {})
        self.trace = trace
        self.flops_per_step = flops_per_step(cell)
        self.peaks = peaks

    def unit_dims(self) -> List[int]:
        return unit_dims(self.cell)

    def elt_bytes(self) -> int:
        return peaks.DTYPE_BYTES[self.config["dtype"]]

    def kernel_s(self, name: str) -> Optional[float]:
        """Device seconds a step of the kernels named `name`."""
        hits = [s for n, s in self.trace["kernel_s"].items() if name in n]
        return sum(hits) if hits else None

    def roofline(self, kernel: str) -> Optional[float]:
        """The least time a step of `kernel`'s work over its kernels'
        device time a step, in %; None where the cell's compressor has no
        such work or the trace no such kernel."""
        comp = self.traffic["compressor"]
        if comp["name"] != ROOFLINE_COMPRESSOR[kernel]:
            return None
        t = self.kernel_s(kernel + "_kernel")
        if not t:
            return None
        kw = ({"levels": comp["levels"]} if comp["name"] == "qsgd"
              else {"ratio": comp["ratio"]})
        least, _ = peaks.least_seconds(kernel, self.unit_dims(),
                                       self.traffic["workers"],
                                       self.elt_bytes(), **kw)
        return 100.0 * least / t


def make_line(correct: bool, attempted: int, failed: int, metrics: dict,
              device: dict, nums: Dict[str, float], limits: Dict[str, float],
              trace: Optional[dict] = None) -> dict:
    """The result's line: with a trace, the device's busy and window
    seconds and the breakdown; the numbers compared, beside their limits,
    last."""
    line = {"correct": correct, "attempted": attempted, "failed": failed,
            "metrics": metrics, "device": dict(device)}
    if trace is not None:
        line["device"]["busy_s"] = trace["busy_s"]
        line["device"]["window_s"] = trace["window_s"]
        line["breakdown"] = {"device_ops": trace["device_ops"],
                             "idle_gaps": trace["idle_gaps"]}
    line["checks"] = {n: {"value": v, "limit": limits.get(n)}
                      for n, v in nums.items()}
    return line


def run(cell: Cell, seed: int, seconds: float, trace: bool,
        t_start: float, bench: dict) -> dict:
    """One run -> {"line": the result's line, "correct": bool, "window":
    its steps, seconds, set-up and reference seconds, step ms}."""
    dev = torch.device("cuda", 0)
    full_precision()
    r = Run(cell, seed, dev)
    torch.cuda.reset_peak_memory_stats(dev)
    prog = r.checked()
    spans = Spans(r.program, timed=True) if trace else None
    torch.cuda.synchronize(dev)
    setup_s = time.monotonic() - t_start
    win = r.window(seconds)
    tr_out = None
    if trace:
        tr_out = profile_steps(r.step, PROFILE_STEPS, NAMED_STEPS)
    peak = torch.cuda.max_memory_allocated(dev)
    ctx = Context(cell, win, setup_s, peak, spans, tr_out)
    metrics: Dict[str, dict] = {}
    for m in metrics_of(cell.name, "per_layer" if trace else "end_to_end",
                        bench):
        v = reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    if spans is not None:
        spans.restore()
    r.close()
    del spans
    _free()
    t_ref = time.monotonic()
    ref = reference(cell, seed, dev)
    nums = compare(cell, prog, ref)
    t_ref = time.monotonic() - t_ref
    ok = check.verdict(nums, cell.limits) and win["nonfinite"] == 0
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": 1, "memory_peak_bytes": peak}
    line = make_line(ok, win["steps"], win["nonfinite"], metrics, device,
                     nums, cell.limits, tr_out)
    return {"line": line, "correct": ok,
            "window": {"steps": win["steps"], "window_s": win["window_s"],
                       "setup_s": setup_s, "reference_s": t_ref,
                       "step_ms": win["step_ms"]}}
