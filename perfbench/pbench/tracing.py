"""The device trace of a few steps, in two passes of torch.profiler
(CUPTI). The first records the device alone, so that the host runs as
it does in the window: it gives the device's busy seconds (the union of
its activity intervals), the traced window's seconds, the device seconds
a step of each kernel by name and the top device operations. The second
records the host's operations too, which slows the host several-fold;
it is read only for the idle gaps, named by what the host was doing
when each began (the innermost host event open at its start, under the
benchmark's own span around it). Their seconds are those of the second
pass, as measured: longer than the window's, and comparable only with
each other."""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

TOP = 10
NAME_CHARS = 96


def _merge(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _gap_names(gaps, host) -> List[Tuple[str, float]]:
    """Each gap (start, end) in us named by the host events open at its
    start: the innermost, under the benchmark's span if one is open."""
    if not host:
        return [("host", (b - a) * 1e-6) for a, b in gaps]
    names = [h[0] for h in host]
    st = np.array([h[1] for h in host])
    en = np.array([h[2] for h in host])
    out = []
    for a, b in gaps:
        open_ = np.nonzero((st <= a) & (en > a))[0]
        if open_.size == 0:
            name = "host idle"
        else:
            inner = open_[np.argmin(en[open_] - st[open_])]
            spans = [names[i] for i in open_ if names[i].startswith("pb.")]
            name = names[inner]
            if spans and spans[0] != name:
                name = f"{spans[0]} > {name}"
        out.append((name[:NAME_CHARS], (b - a) * 1e-6))
    return out


def _trace(run: Callable[[], None], host: bool):
    """torch.profiler over run() -> (window seconds, device events, host
    events), each event (name, start us, end us)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.monotonic()
        run()
        torch.cuda.synchronize()
        window_s = time.monotonic() - t0
    dev, hst = [], []
    for e in prof.events():
        tr = e.time_range
        if getattr(e, "is_user_annotation", False) or e.name.startswith(
                "pb."):
            if e.device_type != DeviceType.CUDA:
                hst.append((e.name, tr.start, tr.end))
            continue             # a span's range on the device is no work
        if e.device_type == DeviceType.CUDA:
            dev.append((e.name, tr.start, tr.end))
        else:
            hst.append((e.name, tr.start, tr.end))
    return window_s, dev, hst


def profile_steps(step: Callable[[], None], steps: int,
                  named_steps: int) -> Dict:
    """`steps` steps traced on the device alone, then `named_steps` with
    the host's operations -> {"window_s", "busy_s", "steps", "kernel_s"
    {name: device s a step}, "device_ops" (s over the `steps`),
    "idle_gaps" (s over the `named_steps`)}."""
    window_s, dev, _ = _trace(lambda: [step() for _ in range(steps)], False)
    by_name: Dict[str, float] = {}
    for name, a, b in dev:
        by_name[name] = by_name.get(name, 0.0) + (b - a) * 1e-6
    busy_s = sum(b - a for a, b in _merge([(a, b) for _, a, b in dev])) * 1e-6
    _, dev, host = _trace(lambda: [step() for _ in range(named_steps)], True)
    merged = _merge([(a, b) for _, a, b in dev])
    gaps = sorted(((merged[i][1], merged[i + 1][0])
                   for i in range(len(merged) - 1)),
                  key=lambda g: g[0] - g[1])[:200]
    per_name: Dict[str, float] = {}
    for name, s in _gap_names(gaps, host):
        per_name[name] = per_name.get(name, 0.0) + s
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    top_gaps = sorted(per_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {"window_s": window_s, "busy_s": busy_s, "steps": steps,
            "kernel_s": {n: s / steps for n, s in by_name.items()},
            "device_ops": [[n[:NAME_CHARS], s] for n, s in top_ops],
            "idle_gaps": [[n, s] for n, s in top_gaps]}
