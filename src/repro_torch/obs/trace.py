"""TraceRecorder: per-step, per-message event timelines of the executed
compression pipeline (the JAX package's obs/trace.py).

The paper's complaint is that theory reasons about an idealized pipeline
while implementations run a different one; `simulate_schedule` is such a
model. The TraceRecorder records what a step ACTUALLY did: one span per
pipeline stage (compress, pack, decode, collective, ef_update, hop) per
wire message, or one span per message on the unpacked path and one per
size-class dispatch on the bare-plan path, with bucket / message / codec
attribution, exported as Chrome trace-event JSON (Perfetto,
chrome://tracing) plus a compact per-step summary. The events' layout and
`args` keys are the reference's; only `metadata.tool` names this module.

Mechanics. The execution hooks (core.plan / core.schedule / core.wire /
core.aggregation / launch.engine take a duck-typed ``recorder=``; core
never imports obs) run eagerly, and at the end of each stage they

  * run the stage inside ``torch.profiler.record_function`` (`scope`), so
    a torch.profiler trace carries the same ``repro/msg…`` names, and
  * stamp the end of the stage (`mark`): where the stage's outputs live on
    a CUDA device, a ``torch.cuda.Event(enable_timing=True)`` recorded on
    that device's current stream, the card's clock, with no synchronize
    (a host clock read after an asynchronous launch measures the launch,
    and a synchronize would change the step it measures); on the CPU,
    where the stage has finished when the hook returns,
    ``time.perf_counter_ns()``.

`finalize_step` synchronizes once and turns each event into nanoseconds
from the recorder's first event; a span's duration is the gap between
consecutive stamps in time order. One recorder times one kind of clock:
a recorder that stamped CUDA events refuses a host stamp and the reverse.

Grouped launches. The port encodes every bucket of a step in one grouped
launch and decodes them in one. `mark_group` stamps such a launch once
for all the messages it covers: each gets a span with the same ts and
dur, and the step's `stage_us` and `wall_us` count the interval once, so
the sum of `stage_us` never exceeds `wall_us`. The per-message pack spans
(buffer assembly) and per-bucket collective spans are each message's own.

Zero-overhead contract: every hook guards on ``active(recorder)``, so
with no recorder or a disabled one the step runs exactly the
uninstrumented ops (no event, no scope, no extra op;
tests/test_torch_obs.py compares the op sequences).
"""
from __future__ import annotations

import contextlib
import json
import time
from typing import Any, Dict, List, Optional, Sequence

import torch

__all__ = ["TraceRecorder", "active", "validate_chrome_trace",
           "format_step_summary", "count_debug_callbacks"]

#: bump when the exported chrome-trace "args" layout changes
TRACE_SCHEMA_VERSION = 1

_ALLOWED_PH = {"X", "i", "M"}


def active(recorder) -> Optional["TraceRecorder"]:
    """The one-line guard every instrumented hook runs: the recorder if
    it exists and is enabled, else None (the uninstrumented path).
    Duck-typed so core modules can inline the same check without
    importing obs."""
    if recorder is not None and getattr(recorder, "enabled", False):
        return recorder
    return None


def _device_of(dep) -> Optional[torch.device]:
    """The device of the first tensor in `dep` (a tensor or nested lists
    and tuples of them, None entries allowed), None without one."""
    if isinstance(dep, torch.Tensor):
        return dep.device
    if isinstance(dep, (list, tuple)):
        for d in dep:
            dev = _device_of(d)
            if dev is not None:
                return dev
    return None


class TraceRecorder:
    """Records stage marks from instrumented execution into Chrome trace
    events. One recorder serves many steps; call :meth:`finalize_step`
    after each step to convert that step's marks into spans. Marks choose
    the clock by the device of their outputs."""

    def __init__(self, enabled: bool = True, pid: int = 0,
                 clock=time.perf_counter_ns):
        self.enabled = bool(enabled)
        self.pid = pid
        self._clock = clock
        self.events: List[Dict] = []      # finalized chrome events
        self.steps: List[Dict] = []       # per-step summaries
        self._marks: List = []            # ([meta, ...], stamp) this step
        self._t0: Optional[int] = None    # trace epoch in ns
        self._epoch = None                # first CUDA event (epoch 0 ns)
        self._cuda: Optional[bool] = None  # the clock, once chosen

    # ---- execution hooks (called eagerly as each stage ends) ------------
    def scope(self, name: str):
        """record_function wrapper so torch.profiler traces carry the
        span names."""
        return torch.profiler.record_function(name)

    def begin(self, dep, label: str = "inputs_ready") -> None:
        """Stamp the moment the instrumented region's INPUTS are computed
        — the baseline the first span's duration is measured from."""
        self._stamp(dep, [_meta("begin", cat="begin", label=label)])

    def mark(self, dep, stage: str, *, cat: str = "stage",
             message: Optional[int] = None,
             bucket_ids: Optional[Sequence[int]] = None,
             dims: Optional[Sequence[int]] = None,
             n_units: Optional[int] = None,
             codec: Optional[str] = None,
             label: Optional[str] = None) -> None:
        """Stamp one pipeline-stage end, with its static attribution.
        `dep` is the stage's outputs (their device picks the clock)."""
        self._stamp(dep, [_meta(stage, cat=cat, message=message,
                                bucket_ids=bucket_ids, dims=dims,
                                n_units=n_units, codec=codec,
                                label=label)])

    def mark_group(self, dep, stage: str, attrs: Sequence[Dict], *,
                   cat: str = "stage") -> None:
        """Stamp the end of one grouped launch that covers several
        messages: `attrs` holds each message's attribution (mark's keyword
        arguments). Every message gets a span of the same interval, which
        the step's totals count once."""
        self._stamp(dep, [_meta(stage, cat=cat, **a) for a in attrs])

    def _uses_events(self, dev: Optional[torch.device]) -> bool:
        cuda = dev is not None and dev.type == "cuda"
        if self._cuda is None:
            self._cuda = cuda
        elif dev is not None and cuda != self._cuda:
            clock = "CUDA events" if self._cuda else "the host clock"
            raise ValueError(f"this recorder times {clock}; a stamp on "
                             f"{dev} would mix two clocks in one timeline")
        return self._cuda

    def _event(self, dev: Optional[torch.device]):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(dev))
        if self._epoch is None:
            self._epoch = ev
        return ev

    def _stamp(self, dep, metas: List[Dict]) -> None:
        """Take one stamp: a CUDA event on the outputs' device, or the
        host clock. The only place a mark reads a clock."""
        dev = _device_of(dep)
        if self._uses_events(dev):
            self._marks.append((metas, self._event(dev)))
        else:
            self._marks.append((metas, self._clock()))

    def _ns(self, stamp) -> int:
        if isinstance(stamp, int):
            return stamp
        return round(self._epoch.elapsed_time(stamp) * 1e6)

    # ---- host-side spans -------------------------------------------------
    @contextlib.contextmanager
    def host_span(self, name: str, cat: str = "host", **args):
        """A span around a host-side region (a prefill, a decode step)
        that closes over finished work. Where CUDA is in use (this
        recorder times CUDA events, or it has no clock yet and CUDA is
        initialized) an event pair on the current stream whose end event
        is synchronized before the span ends; else the host clock, read
        after a synchronize whenever CUDA is initialized. Also enters
        record_function so a torch.profiler trace taken concurrently
        carries the same name."""
        if not self.enabled:
            yield
            return
        cuda = torch.cuda.is_initialized()
        events = self._uses_events(
            torch.device("cuda", torch.cuda.current_device())
            if cuda and self._cuda is None else None)
        with torch.profiler.record_function(name):
            if events:
                e0 = self._event(None)
                yield
                e1 = self._event(None)
                e1.synchronize()
                t0, t1 = self._ns(e0), self._ns(e1)
            else:
                if cuda:
                    torch.cuda.synchronize()
                t0 = self._clock()
                yield
                if cuda:
                    torch.cuda.synchronize()
                t1 = self._clock()
        if self._t0 is None:
            self._t0 = 0 if events else t0
        self.events.append({
            "name": name, "cat": cat, "ph": "X",
            "ts": round((t0 - self._t0) / 1e3, 3),
            "dur": round((t1 - t0) / 1e3, 3),
            "pid": self.pid, "tid": 0,
            "args": dict(args),
        })

    # ---- finalization ----------------------------------------------------
    def finalize_step(self, step: Optional[int] = None, *,
                      dedupe: bool = False) -> Dict:
        """Convert the marks stamped since the last finalize into spans
        (synchronizing once on the step's last CUDA event). Call after the
        step. Returns the per-step summary.

        ``dedupe`` is kept for the reference's API: there it collapses the
        stamps a debug callback takes once per local device under a
        multi-device shard_map. Here every rank is a process with its own
        recorder (pid = rank) and every mark stamps once, so there is
        nothing to collapse."""
        del dedupe
        raw, self._marks = self._marks, []
        if raw and not isinstance(raw[-1][1], int):
            raw[-1][1].synchronize()
        marks = sorted(((metas, self._ns(s)) for metas, s in raw),
                       key=lambda m: m[1])
        step = len(self.steps) if step is None else int(step)
        if not marks:
            summary = {"step": step, "n_spans": 0, "n_message_spans": 0,
                       "stage_us": {}, "wall_us": 0.0}
            self.steps.append(summary)
            return summary
        if self._t0 is None:
            self._t0 = 0 if self._cuda else marks[0][1]
        spans = []
        stage_ns: Dict[str, int] = {}
        prev_ns = None
        for metas, t_ns in marks:
            if metas[0]["stage"] == "begin":
                prev_ns = t_ns
                continue
            start = prev_ns if prev_ns is not None else t_ns
            spans.extend((start, t_ns, meta) for meta in metas)
            # a grouped launch's interval counts once
            stage = metas[0]["stage"]
            stage_ns[stage] = stage_ns.get(stage, 0) + (t_ns - start)
            prev_ns = t_ns
        msg_seen = set()
        by_msg: Dict[int, List] = {}
        for start, end, meta in spans:
            cat = meta.get("cat", "stage")
            mi = meta.get("message")
            name = meta.get("label") or (
                f"{meta['stage']} m{mi}" if mi is not None
                else meta["stage"])
            args = {"step": step, "stage": meta["stage"],
                    "schema_version": TRACE_SCHEMA_VERSION}
            for k in ("message", "bucket_ids", "dims", "n_units", "codec"):
                if k in meta:
                    args[k] = (list(meta[k])
                               if isinstance(meta[k], tuple) else meta[k])
            self.events.append({
                "name": name, "cat": cat, "ph": "X",
                "ts": round((start - self._t0) / 1e3, 3),
                "dur": round((end - start) / 1e3, 3),
                "pid": self.pid, "tid": 0, "args": args,
            })
            if mi is not None:
                if cat == "message":
                    msg_seen.add(mi)
                else:
                    by_msg.setdefault(mi, []).append((start, end, meta))
        # synthesize a cat="message" umbrella span per message that only
        # emitted stage spans (the wire path), so span-count == n_messages
        # holds on every instrumented path
        n_message_spans = len(msg_seen)
        for mi in sorted(k for k in by_msg if k not in msg_seen):
            group = by_msg[mi]
            start = min(s for s, _, _ in group)
            end = max(e for _, e, _ in group)
            meta0 = group[0][2]
            args = {"step": step, "stage": "message",
                    "schema_version": TRACE_SCHEMA_VERSION, "message": mi,
                    "stages": sorted({m["stage"] for _, _, m in group})}
            for k in ("bucket_ids", "dims", "n_units", "codec"):
                if k in meta0:
                    args[k] = (list(meta0[k])
                               if isinstance(meta0[k], tuple) else meta0[k])
            self.events.append({
                "name": f"message m{mi}", "cat": "message", "ph": "X",
                "ts": round((start - self._t0) / 1e3, 3),
                "dur": round((end - start) / 1e3, 3),
                "pid": self.pid, "tid": 1, "args": args,
            })
            n_message_spans += 1
        summary = {
            "step": step,
            "n_spans": len(spans),
            "n_message_spans": n_message_spans,
            "stage_us": {k: round(v / 1e3, 3)
                         for k, v in sorted(stage_ns.items())},
            "wall_us": round((marks[-1][1] - marks[0][1]) / 1e3, 3),
        }
        self.steps.append(summary)
        return summary

    # ---- queries ---------------------------------------------------------
    def span_events(self, cat: Optional[str] = None,
                    step: Optional[int] = None) -> List[Dict]:
        out = []
        for e in self.events:
            if e.get("ph") != "X":
                continue
            if cat is not None and e.get("cat") != cat:
                continue
            if step is not None and e.get("args", {}).get("step") != step:
                continue
            out.append(e)
        return out

    def message_spans(self, step: Optional[int] = None) -> List[Dict]:
        """The per-message spans of one step (or all steps) — the
        acceptance-gate count: len == schedule.num_messages per step."""
        return self.span_events(cat="message", step=step)

    # ---- export ----------------------------------------------------------
    def chrome_trace(self) -> Dict:
        """The Chrome trace-event JSON object (Perfetto-loadable)."""
        meta_events = [{
            "name": "process_name", "ph": "M", "pid": self.pid, "tid": 0,
            "args": {"name": "repro"},
        }]
        return {
            "traceEvents": meta_events + self.events,
            "displayTimeUnit": "ms",
            "metadata": {"schema_version": TRACE_SCHEMA_VERSION,
                         "tool": "repro_torch.obs.trace",
                         "steps": self.steps},
        }

    def export(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f, indent=2, sort_keys=True)


def _meta(stage: str, **meta) -> Dict:
    """A mark's static attribution: the stage and the attributes given."""
    m = {"stage": stage}
    m.update({k: v for k, v in meta.items() if v is not None})
    if "bucket_ids" in m:
        m["bucket_ids"] = tuple(int(b) for b in m["bucket_ids"])
    if "dims" in m:
        m["dims"] = tuple(int(d) for d in m["dims"])
    return m


def validate_chrome_trace(obj: Any) -> bool:
    """Validate an object against the Chrome trace-event schema subset
    this module emits (dict with a traceEvents list of M/i/X events;
    every X event carries numeric non-negative ts/dur and a name).
    Raises ValueError on the first violation; returns True when valid."""
    if not isinstance(obj, dict):
        raise ValueError(f"trace must be a dict, got {type(obj).__name__}")
    events = obj.get("traceEvents")
    if not isinstance(events, list):
        raise ValueError("trace['traceEvents'] must be a list")
    for i, e in enumerate(events):
        if not isinstance(e, dict):
            raise ValueError(f"traceEvents[{i}] is not a dict")
        ph = e.get("ph")
        if ph not in _ALLOWED_PH:
            raise ValueError(f"traceEvents[{i}]: bad ph {ph!r}")
        if not isinstance(e.get("name"), str):
            raise ValueError(f"traceEvents[{i}]: name must be a string")
        if not isinstance(e.get("pid"), int) or not isinstance(
                e.get("tid"), int):
            raise ValueError(f"traceEvents[{i}]: pid/tid must be ints")
        if ph in ("X", "i"):
            ts = e.get("ts")
            if not isinstance(ts, (int, float)) or ts < 0:
                raise ValueError(f"traceEvents[{i}]: bad ts {ts!r}")
        if ph == "X":
            dur = e.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                raise ValueError(f"traceEvents[{i}]: bad dur {dur!r}")
        if "args" in e and not isinstance(e["args"], dict):
            raise ValueError(f"traceEvents[{i}]: args must be a dict")
    return True


def format_step_summary(summary: Dict) -> str:
    """One human line per step — what quickstart/train print."""
    stages = ", ".join(f"{k} {v:.0f}us"
                       for k, v in summary["stage_us"].items())
    return (f"step {summary['step']}: {summary['n_message_spans']} message "
            f"spans, {summary['n_spans']} stage spans, "
            f"{summary['wall_us']:.0f}us wall ({stages})")


def count_debug_callbacks(fn, *args) -> int:
    """How many marks one call of fn(*args) stages — the zero-overhead
    gate's counter (the twin of the reference's count of debug_callback
    equations in fn's jaxpr): 0 with recording off, 1 + num_messages on a
    recorded simulated schedule. fn runs once with every recorder's
    stamps counted and not taken (no event, no clock read, nothing left
    to finalize); not thread-safe, as it swaps TraceRecorder._stamp for
    the call."""
    n = 0

    def counting(self, dep, metas):
        nonlocal n
        n += 1
    orig = TraceRecorder._stamp
    TraceRecorder._stamp = counting
    try:
        fn(*args)
    finally:
        TraceRecorder._stamp = orig
    return n
