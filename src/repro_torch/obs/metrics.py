"""MetricsRegistry: counters, gauges, and histograms with schema-versioned
JSON-lines export (the JAX package's obs/metrics.py, line for line: the
exported lines are byte for byte the reference's).

The numeric complement of obs.trace's event timeline: cheap host-side
aggregates (steps run, builds/retraces, dispatch and message counts, wire
bytes, per-stage microseconds, replan decisions) that harnesses bump from
ordinary Python, never from inside a kernel or a timed region. Snapshots are
plain dicts stamped with a schema version so exported lines stay
joinable with trace output and forward-parseable.

Export format: one JSON object per line (JSON-lines). Every line:

    {"schema_version": 1, "kind": "snapshot", "labels": {...},
     "counters": {...}, "gauges": {...},
     "histograms": {name: {count,min,max,mean,p50,p95,sum}}}

Conventions: counter/gauge names are slash-paths ("train/steps",
"controller/builds"); histograms record raw samples in memory and export
summaries only. A disabled registry (enabled=False) turns every method
into a no-op so call sites need no guards.
"""
from __future__ import annotations

import json
from typing import Dict, List

__all__ = ["MetricsRegistry", "METRICS_SCHEMA_VERSION", "read_jsonl"]

#: bump when the snapshot line layout changes
METRICS_SCHEMA_VERSION = 1


def _percentile(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(round(q * (len(sorted_vals) - 1))))
    return sorted_vals[idx]


class MetricsRegistry:
    def __init__(self, enabled: bool = True):
        self.enabled = bool(enabled)
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        self.histograms: Dict[str, List[float]] = {}
        self._lines: List[Dict] = []

    # ---- instruments -----------------------------------------------------
    def inc(self, name: str, value: float = 1.0) -> None:
        if not self.enabled:
            return
        self.counters[name] = self.counters.get(name, 0.0) + float(value)

    def gauge(self, name: str, value: float) -> None:
        if not self.enabled:
            return
        self.gauges[name] = float(value)

    def observe(self, name: str, value: float) -> None:
        if not self.enabled:
            return
        self.histograms.setdefault(name, []).append(float(value))

    # ---- snapshots -------------------------------------------------------
    def snapshot(self, **labels) -> Dict:
        """The current aggregate state as one schema-versioned dict."""
        hists = {}
        for name, vals in sorted(self.histograms.items()):
            sv = sorted(vals)
            hists[name] = {
                "count": len(sv),
                "min": sv[0] if sv else 0.0,
                "max": sv[-1] if sv else 0.0,
                "mean": (sum(sv) / len(sv)) if sv else 0.0,
                "p50": _percentile(sv, 0.50),
                "p95": _percentile(sv, 0.95),
                "sum": sum(sv),
            }
        return {
            "schema_version": METRICS_SCHEMA_VERSION,
            "kind": "snapshot",
            "labels": dict(labels),
            "counters": dict(sorted(self.counters.items())),
            "gauges": dict(sorted(self.gauges.items())),
            "histograms": hists,
        }

    def record(self, **labels) -> Dict:
        """Append a snapshot line (e.g. once per step or per replan
        window) for a later export_jsonl."""
        line = self.snapshot(**labels)
        if self.enabled:
            self._lines.append(line)
        return line

    # ---- export ----------------------------------------------------------
    def export_jsonl(self, path: str) -> int:
        """Write the recorded snapshot lines (plus a final snapshot when
        none were recorded) as JSON-lines; returns the line count."""
        lines = self._lines or [self.snapshot(final=True)]
        with open(path, "w") as f:
            for line in lines:
                f.write(json.dumps(line, sort_keys=True) + "\n")
        return len(lines)


def read_jsonl(path: str) -> List[Dict]:
    """Parse a JSON-lines metrics export back into dicts (the round-trip
    partner of export_jsonl; tests hold snapshot == parsed line)."""
    out = []
    with open(path) as f:
        for raw in f:
            raw = raw.strip()
            if raw:
                out.append(json.loads(raw))
    return out
