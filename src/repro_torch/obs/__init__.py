"""Observability: tracing, metrics, and measured-vs-modeled calibration
(the JAX package's obs/).

The execution stack (core.plan / core.schedule / core.wire /
core.aggregation / launch.engine) accepts a duck-typed ``recorder=`` and
never imports this package — obs depends on core, not the reverse. See
obs.trace for the clocks and the zero-overhead contract.
"""
from repro_torch.obs.calibrate import (DEFAULT_THRESHOLDS, calibrate,
                                       fit_alpha_beta, measure_schedule)
from repro_torch.obs.metrics import (METRICS_SCHEMA_VERSION,
                                     MetricsRegistry, read_jsonl)
from repro_torch.obs.trace import (TRACE_SCHEMA_VERSION, TraceRecorder,
                                   active, count_debug_callbacks,
                                   format_step_summary,
                                   validate_chrome_trace)

__all__ = [
    "TraceRecorder", "active", "validate_chrome_trace",
    "format_step_summary", "count_debug_callbacks", "TRACE_SCHEMA_VERSION",
    "MetricsRegistry", "read_jsonl", "METRICS_SCHEMA_VERSION",
    "measure_schedule", "fit_alpha_beta", "calibrate",
    "DEFAULT_THRESHOLDS",
]
