"""aggregate_ms: the median over the window's steps of the CUDA-event
span around experiment.aggregate_simulated_workers (UnitPlan, Q_W, the
packed wire payloads, the worker mean, Q_M), in ms."""
import statistics


def read(ctx):
    ms = ctx.spans["aggregate"]
    return statistics.median(ms) if ms else None
