"""grads_ms: the median over the window's steps of the CUDA-event span
around experiment.lm_worker_grads (every worker's forward and backward
through models/model.py), in ms."""
import statistics


def read(ctx):
    ms = ctx.spans["grads"]
    return statistics.median(ms) if ms else None
