"""mfu: the model FLOPs of the window's steps (forward and backward of
every worker, no recomputation, no compression work: the family's
flops_per_token at the traffic's sequence length, times the step's
tokens) over the window's event-timed seconds and the bf16 dense peak,
in %."""


def read(ctx):
    secs = sum(ctx.step_ms) / 1e3
    if secs <= 0:
        return None
    steps = len(ctx.step_ms)
    return 100.0 * ctx.flops_per_step * steps / secs / \
        ctx.peaks.BF16_FLOPS_PER_S
