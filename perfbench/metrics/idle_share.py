"""idle_share: the share of a window step in which the device runs
nothing, in %: one minus the device's busy seconds a step (the union of
its activity intervals over the steps traced on the device alone) over
the window's median event-timed step."""
import statistics


def read(ctx):
    step_s = statistics.median(ctx.step_ms) / 1e3 if ctx.step_ms else 0.0
    if step_s <= 0:
        return None
    busy = ctx.trace["busy_s"] / ctx.trace["steps"]
    return 100.0 * (1.0 - busy / step_s)
