"""tokens_per_s: the tokens of every step issued in the window over the
window's host seconds, which end with a synchronise once the last step
is issued."""


def read(ctx):
    return ctx.steps * ctx.tokens_per_step / ctx.window_s
