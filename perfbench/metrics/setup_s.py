"""setup_s: seconds from the process's start to the first timed step
(imports, the kernel libraries, weights and rows from the seed, the
checked steps)."""


def read(ctx):
    return ctx.setup_s
