"""peak_mem_gib: torch.cuda.max_memory_allocated, reset before the first
checked step and read after the window, in GiB."""


def read(ctx):
    return ctx.peak_bytes / 2**30
