"""roofline.fields_unpack: the least time of a step's fields_unpack work (pbench.peaks,
from the cell's units and the algorithm alone) over the profiler's
device time a step of the kernels named fields_unpack_kernel, in %. Nothing to
read where the cell's compressor launches none."""


def read(ctx):
    return ctx.roofline("fields_unpack")
