"""roofline.qsgd_pack: the least time of a step's qsgd_pack work (pbench.peaks,
from the cell's units and the algorithm alone) over the profiler's
device time a step of the kernels named qsgd_pack_kernel, in %. Nothing to
read where the cell's compressor launches none."""


def read(ctx):
    return ctx.roofline("qsgd_pack")
