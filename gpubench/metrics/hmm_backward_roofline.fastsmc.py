"""hmm_backward_roofline.fastsmc: the least time of the window's
backward+combine decodes with their outputs (the sums over pairs as the
reduced matrices; gpubench.yardstick.decode_bound at each batch's shape)
over the device time of the backward kernel and the block reduction in the
trace, in percent."""

from gpubench.readings import roofline_pct

# the trace names of the kernels that do this work
KERNELS = ("hmm_backward_kernel", "block_reduce_kernel")


def read(run):
    return roofline_pct(run, "backward", KERNELS)
