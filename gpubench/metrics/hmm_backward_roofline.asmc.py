"""hmm_backward_roofline.asmc: the least time of the window's
backward+combine decodes of ASMC's jobs with their outputs, the posterior
sums and the major/minor sums over the batch's pairs
(gpubench.yardstick.decode_bound at each batch's shape, the sums as the
reduced matrices) over the device time of the backward kernel and the
block reduction in the trace, in percent."""

from gpubench.readings import roofline_pct

# the trace names of the kernels that do this work
KERNELS = ("hmm_backward_kernel", "block_reduce_kernel")


def read(run):
    return roofline_pct(run, "backward", KERNELS)
