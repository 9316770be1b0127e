"""hmm_forward_roofline.asmc: the least time of the window's forward
decodes of ASMC's jobs (gpubench.yardstick.decode_bound at each batch's
shape) over the device time of the forward kernels in the trace, in
percent."""

from gpubench.readings import roofline_pct

# the trace names of the kernels that do this work
KERNELS = ("hmm_forward_kernel", "hmm_forward_tile_kernel")


def read(run):
    return roofline_pct(run, "forward", KERNELS)
