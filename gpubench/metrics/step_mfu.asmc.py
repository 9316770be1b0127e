"""step_mfu.asmc: the window's decode operations of ASMC's jobs at the
card's peaks over the window's wall, in percent: bounds what the kernels'
rooflines can claim for the whole job."""

from gpubench.readings import step_mfu_pct as read  # noqa: F401
