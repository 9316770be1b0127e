"""fastsmc_pairs_per_s: pairs of the completed FastSMC jobs (each
counted once run() has returned and its .ibd.gz is closed) over the wall
from the first job's start to the last one's end."""

from gpubench.readings import pairs_per_s as read  # noqa: F401
