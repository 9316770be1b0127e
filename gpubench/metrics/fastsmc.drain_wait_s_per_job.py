"""fastsmc.drain_wait_s_per_job: FastSMC.roofline()["drain_wait_s"], the
drain's wait on the card for a queued flush group, a mean over the jobs."""

from gpubench.readings import counter_per_job


def read(run):
    return counter_per_job(run, "drain_wait_s")
