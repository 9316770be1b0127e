"""fastsmc.drain_host_s_per_job: FastSMC.roofline()["drain_host_s"], the
drain's own host time (unpacking rows, redos), a mean over the jobs."""

from gpubench.readings import counter_per_job


def read(run):
    return counter_per_job(run, "drain_host_s")
