"""fastsmc.overflow_redos_per_job: FastSMC.stats["overflow_redos"], batches
extracted again at grown caps, a mean over the jobs."""

from gpubench.readings import counter_per_job


def read(run):
    return counter_per_job(run, "overflow_redos")
