"""fastsmc.count_wait_s_per_job: FastSMC.roofline()["count_wait_s"], the
dispatch's waits for the batches' run counts, which size each batch's
extraction, a mean over the jobs. Absent where the program has no count."""

from gpubench.readings import counter_per_job


def read(run):
    return counter_per_job(run, "count_wait_s")
