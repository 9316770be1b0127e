"""fastsmc.writer_busy_s_per_job: the IBD writer's wall, the seconds in
which at least one of its workers formatted or deflated,
FastSMC.roofline()["writer_busy_s"], a mean over the jobs (None where the
program has no such counter)."""

from gpubench.readings import counter_per_job


def read(run):
    return counter_per_job(run, "writer_busy_s")
