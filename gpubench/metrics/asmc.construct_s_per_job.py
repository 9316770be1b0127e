"""asmc.construct_s_per_job: the benchmark's span asmc.construct around
ASMC(...): the job's panel tables, the decode context with its
undistinguished counts and emissions, and the decoder's device tables, a
mean over the jobs."""

from gpubench.readings import span_s_per_job


def read(run):
    return span_s_per_job(run, "asmc.construct")
