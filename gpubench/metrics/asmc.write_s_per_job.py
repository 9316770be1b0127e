"""asmc.write_s_per_job: the benchmark's span asmc.write around
write_outputs(): the job's four sums files, formatted and deflated, a mean
over the jobs."""

from gpubench.readings import span_s_per_job


def read(run):
    return span_s_per_job(run, "asmc.write")
