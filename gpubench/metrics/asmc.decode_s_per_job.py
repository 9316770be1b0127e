"""asmc.decode_s_per_job: the benchmark's span asmc.decode around
decode_all_in_job(): the job's batches through both kernels, the copies of
each batch's sums to the host and their float64 adds, a mean over the jobs."""

from gpubench.readings import span_s_per_job


def read(run):
    return span_s_per_job(run, "asmc.decode")
