"""fastsmc.writer_s_per_job: the IBD writer thread's format and deflate
time, FastSMC.roofline()["writer_fmt_s"] + ["writer_deflate_s"], a mean
over the jobs."""

from gpubench.readings import counter_per_job


def read(run):
    return counter_per_job(run, "writer_fmt_s", "writer_deflate_s")
