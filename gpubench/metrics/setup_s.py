"""setup_s: process start to the first timed job (import, CUDA
context, the kernel library, the panel, the tables and the warm-up job)."""


def read(run):
    return run.setup_s
