"""device.peak_gib.asmc: torch.cuda.max_memory_allocated over the window
of ASMC's jobs (reset after the warm-up), in GiB."""

from gpubench.readings import peak_gib as read  # noqa: F401
