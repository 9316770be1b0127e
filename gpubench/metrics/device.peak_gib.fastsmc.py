"""device.peak_gib.fastsmc: torch.cuda.max_memory_allocated over the
window (reset after the warm-up), in GiB."""

from gpubench.readings import peak_gib as read  # noqa: F401
