"""fastsmc_pairs_per_s: pairs of the completed jobs over the wall from the
first job's start to the last one's end, for either entry. A FastSMC job
counts once run() has returned and its .ibd.gz is closed; an ASMC job once
decode_all_in_job() and write_outputs() have returned."""

from gpubench.readings import pairs_per_s as read  # noqa: F401
