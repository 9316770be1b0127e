"""Scale-out: pair-parallel decoding over the local devices of a process
(:mod:`.sharding`), and job tiles across processes with the file merge of
their outputs (:mod:`.multihost`)."""

from .multihost import (initialize, job_tiles_for_process, merge_ibd_outputs,
                        run_fastsmc_multihost)
from .sharding import Mesh, ShardedDecoder, make_mesh, training_step

__all__ = ["Mesh", "ShardedDecoder", "initialize", "job_tiles_for_process",
           "make_mesh", "merge_ibd_outputs", "run_fastsmc_multihost",
           "training_step"]
