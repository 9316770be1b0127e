"""Multi-process scale-out: job tiles per process, merged through files.

Counterpart of ``fastsmc_tpu/parallel/multihost.py``. The reference scales
out with independent processes over a triangular tiling of the pair matrix
and merges their output files (FastSMC_example_multiple_jobs.sh:9-44,
Data.cpp:62-80). Each process here takes its share of ``(job_ind, jobs)``
tiles and decodes them over its local mesh (:mod:`.sharding`); the IBD
record streams concatenate, and ASMC's posterior-sum matrices add through
``pipelines/merge.py``. ``torch.distributed`` (gloo) only tells a process
its rank and the world size: no collective is on the hot path.
"""

from __future__ import annotations

import dataclasses
import shutil
from typing import List, Optional, Sequence

import torch.distributed as dist

from ..config import DecodingParams, valid_job_counts


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> int:
    """Join a process group of ``num_processes`` over gloo at
    ``coordinator_address`` ("host:port") and return this process's rank.
    A single process returns 0 without a group. Gloo, not NCCL: nothing on
    the hot path is a collective, and NCCL refuses two ranks on one
    card."""
    if num_processes in (None, 1) and coordinator_address is None:
        return 0
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError("a process group needs coordinator_address, "
                         "num_processes and process_id")
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes),
                            rank=int(process_id))
    return dist.get_rank()


def job_tiles_for_process(process_id: int, num_processes: int,
                          tiles_per_process: int = 1):
    """Triangular job tiles of one process (multihost.py:37-50): the tile
    count is the smallest valid ``jobs`` (1, 4, 9, 16, ...) of at least
    ``num_processes * tiles_per_process``; process p takes tiles p+1,
    p+1+P, ... (1-based, strided so the heavier diagonal tiles spread).
    Returns ``(tiles, jobs)``."""
    want = max(num_processes * tiles_per_process, 1)
    jobs = next(c for c in valid_job_counts(want + 2) if c >= want)
    return [j for j in range(process_id + 1, jobs + 1, num_processes)], jobs


def run_fastsmc_multihost(params: DecodingParams,
                          process_id: Optional[int] = None,
                          num_processes: Optional[int] = None,
                          tiles_per_process: int = 1,
                          **fastsmc_kwargs) -> List[str]:
    """This process's share of a multi-process FastSMC run: its tiles one
    after the other, one output file each
    (``<root>.<jobInd>.<jobs>.FastSMC.ibd.gz``, as the reference names
    them); concatenate them with :func:`merge_ibd_outputs`. The rank and
    world size default to the process group's (0 and 1 without one).
    ``fastsmc_kwargs`` go to ``FastSMC`` (``device``, ``mesh``, ...).
    Returns the paths this process wrote."""
    from ..pipelines.fastsmc import FastSMC
    grouped = dist.is_available() and dist.is_initialized()
    if process_id is None:
        process_id = dist.get_rank() if grouped else 0
    if num_processes is None:
        num_processes = dist.get_world_size() if grouped else 1
    tiles, jobs = job_tiles_for_process(process_id, num_processes,
                                        tiles_per_process)
    paths = []
    for job_ind in tiles:
        p = dataclasses.replace(params, jobs=jobs, job_ind=job_ind)
        p.finalize()
        paths.append(FastSMC(p, **fastsmc_kwargs).run(verbose=False))
    return paths


def merge_ibd_outputs(paths: Sequence[str], out_path: str) -> str:
    """Concatenate per-job ``.ibd.gz``/``.bibd.gz`` outputs: gzip members
    concatenate byte-wise into one valid stream, as the reference's shell
    drivers ``cat`` their job outputs."""
    with open(out_path, "wb") as out:
        for p in paths:
            with open(p, "rb") as f:
                shutil.copyfileobj(f, out)
    return out_path
