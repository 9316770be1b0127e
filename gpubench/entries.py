"""How a job of each entry point of the system under test is run: the
calls a user's loop over jobs makes, with the benchmark's spans around
them and the program's counters read after them.

The system under test is ``fastsmc_tpu_torch``, passed in as ``sut``; an
entry is named by the configuration's ``entry`` key. Each returns the
job's record: its pairs, the batch widths the program decodes them in, the
output files and the program's counters.
"""

from __future__ import annotations

import os

from .checks import asmc_files
from .reference.jobs import job_range


def _params(sut, env, job_ind: int, out_root: str, jobs: int):
    cfg = env.config
    return sut.DecodingParams(
        in_file_root=out_root, decoding_quant_file=env.dq_path,
        out_file_root=out_root, jobs=jobs, job_ind=job_ind,
        batch_size=int(cfg["batch_size"]), **cfg["params"]).finalize()


def _batches(n: int, width: int) -> list:
    return [width] * (n // width) + ([n % width] if n % width else [])


def asmc(sut, env, job_ind: int, out_root: str, rec, jobs: int) -> dict:
    """``ASMC(...)``, ``decode_all_in_job()``, ``write_outputs()``."""
    p = _params(sut, env, job_ind, out_root, jobs)
    with rec.span("asmc.construct", job=job_ind):
        a = sut.ASMC(p, data=env.data, dq=env.dq, device=env.device,
                     batch_size=int(env.config["batch_size"]),
                     decode_profile=env.config["decode_profile"])
    start, end = job_range(env.data.n_ind, jobs, job_ind)
    with rec.span("asmc.decode", job=job_ind):
        result = a.decode_all_in_job(verbose=False)
    with rec.span("asmc.write", job=job_ind):
        a.write_outputs(result)
    files = {name: out_root + suffix
             for name, suffix in asmc_files(env.config["params"]).items()}
    return dict(pairs=end - start, batches=_batches(end - start,
                                                    a.batch_size),
                files=files, counters={})


def fastsmc(sut, env, job_ind: int, out_root: str, rec, jobs: int) -> dict:
    """``FastSMC(...)`` and ``run()``: the job's records written and the
    file closed when it returns."""
    p = _params(sut, env, job_ind, out_root, jobs)
    with rec.span("fastsmc.construct", job=job_ind):
        f = sut.FastSMC(p, data=env.data, dq=env.dq, device=env.device,
                        decode_profile=env.config["decode_profile"])
    start, end = job_range(env.data.n_ind, jobs, job_ind)
    with rec.span("fastsmc.run", job=job_ind):
        path = f.run(verbose=False)
    counters = dict(f.roofline())
    counters.update({k: f.stats[k] for k in ("overflow_redos", "flushes",
                                             "d2h_bytes")})
    counters["records"] = f.n_segments
    return dict(pairs=end - start,
                batches=_batches(end - start, p.batch_size),
                files={"ibd": path}, counters=counters)


ENTRIES = {"asmc": asmc, "fastsmc": fastsmc}


def remove_outputs(job: dict) -> None:
    for path in job.get("files", {}).values():
        if os.path.exists(path):
            os.remove(path)
