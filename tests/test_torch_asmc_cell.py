"""The benchmark's ``asmc_jobs_sums`` cell, cut to a size the plain
versions decode on the CPU, runs one job to a correct result under the
configuration's own limit: ASMC's entry, its four sums files and the
float64 reference's check, through ``gpubench.harness.run_cell``."""

import copy
import time

import fastsmc_tpu_torch as sut
from gpubench import harness


def test_cut_cell_runs_one_job_correct(tmp_path):
    """512 samples, 640 sites (the map's own length there), 1,024 jobs
    of 511 pairs, batches and reference blocks of 256, a warm-up job of
    255 pairs; the window ends after its first job."""
    cell = harness.load_cell("asmc_jobs_sums")
    cell.config = copy.deepcopy(cell.config)
    cell.traffic = copy.deepcopy(cell.traffic)
    cell.config.update(samples=512, sites=640, jobs=1024, batch_size=256)
    cell.config.pop("morgans")
    cell.config["check"]["block_pairs"] = 256
    cell.traffic["warmup"] = {"jobs": 2048, "job": 1}
    # a window shorter than any job: it ends after its first job however
    # fast the job runs
    res = harness.run_cell(cell, 2 ** 33 + 5, 1e-3, False, "cpu",
                           time.time(), sut, str(tmp_path))
    limit = cell.config["check"]["limits"]["sums_gap"]
    assert res["check"]["sums_gap"]["limit"] == limit
    assert res["correct"], res["check"]
    assert res["attempted"] == 1 and res["failed"] == 0
    assert 0 <= res["check"]["sums_gap"]["value"] <= limit
    assert set(res["metrics"]) == {"fastsmc_pairs_per_s", "setup_s"}
    assert list(tmp_path.iterdir()) == []        # outputs removed
