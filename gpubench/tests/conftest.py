"""Shared fixtures of the benchmark's CPU tests: the cells of
BENCHMARK.json cut to a size the plain versions decode in seconds, and an
ASMC cell of the same shape for the ASMC entry, check and control, which
no cell of BENCHMARK.json runs yet.

Run from the repository root: ``python -m pytest gpubench/tests -q``.
"""

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# the ASMC entry's configuration: all-pairs posterior sums and the
# major/minor sums, exact profile, checked in float32 against a TF32
# control (sums_gap: the largest gap of a written sum, over the pairs)
ASMC = {
    "name": "asmc_tiny_array_exact", "entry": "asmc",
    "decode_profile": "exact",
    "params": {"decoding_mode": "array", "do_posterior_sums": True,
               "do_major_minor_posterior_sums": True,
               "use_known_seed": True},
    "check": {"precision": "float32", "control": "tf32",
              "limits": {"sums_gap": 3e-06}},
}


def tiny_cell(name: str):
    """Cell ``name`` at the first 640 sites of its panel, 64 jobs (700 or
    701 pairs a job), batches of 256, a warm-up job of 449 pairs.
    ``asmc_jobs_sums`` is the FastSMC cell's panel and jobs under the ASMC
    entry."""
    from gpubench import harness
    c = harness.load_cell("fastsmc_example_allpairs" if name == "asmc_jobs_sums"
                          else name)
    c.config = copy.deepcopy(c.config)
    c.traffic = copy.deepcopy(c.traffic)
    if name == "asmc_jobs_sums":
        c.name = name
        c.config = dict(copy.deepcopy(ASMC), samples=c.config["samples"],
                        decoding_quantities=c.config["decoding_quantities"])
        c.end_to_end = [m for m in c.end_to_end if m["name"] == "setup_s"]
        c.per_layer = []
    c.config.update(sites=640, jobs=64, batch_size=256)
    c.config.pop("morgans", None)   # the map's length at its 640th site
    c.config["check"]["block_pairs"] = 256
    if "pairs" in c.config["check"]:
        c.config["check"]["pairs"] = 64
    c.traffic["warmup"] = {"jobs": 100, "job": 1}
    return c


@pytest.fixture
def tiny():
    return tiny_cell


@pytest.fixture(scope="session")
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
