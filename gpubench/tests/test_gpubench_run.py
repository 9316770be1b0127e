"""A whole run of each cell on the CPU at a small size (the plain versions
of the kernels; the look for a card skipped): sound, it is correct; with
the timed path broken underneath, it is not; and the control, the plain
reference in TF32 put in the program's place, fails the check."""

import time

import numpy as np
import pytest

import fastsmc_tpu_torch as sut
from fastsmc_tpu_torch.pipelines.asmc import ASMC
from fastsmc_tpu_torch.pipelines.fastsmc import FastSMC
from gpubench import checks, harness, panel
from gpubench.reference.model import build_model

CELLS = ("asmc_jobs_sums", "fastsmc_example_allpairs")
SEED = 2 ** 33 + 17


def run(cell, tmp_path, seconds=1.0):
    return harness.run_cell(cell, SEED, seconds, False, "cpu", time.time(),
                            sut, str(tmp_path))


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name, tiny, tmp_path):
    cell = tiny(name)
    res = run(cell, tmp_path)
    assert res["correct"], res["check"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert list(tmp_path.iterdir()) == []        # outputs removed


def _half_asmc(monkeypatch):
    """ASMC's batches decode half their pairs; sums scaled to the batch."""
    orig = ASMC._decode

    def half(self, h1, h2, t0, t_len, outs):
        k = (len(h1) + 1) // 2
        r = orig(self, h1[:k], h2[:k], t0, t_len, outs)
        return {n: v * (len(h1) / k) for n, v in r.items()}
    monkeypatch.setattr(ASMC, "_decode", half)


def _altered_asmc(monkeypatch):
    """One site's sums of each batch raised by 1 % where produced."""
    orig = ASMC._decode

    def altered(self, h1, h2, t0, t_len, outs):
        r = orig(self, h1, h2, t0, t_len, outs)
        r["posterior_sums"][7] *= 1.01
        return r
    monkeypatch.setattr(ASMC, "_decode", altered)


def _half_fastsmc(monkeypatch):
    """FastSMC writes the records of the first half of each batch only."""
    orig = FastSMC._emit_runs

    def half(self, e, pair, a, b, score_sum, ages=None):
        keep = pair < e["n"] // 2
        return orig(self, e, pair[keep], a[keep], b[keep], score_sum[keep],
                    None if ages is None else ages[:, keep])
    monkeypatch.setattr(FastSMC, "_emit_runs", half)


def _altered_fastsmc(monkeypatch):
    """Every record's score raised by 1 % where it is produced."""
    orig = FastSMC._emit_runs

    def altered(self, e, pair, a, b, score_sum, ages=None):
        return orig(self, e, pair, a, b, score_sum * np.float32(1.01), ages)
    monkeypatch.setattr(FastSMC, "_emit_runs", altered)


def _map_off_by_one_fastsmc(monkeypatch):
    """Every record's MAP age taken one state older where produced."""
    orig = FastSMC._emit_runs

    def shifted(self, e, pair, a, b, score_sum, ages=None):
        if ages is not None:
            times = np.asarray(self.dq.expected_times, np.float32)
            k = np.searchsorted(times, ages[1])
            ages = np.stack([ages[0], times[np.minimum(k + 1,
                                                       len(times) - 1)]])
        return orig(self, e, pair, a, b, score_sum, ages)
    monkeypatch.setattr(FastSMC, "_emit_runs", shifted)


FAULTS = [("asmc_jobs_sums", _half_asmc), ("asmc_jobs_sums", _altered_asmc),
          ("fastsmc_example_allpairs", _half_fastsmc),
          ("fastsmc_example_allpairs", _altered_fastsmc),
          ("fastsmc_example_allpairs", _map_off_by_one_fastsmc)]


@pytest.mark.parametrize("name,fault", FAULTS,
                         ids=[f"{n}-{f.__name__[1:]}" for n, f in FAULTS])
def test_broken_timed_path_is_not_correct(name, fault, tiny, tmp_path,
                                          monkeypatch):
    fault(monkeypatch)
    res = run(tiny(name), tmp_path)
    assert res["attempted"] >= 1 and not res["correct"], res["check"]


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_check(name, tiny):
    cell = tiny(name)
    pan = panel.make_panel(harness.panel_spec(cell), SEED, "cpu")
    model = build_model(harness.dq_file(cell.config), pan.genetic_positions,
                        pan.dac, np.full(pan.sites, pan.haplotypes), 1234)
    jobs = int(cell.config["jobs"])
    got = checks.CONTROLS[cell.config["entry"]](
        cell, pan, model, jobs, panel.job_sequence(jobs, SEED)[0],
        np.random.default_rng(1))
    limits = cell.config["check"]["limits"]
    assert any(got[k] > limits[k] for k in limits), got


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_sound_run_on_the_card(name, tiny, tmp_path, cuda):
    """The same small run through the CUDA kernels (skips without a card:
    the fixture decides)."""
    res = harness.run_cell(tiny(name), SEED, 1.0, True, "cuda", time.time(),
                           sut, str(tmp_path))
    assert res["correct"], res["check"]
    assert res["busy_s"] > 0 and res["breakdown"]["device_ops"]
