"""The plain reference's pieces against the program's on the CPU: the
draws of the undistinguished counts, the emissions and operators, the
pairs of a job, and the decode (tests may import the program; the
reference under gpubench/reference/ does not)."""

import dataclasses

import numpy as np
import pytest
import torch

from fastsmc_tpu_torch.engine.oracle import DecodeContext, decode_pair
from fastsmc_tpu_torch.engine.tables import DecodeTables
from fastsmc_tpu_torch.io.decoding_quantities import DecodingQuantities
from fastsmc_tpu_torch.pipelines.asmc import (job_pair_range,
                                              pairs_from_flat_indices)
from fastsmc_tpu_torch.probes.biobank import make_panel, params_for
from gpubench.harness import ROOT
from gpubench.reference import hmm, ibd, jobs, model

DQ = str(ROOT / "artifacts" / "n300.array.decodingQuantities.npz")
CSFS_TABLES = ("csfs", "folded_csfs", "ascertained_csfs",
               "folded_ascertained_csfs")


def guarded_quantities(path: str) -> DecodingQuantities:
    """The program's quantities with the first step of the reference's
    guard: every negative entry of the four CSFS tables set to 0
    (``model.class_emissions``). The program loads them unguarded, as ASMC
    does."""
    dq = DecodingQuantities.load(path)
    return dataclasses.replace(
        dq, **{k: model.nonnegative(getattr(dq, k)) for k in CSFS_TABLES})


@pytest.fixture(scope="module")
def small():
    data = make_panel(512, seed=4)
    ctx = DecodeContext.build(params_for(512), data,
                              DecodingQuantities.load_npz(DQ))
    m = model.build_model(DQ, data.genetic_positions,
                          data.derived_allele_counts,
                          data.total_samples_count, 1234)
    return data, ctx, m


def test_undistinguished_counts_equal_the_programs(small):
    data, ctx, _ = small
    got = model.undistinguished_counts(
        data.derived_allele_counts, data.total_samples_count, 300, True,
        1234)
    assert np.array_equal(got, ctx.emissions.undistinguished)


def test_undistinguished_counts_past_a_twist_block():
    """A population of 16,382: each shuffle reads thousands of words of
    its generator, past the first block of 624 (and its word 454, where
    a twist written in one pass goes wrong)."""
    data = make_panel(16384, seed=0)
    n = 6
    dac = data.derived_allele_counts[:n]
    tot = data.total_samples_count[:n]
    want = data.calculate_undistinguished_counts(300)[:n]
    assert np.array_equal(
        model.undistinguished_counts(dac, tot, 300, True, 1234), want)


def test_emissions_and_operators_equal_the_programs(small):
    _, ctx, m = small
    t = DecodeTables.from_context(ctx, "cpu")
    K = m.K
    em = t.em.numpy()[:, :, :K].astype(np.float64)
    want = np.stack([em[:, 0], em[:, 0] + em[:, 1],
                     em[:, 0] + em[:, 1] + em[:, 2]], axis=1)
    assert np.abs(m.emission - want).max() < 1e-7
    Mf, Mb, gap = t.Mf.numpy()[:, :K, :K], t.Mb.numpy()[:, :K, :K], \
        t.gap_op.numpy()
    for g in np.unique(gap):
        i = int(np.flatnonzero(gap == g)[0])
        assert np.abs(Mf[g] - m.Tf[m.gap[i]]).max() < 1e-7
        assert np.abs(Mb[g] - m.Tb[m.gap[i]]).max() < 1e-7


@pytest.mark.parametrize("n_ind,jobs_n,job", [(8192, 256, 1), (8192, 256, 97),
                                             (8192, 16384, 2), (150, 7, 7)])
def test_job_pairs_equal_the_programs(n_ind, jobs_n, job):
    from fastsmc_tpu_torch.config import DecodingParams
    p = DecodingParams(jobs=jobs_n, job_ind=job, in_file_root="x")
    p.finalize()
    s, e = jobs.job_range(n_ind, jobs_n, job)
    assert (s, e) == job_pair_range(n_ind, p)
    flat = np.unique(np.concatenate([np.arange(s, min(e, s + 300)),
                                     np.arange(max(s, e - 300), e)]))
    for a, b in zip(jobs.pairs(flat), pairs_from_flat_indices(flat)):
        assert np.array_equal(a, b)


def test_posterior_equals_the_oracle(small):
    data, ctx, m = small
    h1, h2 = np.array([3, 10, 200]), np.array([4, 77, 511])
    dec = hmm.Decoder(m, torch.from_numpy(data.hap_bits), "float64")
    post, cls = dec.posterior(h1, h2)
    for i in range(3):
        want = decode_pair(ctx, int(h1[i]), int(h2[i]))      # [K, L] f32
        assert np.abs(post[:, :, i].numpy() - want.T).max() < 2e-5


def test_tf32_control_moves_the_posterior(small):
    data, _, m = small
    bits = torch.from_numpy(data.hap_bits)
    h1, h2 = np.arange(0, 64), np.arange(64, 128)
    ref, _ = hmm.Decoder(m, bits, "float64").posterior(h1, h2)
    f32, _ = hmm.Decoder(m, bits, "float32").posterior(h1, h2)
    t32, _ = hmm.Decoder(m, bits, "tf32").posterior(h1, h2)
    e32 = (f32.double() - ref).abs().max().item()
    etf = (t32.double() - ref).abs().max().item()
    assert e32 < 1e-4 and etf > 30 * e32


def test_runs_split_at_levels():
    rule = ibd.Rule(1, 2, np.array([0.1, 1.0, 10.0, 100.0]),
                    np.array([10.0, 20.0]), np.array([0.5, 0.5]))
    th = np.array([0.0, 0.2, 0.3, 1.5, 0.05, 0.2])
    post = np.stack([th, 1.0 - th], axis=1)
    a, b, score, mean_age, map_age, _ = ibd.runs(post, rule)
    assert a.tolist() == [1, 3, 5] and b.tolist() == [2, 3, 5]
    assert score.tolist() == pytest.approx([0.25, 1.5, 0.2])
    assert map_age.tolist() == [20.0, 10.0, 20.0]
    got = dict(a=a, b=b, score=score, mean_age=mean_age, map_age=map_age)
    assert ibd.compare_pair(got, post, rule)["boundary_gap"] == 0.0
    got["b"] = np.array([2, 4, 5])          # a record one site too long
    assert ibd.compare_pair(got, post, rule)["boundary_gap"] > 0.4


def test_map_gap_names_the_state_the_age_picks():
    """0 where the MAP age is the reference's; where it names another
    state, how far that state's ratio lies below the best; 1 where it is
    no state's expected time."""
    rule = ibd.Rule(2, 2, np.array([0.1, 1.0, 10.0, 100.0]),
                    np.array([10.0, 20.0]), np.array([0.5, 0.5]))
    post = np.array([[0.3, 0.7], [0.35, 0.65]])
    a, b, score, mean_age, map_age, _ = ibd.runs(post, rule)
    got = dict(a=a, b=b, score=score, mean_age=mean_age, map_age=map_age)
    assert map_age.tolist() == [20.0]
    assert ibd.compare_pair(got, post, rule)["map_gap"] == 0.0
    got["map_age"] = np.array([10.0])       # the neighbouring state
    assert ibd.compare_pair(got, post, rule)["map_gap"] == pytest.approx(
        1.0 - 0.65 / 1.35)
    got["map_age"] = np.array([15.0])
    assert ibd.compare_pair(got, post, rule)["map_gap"] == 1.0


def test_emissions_are_the_float32_sums_of_the_algorithms_tables():
    """On the benchmark's own panel, with its singletons: each class's
    emission is the program's float32 sum of its tables, bit for bit, once
    the program's tables and sums carry the reference's guard."""
    from fastsmc_tpu_torch.config import DecodingParams
    from fastsmc_tpu_torch.io.haps import Data
    from gpubench import harness, panel
    from gpubench.tests.conftest import tiny_cell
    cell = tiny_cell("fastsmc_example_allpairs")
    pan = panel.make_panel(harness.panel_spec(cell), 5, "cpu")
    import fastsmc_tpu_torch as sut
    data = harness.program_data(sut, pan)
    assert isinstance(data, Data) and (pan.dac == 1).any()
    p = DecodingParams(in_file_root="x", decoding_quant_file=DQ,
                       **cell.config["params"]).finalize()
    ctx = DecodeContext.build(p, data, guarded_quantities(DQ))
    m = model.build_model(DQ, pan.genetic_positions, pan.dac,
                          np.full(pan.sites, pan.haplotypes), 1234)
    e = ctx.emissions
    major = e.em1 + e.em0minus1
    # the guard's second step: the class sums zeroed where negative
    want = model.nonnegative(
        np.stack([e.em1, major, major + e.em2minus0], axis=1))
    assert np.array_equal(m.emission, want.astype(np.float64))


def test_class_emissions_have_no_negatives(monkeypatch):
    """Both ways the unguarded float32 emissions go negative: a differ row
    that reads the table's rounding negatives (undistinguished count 11,
    young states), and a both-minor sum that is the rounding of [u0][0]
    where [u2][0] lies far below it (counts 3, 1, 0, old states)."""
    table = np.asarray(np.load(DQ)["folded_ascertained_csfs"], np.float32)
    und = np.array([[12, 11, 10], [3, 1, 0]], np.int64)
    assert model.class_emissions(table, und).min() >= 0
    monkeypatch.setattr(model, "nonnegative", lambda x: x)
    raw = model.class_emissions(table, und)
    assert raw[0, 0].min() < 0 and raw[1, 2].min() < 0


def test_table_is_guarded_before_the_sums(monkeypatch):
    """The table's negatives are zeroed before the float32 sums, not only
    the sums after: a differ entry of -3e-8 beside a both-major entry of 1
    leaves both major at 1 exactly (the raw sum rounds to 1 - 2^-24)."""
    table = np.full((3, 2, 1), 0.5, np.float32)
    table[1, 1, 0], table[0, 0, 0] = -3e-8, 1.0
    und = np.array([[0, 1, 2]], np.int64)
    assert model.class_emissions(table, und)[0, 1, 0] == 1.0
    monkeypatch.setattr(model, "nonnegative", lambda x: x)
    assert model.class_emissions(table, und)[0, 1, 0] == np.float32(
        1 - 2 ** -24)


def test_guarded_posteriors_stay_in_the_unit_interval(monkeypatch):
    """On a 1,024-haplotype mosaic of the example panel (1,000 sites), 256
    pairs decoded in float64: guarded, every posterior lies in [0, 1];
    with ASMC's unguarded tables some go below -1e-6."""
    from gpubench import harness, panel
    traffic = harness.load_cell("fastsmc_example_allpairs").traffic
    f = traffic["panel"]["founders"]
    pan = panel.make_panel(dict(
        haplotypes=1024, sites=1000, mosaic=True, switch_per_morgan=133.3,
        noise=2.65e-4,
        hap_path=harness.checked_file(f["haps"], f["haps_sha256"]),
        map_path=harness.checked_file(f["map"], f["map_sha256"])), 1, "cpu")
    s, e = jobs.job_range(pan.haplotypes // 2, 1, 1)
    rng = np.random.default_rng(0)
    h1, h2 = jobs.pairs(np.sort(rng.choice(e - s, 256, replace=False)))

    def posterior():
        m = model.build_model(DQ, pan.genetic_positions, pan.dac,
                              np.full(pan.sites, pan.haplotypes), 1234)
        return hmm.Decoder(m, pan.bits, "float64").posterior(h1, h2)[0]

    post = posterior()
    assert post.min() >= -1e-12 and post.max() <= 1 + 1e-12
    monkeypatch.setattr(model, "nonnegative", lambda x: x)
    assert posterior().min() < -1e-6
