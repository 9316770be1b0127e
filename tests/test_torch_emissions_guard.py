"""The port's guard on its CSFS emissions (``engine/emissions.py``): no
class emission is negative, and the class sums the kernels and the oracle
form equal the benchmark reference's ``class_emissions`` bit for bit on
the n300 tables, on ASMC's example panel and on a 1,024-haplotype mosaic
of it; each of the guard's two steps is needed."""

import dataclasses

import numpy as np
import pytest

import fastsmc_tpu_torch as sut
from fastsmc_tpu_torch.config import DecodingParams
from fastsmc_tpu_torch.engine import emissions
from fastsmc_tpu_torch.engine.oracle import DecodeContext
from fastsmc_tpu_torch.io.decoding_quantities import DecodingQuantities
from fastsmc_tpu_torch.io.haps import load_data
from gpubench import harness, panel
from gpubench.reference import model

SHIPPED = ("n300.array.decodingQuantities.npz",
           "example.decodingQuantities.npz",
           "panels/example_array/example.decodingQuantities.gz")


def _dq_path(repo_root):
    return str(repo_root / "artifacts" / SHIPPED[0])


def _setup(name, repo_root):
    """(params, Data) of ``name``: the example panel in array, sequence
    or unfolded array mode, or a 1,024-haplotype, 640-site mosaic of it
    drawn as the ``asmc_jobs_sums`` cell draws its panel (seed 1)."""
    dq = _dq_path(repo_root)
    if name == "mosaic":
        cell = harness.load_cell("asmc_jobs_sums")
        spec = harness.panel_spec(cell)
        spec.update(haplotypes=1024, sites=640)
        spec.pop("morgans")
        pan = panel.make_panel(spec, 1, "cpu")
        p = DecodingParams(in_file_root="x", decoding_quant_file=dq,
                           **cell.config["params"]).finalize()
        return p, harness.program_data(sut, pan)
    root = str(repo_root / "artifacts" / "panels" / "example_array" /
               "example")
    kw = {"example sequence": dict(decoding_mode="sequence"),
          "example unfolded": dict(use_ancestral=True)}.get(name, {})
    p = DecodingParams.asmc(root, dq, fastsmc=True, use_known_seed=True,
                            **kw)
    return p, load_data(p)


def _emissions(name, repo_root, dq=None):
    p, data = _setup(name, repo_root)
    dq = dq or DecodingQuantities.load(_dq_path(repo_root))
    return DecodeContext.build(p, data, dq).emissions


def class_sums(e) -> np.ndarray:
    """float32 [sites, 3, K]: differ, both major, both minor, added as the
    kernels and the oracle add the components."""
    major = e.em1 + e.em0minus1
    return np.stack([e.em1, major, major + e.em2minus0], axis=1)


@pytest.mark.parametrize("name", ["example", "mosaic"])
def test_class_sums_equal_the_reference(name, repo_root):
    e = _emissions(name, repo_root)
    assert e.use_csfs_at.all()
    table = DecodingQuantities.load(_dq_path(repo_root)) \
        .folded_ascertained_csfs
    want = model.class_emissions(np.asarray(table, np.float32),
                                 e.undistinguished)
    got = class_sums(e)
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got, want)


@pytest.mark.parametrize("name", ["example", "example sequence",
                                  "example unfolded", "mosaic"])
def test_no_class_emission_is_negative(name, repo_root):
    e = _emissions(name, repo_root)
    assert e.use_csfs_at.any()
    assert class_sums(e).min() >= 0


@pytest.mark.parametrize("name", SHIPPED)
def test_shipped_classic_tables_hold_no_negatives(name, repo_root):
    """The guard leaves the classic tables as they are: they need none."""
    dq = DecodingQuantities.load(str(repo_root / "artifacts" / name))
    assert dq.classic_emission.min() > 0
    assert dq.compressed_emission.min() > 0


def test_without_the_table_step_a_differ_emission_is_negative(
        repo_root, monkeypatch):
    """The example panel reads the n300 table's rounding negatives in the
    differ class, at young states, which only the table step zeroes."""
    assert class_sums(_emissions("example", repo_root))[:, 0].min() == 0
    monkeypatch.setattr(emissions, "nonnegative", lambda x: x)
    assert class_sums(_emissions("example", repo_root))[:, 0].min() < 0


def test_table_is_guarded_before_the_sums(repo_root, monkeypatch):
    """The table's negatives are zeroed before the float32 sums, not only
    the sums after: a differ entry of -3e-8 beside a both-major entry of
    1 leaves both major at 1 exactly (the raw sum rounds to 1 - 2^-24)."""
    dq = DecodingQuantities.load(_dq_path(repo_root))
    und = _emissions("example", repo_root).undistinguished
    u0, u1 = und[0, 0], und[0, 1]
    assert u0 >= 0 and u1 >= 0 and u0 != u1
    table = dq.folded_ascertained_csfs.copy()
    table[u1, 1, 0], table[u0, 0, 0] = -3e-8, 1.0
    dq = dataclasses.replace(dq, folded_ascertained_csfs=table)
    assert class_sums(_emissions("example", repo_root, dq))[0, 1, 0] == 1.0
    monkeypatch.setattr(emissions, "nonnegative", lambda x: x)
    assert class_sums(_emissions("example", repo_root, dq))[0, 1, 0] \
        == np.float32(1 - 2 ** -24)


def test_without_the_sum_step_a_both_minor_emission_is_negative(
        repo_root, monkeypatch):
    """On the mosaic, sites whose drawn [u2][0] lies below the rounding
    of [u0][0] give a negative both-minor float32 sum from a table of no
    negatives, which only the class-sum step raises to +0.0."""
    guarded = class_sums(_emissions("mosaic", repo_root))
    monkeypatch.setattr(emissions, "raise_negative_sums",
                        lambda em1, em0minus1, em2minus0:
                        (em0minus1, em2minus0))
    raw = class_sums(_emissions("mosaic", repo_root))
    acted = raw[:, 2] < 0
    assert acted.any() and (guarded[:, 2][acted] == 0).all()
    assert np.array_equal(raw[:, :2], guarded[:, :2])
