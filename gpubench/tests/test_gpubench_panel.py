"""The traffic generator: the same seed gives the same panel and jobs,
another seed another, at the same sizes and statistics."""

import gzip

import numpy as np
import pytest
import torch

from gpubench import harness, panel
from gpubench.tests.conftest import tiny_cell

SPEC = dict(harness.panel_spec(tiny_cell("asmc_jobs_sums")), haplotypes=512,
            mosaic=True, switch_per_morgan=133.3, noise=0.0)


def test_same_seed_same_panel_other_seed_other():
    a = panel.make_panel(SPEC, 2 ** 32 + 5, "cpu")
    b = panel.make_panel(SPEC, 2 ** 32 + 5, "cpu")
    c = panel.make_panel(SPEC, 2 ** 32 + 6, "cpu")
    assert torch.equal(a.bits, b.bits) and np.array_equal(a.dac, b.dac)
    assert not torch.equal(a.bits, c.bits)
    assert a.bits.shape == c.bits.shape == (512, 640)


def test_panel_is_folded_with_its_counts():
    p = panel.make_panel(SPEC, 7, "cpu")
    dac = p.bits.sum(0).numpy()
    assert np.array_equal(dac, p.dac) and (dac <= 256).all()


def test_sites_and_alleles_are_the_founders():
    """The source panel's positions and map; every haplotype's alleles at
    a site are among the founders' there (no noise is added), and the
    frequencies follow the founders'."""
    p = panel.make_panel(SPEC, 11, "cpu")
    alleles, phys, morgans = panel.read_founders(
        SPEC["hap_path"], SPEC["map_path"], 640)
    assert alleles.shape == (300, 640)
    assert np.array_equal(p.physical_positions, phys)
    assert np.array_equal(p.genetic_positions, morgans)
    with gzip.open(SPEC["hap_path"], "rt") as f:
        first = f.readline().split()
    assert phys[0] == int(first[2])
    assert np.array_equal(alleles[:, 0], np.asarray(first[5:], np.uint8))
    unfolded = p.bits.numpy() ^ p.flipped[None, :].astype(np.uint8)
    have = alleles.max(0), alleles.min(0)
    assert ((unfolded <= have[0]) & (unfolded >= have[1])).all()
    f_src, f_new = alleles.mean(0), unfolded.mean(0)
    assert np.corrcoef(f_src, f_new)[0, 1] > 0.95


def test_switches_follow_the_map():
    """Neighbouring sites copy the same founder but at a switch, whose
    chance grows with the genetic distance between them."""
    spec = dict(SPEC, switch_per_morgan=0.0)
    p = panel.make_panel(spec, 3, "cpu")
    alleles, _, _ = panel.read_founders(SPEC["hap_path"], SPEC["map_path"],
                                        640)
    unfolded = p.bits.numpy() ^ p.flipped[None, :].astype(np.uint8)
    # no switch: every haplotype is one founder throughout
    rows = {r.tobytes() for r in alleles}
    assert all(r.tobytes() in rows for r in unfolded[:32])


def test_the_source_panel_as_it_is():
    """``"mosaic": false``: the source's own haplotypes, folded."""
    spec = dict(SPEC, haplotypes=300, mosaic=False)
    p = panel.make_panel(spec, 1, "cpu")
    q = panel.make_panel(spec, 2, "cpu")
    alleles, _, _ = panel.read_founders(SPEC["hap_path"], SPEC["map_path"],
                                        640)
    assert torch.equal(p.bits, q.bits)
    assert np.array_equal(p.bits.numpy() ^ p.flipped[None].astype(np.uint8),
                          alleles)
    with pytest.raises(ValueError):
        panel.make_panel(dict(spec, haplotypes=512), 1, "cpu")


def test_jobs_run_consecutively_from_a_seeded_start():
    a = panel.job_sequence(256, 123456789012)
    assert a == panel.job_sequence(256, 123456789012)
    assert sorted(a) == list(range(1, 257))
    assert all((y - x) % 256 == 1 for x, y in zip(a, a[1:]))
    starts = {panel.job_sequence(256, s)[0] for s in range(40)}
    assert len(starts) > 20
