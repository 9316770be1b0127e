"""The port's FastSMC pipeline on the CPU (plain versions of the kernels)
against the JAX package: the same records (first 9 columns) in the same
order, float columns to rtol 1e-4. Each side runs on its own
DecodingParams, built from the same arguments."""

import gzip
import os

import numpy as np
import pytest
import torch

from fastsmc_tpu.config import DecodingParams as JaxParams

import fastsmc_tpu_torch
from fastsmc_tpu_torch.engine import kernels

FLOAT_RTOL = 1e-4

# one intra-op thread for the plain versions in each pytest-xdist worker
# (every worker collects this module, and the other test_torch_* modules
# import it): with a thread a core in each of N workers the cores are
# oversubscribed N-fold and the port's tests run many times slower
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tiny_panel(tmp_path_factory):
    """150 diploid samples x 256 sites with one planted IBD pair (the
    tiny_panel of tests/test_pipeline.py)."""
    d = tmp_path_factory.mktemp("torch_tiny_panel")
    rng = np.random.default_rng(7)
    n_ind, sites = 150, 256
    freqs = rng.uniform(0.05, 0.5, sites)
    bits = (rng.random((2 * n_ind, sites)) < freqs).astype(np.uint8)
    a, b, s, e = 3, 17, 32, 224
    bits[b, s:e] = bits[a, s:e]
    bp = (np.arange(sites) + 1) * 5000
    cm = np.linspace(0.0, 4.0, sites)
    root = str(d / "panel")
    with gzip.open(root + ".hap.gz", "wt") as f:
        for s in range(sites):
            f.write(f"1 SNP_{s} {bp[s]} A G "
                    + " ".join(str(int(x)) for x in bits[:, s]) + "\n")
    with open(root + ".samples", "w") as f:
        f.write("ID_1 ID_2 missing\n0 0 0\n")
        for i in range(n_ind):
            f.write(f"fam{i} ind{i} 0\n")
    with gzip.open(root + ".map.gz", "wt") as f:
        f.write("pos rate cm\n")
        for s in range(sites):
            f.write(f"{bp[s]}\t0\t{cm[s]}\n")
    return root


def write_mosaic_panel(root: str) -> None:
    """150 diploid samples x 1,024 sites over 16 cM, each haplotype a
    mosaic of 8 founders that switches with chance 0.02 a site, plus 0.2 %
    of alleles flipped: every pair shares long stretches, so a batch of 64
    pairs over the whole panel has ~10,000 level boundaries and ~6,500
    kept runs, more than the extraction caps the JAX package starts at
    (raw 4,096, kept 4,096)."""
    rng = np.random.default_rng(3)
    n_haps, sites = 300, 1024
    founders = (rng.random((8, sites))
                < rng.uniform(0.05, 0.5, sites)).astype(np.uint8)
    src = np.empty((n_haps, sites), np.int64)
    cur = rng.integers(0, 8, n_haps)
    for s in range(sites):
        switch = rng.random(n_haps) < 0.02
        cur = np.where(switch, rng.integers(0, 8, n_haps), cur)
        src[:, s] = cur
    bits = founders[src, np.arange(sites)] ^ (rng.random((n_haps, sites))
                                              < 0.002)
    bp = (np.arange(sites) + 1) * 5000
    cm = np.linspace(0.0, 16.0, sites)
    with gzip.open(root + ".hap.gz", "wt") as f:
        for s in range(sites):
            f.write(f"1 SNP_{s} {bp[s]} A G "
                    + " ".join(str(int(x)) for x in bits[:, s]) + "\n")
    with open(root + ".samples", "w") as f:
        f.write("ID_1 ID_2 missing\n0 0 0\n")
        for i in range(n_haps // 2):
            f.write(f"fam{i} ind{i} 0\n")
    with gzip.open(root + ".map.gz", "wt") as f:
        f.write("pos rate cm\n")
        for s in range(sites):
            f.write(f"{bp[s]}\t0\t{cm[s]}\n")


@pytest.fixture(scope="module")
def mosaic_panel(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_mosaic_panel") / "panel")
    write_mosaic_panel(root)
    return root


def mosaic_params(root, repo_root, out, batch_size=64, **kw):
    """FastSMC without hashing on :func:`write_mosaic_panel`'s panel, job 2
    of 25: 286 pairs, 5 batches of up to 64 over all 1,024 sites."""
    p = fastsmc_tpu_torch.DecodingParams.fastsmc_defaults(
        root, str(repo_root / "artifacts" / "n300.array.decodingQuantities.npz"),
        out, use_known_seed=True, min_m=0.5, jobs=25, job_ind=2,
        batch_size=batch_size, **kw)
    p.hashing = False
    return p


def _records(path):
    with gzip.open(path, "rt") as fh:
        return [line.split("\t") for line in fh.read().splitlines()]


def _assert_same_records(got, want):
    assert [r[:9] for r in got] == [r[:9] for r in want]
    g = np.array([[float(x) for x in r[9:]] for r in got])
    w = np.array([[float(x) for x in r[9:]] for r in want])
    np.testing.assert_allclose(g, w, rtol=FLOAT_RTOL)


def _tiny_params(root, repo_root, out,
                 cls=fastsmc_tpu_torch.DecodingParams, **kw):
    kw.setdefault("batch_size", 16)
    return cls.fastsmc_defaults(
        root, str(repo_root / "artifacts" / "n300.array.decodingQuantities.npz"),
        out, use_known_seed=True, min_m=0.5, **kw)


def test_tiny_panel_matches_jax_pipeline(tiny_panel, repo_root, tmp_path):
    from fastsmc_tpu.pipelines.fastsmc import FastSMC as JaxFastSMC

    want = _records(JaxFastSMC(
        _tiny_params(tiny_panel, repo_root, str(tmp_path / "jax"),
                     JaxParams),
        use_pallas="interpret", flush_group=2).run(verbose=False))
    port = fastsmc_tpu_torch.FastSMC(
        _tiny_params(tiny_panel, repo_root, str(tmp_path / "port")),
        device="cpu")
    before = dict(kernels.LAUNCHES)
    got = _records(port.run(verbose=False))
    assert dict(kernels.LAUNCHES) == before
    assert got and len(got[0]) == 13
    _assert_same_records(got, want)
    assert port._cpt > 0 and port.n_segments == len(got)


def test_example_array_matches_golden(repo_root, tmp_path):
    """The TPU-made golden of the example panel: 1,392 records, the same
    keys in the same order, float columns to rtol 1e-4."""
    params = fastsmc_tpu_torch.DecodingParams.fastsmc_defaults(
        str(repo_root / "artifacts" / "panels" / "example_array" / "example"),
        str(repo_root / "artifacts" / "n300.array.decodingQuantities.npz"),
        str(tmp_path / "ex"), use_known_seed=True)
    got = _records(fastsmc_tpu_torch.FastSMC(params, device="cpu")
                   .run(verbose=False))
    want = _records(str(repo_root / "tests" / "fixtures"
                        / "example_array.golden.FastSMC.ibd.gz"))
    assert len(want) == 1392
    _assert_same_records(got, want)


OFF_PATH = [dict(hashing_backend="device")]


@pytest.mark.parametrize("kw", OFF_PATH, ids=lambda kw: str(kw))
def test_off_path_options_raise(tiny_panel, repo_root, tmp_path, kw):
    params = _tiny_params(tiny_panel, repo_root, str(tmp_path / "x"))
    with pytest.raises(NotImplementedError):
        fastsmc_tpu_torch.FastSMC(params, device="cpu", **kw)


def test_cuda_without_cuda_raises(tiny_panel, repo_root, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        fastsmc_tpu_torch.FastSMC(
            _tiny_params(tiny_panel, repo_root, str(tmp_path / "c")))
