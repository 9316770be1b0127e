"""The port's FastSMC entry options and its grouped drain on the CPU (plain
versions of the kernels), against the JAX package's FastSMC
(use_pallas="interpret", flush_group=2; its plain decoder for the budget
split) where the JAX package has the behaviour: arrival-order batches
(bucket_sites=0), sorted batches, permissive windows and the
posterior-budget split give the same record keys in the same order,
floats at test_torch_pipeline's FLOAT_RTOL (1e-4). Resume, the caps sized
from each batch's run counts and the flush group size must not change a
byte of the decompressed output."""

import gzip
import os

import numpy as np
import pytest

from fastsmc_tpu.config import DecodingParams as JaxParams
from fastsmc_tpu.pipelines.fastsmc import FastSMC as JaxFastSMC

import fastsmc_tpu_torch
from fastsmc_tpu_torch.pipelines import fastsmc as pipeline
from fastsmc_tpu_torch.engine import segments as seg
from test_torch_pipeline import (_assert_same_records,  # noqa: F401
                                 _records, _tiny_params, mosaic_panel,
                                 mosaic_params, tiny_panel)


def _bytes(path):
    with gzip.open(path, "rb") as fh:
        return fh.read()


def _params(root, repo_root, out, cls=fastsmc_tpu_torch.DecodingParams,
            **kw):
    kw.setdefault("batch_size", 8)
    return cls.fastsmc_defaults(
        root, str(repo_root / "artifacts" / "n300.array.decodingQuantities.npz"),
        out, use_known_seed=True, min_m=0.5, **kw)


@pytest.fixture(scope="module")
def dense_panel(tmp_path_factory):
    """150 diploid samples x 640 sites with 24 planted IBD pairs (the
    dense panel of tests/test_pipeline.py's resume and budget-split
    tests): a batch holds many candidates and a run many batches."""
    d = tmp_path_factory.mktemp("torch_dense_panel")
    rng = np.random.default_rng(5)
    n_ind, sites = 150, 640
    n_haps = 2 * n_ind
    freqs = rng.uniform(0.05, 0.5, sites)
    bits = (rng.random((n_haps, sites)) < freqs).astype(np.uint8)
    for _ in range(24):
        a, b = rng.choice(n_haps, 2, replace=False)
        s0 = rng.integers(0, 128)
        bits[b, s0:s0 + 448] = bits[a, s0:s0 + 448]
    bp = (np.arange(sites) + 1) * 5000
    cm = np.linspace(0.0, 8.0, sites)
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


OPTIONS = [(dict(sort_batches=4), {}), (dict(bucket_sites=0), {}),
           ({}, dict(permissive_window=True))]


@pytest.mark.parametrize("kw,pkw", OPTIONS,
                         ids=["sort_batches=4", "bucket_sites=0",
                              "permissive_window"])
def test_option_matches_jax(dense_panel, repo_root, tmp_path, kw, pkw):
    want = _records(JaxFastSMC(
        _params(dense_panel, repo_root, str(tmp_path / "jax"), JaxParams,
                **pkw),
        use_pallas="interpret", flush_group=2, **kw).run(verbose=False))
    port = fastsmc_tpu_torch.FastSMC(
        _params(dense_panel, repo_root, str(tmp_path / "port"), **pkw),
        device="cpu", **kw)
    got = _records(port.run(verbose=False))
    assert len(want) > 10 and port.stats["flushes"] > 2
    _assert_same_records(got, want)


def test_bucket_sites_with_sort_batches_raises(tiny_panel, repo_root,
                                               tmp_path):
    params = _tiny_params(tiny_panel, repo_root, str(tmp_path / "x"))
    with pytest.raises(ValueError, match="mutually exclusive"):
        fastsmc_tpu_torch.FastSMC(params, device="cpu", sort_batches=4,
                                  bucket_sites=64)
    f = fastsmc_tpu_torch.FastSMC(params, device="cpu", sort_batches=4)
    assert f.bucket_sites == 0


def test_resume_gives_identical_output(dense_panel, repo_root, tmp_path,
                                       monkeypatch):
    """A run killed after a checkpoint, with records of later batches
    already written and a group still pending, resumes in a fresh
    FastSMC to the uninterrupted run's bytes, and leaves no .progress."""
    monkeypatch.setattr(pipeline, "CHECKPOINT_DRAINS", 2)

    def make(tag):
        return fastsmc_tpu_torch.FastSMC(
            _params(dense_panel, repo_root, str(tmp_path / tag)),
            device="cpu", flush_group=1)

    f0 = make("full")
    want = _bytes(f0.run(verbose=False))
    assert f0._batch_idx >= 4

    class Boom(Exception):
        pass

    f1 = make("part")
    drain = f1._drain_group
    drains = []

    def exploding_drain():
        pending = f1._gpending is not None
        drain()
        if pending:
            drains.append(f1.n_segments)
            if len(drains) == 3:
                raise Boom()

    f1._drain_group = exploding_drain
    with pytest.raises(Boom):
        f1.run(verbose=False)
    out = f1.params.ibd_output_path()
    with open(out + ".progress") as fh:
        done, nseg, offset = map(int, fh.read().split())
    # the checkpoint names the two drained batches; the third drain's
    # records follow it in an unfinished member, and batch 4 is in flight
    assert (done, nseg) == (2, drains[1]) and drains[2] > drains[1]
    f1._writer.close()
    assert os.path.getsize(out) > offset

    f2 = make("part")
    got = _bytes(f2.run(verbose=False, resume=True))
    assert f2._resume_skip == 2 and f2.n_segments == f0.n_segments
    assert got == want
    assert not os.path.exists(out + ".progress")


def test_canonical_windows_batch_invariant(synthetic_panel_root, repo_root,
                                           tmp_path):
    """Canonical-window batches (the default) make the records a function
    of the candidate set: identical on a second run, the same keys in
    every batch size (floats to f32 reassociation), and the same
    candidates as arrival order (tests/test_pipeline.py:345)."""
    root = synthetic_panel_root[0]

    def run(tag, batch_size, **kw):
        f = fastsmc_tpu_torch.FastSMC(
            _params(root, repo_root, str(tmp_path / tag),
                    batch_size=batch_size), device="cpu", **kw)
        return f, _records(f.run(verbose=False))

    f1, lines1 = run("bs8", 8)
    _, lines2 = run("bs8_again", 8)
    _, lines3 = run("bs32", 32)
    f0, _ = run("arrival", 8, bucket_sites=0)
    assert lines1 == lines2 and lines1
    assert len(lines1) == len(lines3)
    for g, w in zip(sorted(lines1), sorted(lines3)):
        assert g[:9] == w[:9]
        np.testing.assert_allclose([float(x) for x in g[9:]],
                                   [float(x) for x in w[9:]], rtol=1e-5)
    assert f0._cpt == f1._cpt


@pytest.mark.parametrize("ages", [True, False], ids=["ages", "no_ages"])
def test_tiny_caps_redo_gives_identical_output(mosaic_panel, repo_root,
                                               tmp_path, monkeypatch, ages):
    """Batches with more runs than the JAX package's starting caps (raw
    and kept 4,096; the port's before its caps were counted), in flush
    groups of 2: each batch is extracted once, at caps no smaller than its
    counts, and the output equals, byte for byte, a run whose caps (T*P,
    every site a boundary) no batch can fill. With ages, the records are
    the JAX package's on the same panel and parameters (keys equal, floats
    at FLOAT_RTOL)."""
    counts, caps = [], []
    compact_runs = seg.compact_runs

    def spy(th, s1, rc, cap, kcap, posterior=None):
        counts.append(tuple(rc.counts.tolist()))
        caps.append((cap, kcap))
        return compact_runs(th, s1, rc, cap, kcap, posterior)

    def run(tag):
        params = mosaic_params(mosaic_panel, repo_root, str(tmp_path / tag))
        params.do_per_pair_posterior_mean = params.do_per_pair_map = ages
        f = fastsmc_tpu_torch.FastSMC(params, device="cpu", flush_group=2)
        return f, _bytes(f.run(verbose=False))

    monkeypatch.setattr(seg, "compact_runs", spy)
    f1, got = run("counted")
    n = len(caps)
    monkeypatch.setattr(seg, "sized_caps", lambda _: (1024 * 64, 1024 * 64))
    f0, want = run("whole")
    assert n == 5 and len(caps) == 2 * n
    assert max(c[0] for c in counts) > 8192 and \
        max(c[1] for c in counts) > 4096
    for (n_raw, n_kept), (cap, kcap) in zip(counts[:n], caps[:n]):
        assert n_raw <= cap < n_raw + 256 and n_kept <= kcap < n_kept + 256
    assert f0.stats["overflow_redos"] == f1.stats["overflow_redos"] == 0
    assert got == want and len(want.splitlines()[0].split(b"\t")) == \
        (13 if ages else 11)
    if ages:
        jp = JaxParams.fastsmc_defaults(
            mosaic_panel, str(repo_root / "artifacts" /
                              "n300.array.decodingQuantities.npz"),
            str(tmp_path / "jax"), use_known_seed=True, min_m=0.5, jobs=25,
            job_ind=2, batch_size=64)
        jp.hashing = False
        _assert_same_records(
            _records(f1.params.ibd_output_path()),
            _records(JaxFastSMC(jp, use_pallas="interpret", flush_group=2)
                     .run(verbose=False)))


@pytest.mark.parametrize("group", [1, 2])
def test_flush_group_does_not_change_output(dense_panel, repo_root, tmp_path,
                                            group):
    def run(tag, **kw):
        f = fastsmc_tpu_torch.FastSMC(
            _params(dense_panel, repo_root, str(tmp_path / tag),
                    batch_size=8), device="cpu", bucket_sites=0, **kw)
        return f, _bytes(f.run(verbose=False))

    f8, want = run("default")
    fg, got = run(f"g{group}", flush_group=group)
    assert f8.flush_group == pipeline.DEFAULT_FLUSH_GROUP == 8
    assert fg.flush_group == group and fg.stats["flushes"] > group
    assert got == want


def test_posterior_budget_split_keeps_jax_order(dense_panel, repo_root,
                                                tmp_path):
    """With a budget of 65,536 elements and the pad floor at 8 every batch
    splits down the pair axis (tests/test_pipeline.py:743); the split
    rule is the JAX package's, so the records come in its order. The JAX
    side runs its plain decoder (the split precedes the decode)."""
    def run(cls, params, tag, **kw):
        f = cls(_params(dense_panel, repo_root, str(tmp_path / tag), params,
                        batch_size=1024), **kw)
        f._post_budget = 1 << 16
        f._pad_floor = 8
        return f, _records(f.run(verbose=False))

    fj, want = run(JaxFastSMC, JaxParams, "jax", use_pallas=False)
    fp, got = run(fastsmc_tpu_torch.FastSMC,
                  fastsmc_tpu_torch.DecodingParams, "port", device="cpu")
    assert fp.stats["flushes"] == fj.stats["flushes"] > 4
    _assert_same_records(got, want)


def test_roofline_has_the_jax_keys(tiny_panel, repo_root, tmp_path):
    want = JaxFastSMC(_tiny_params(tiny_panel, repo_root,
                                   str(tmp_path / "jax"), JaxParams),
                      use_pallas=False).roofline()
    f = fastsmc_tpu_torch.FastSMC(
        _tiny_params(tiny_panel, repo_root, str(tmp_path / "port")),
        device="cpu")
    f.run(verbose=False)
    got = f.roofline()
    # the JAX package's keys, then the text writer's pool (its workers,
    # the members it wrote, its busy wall), which the JAX writer lacks,
    # and the waits for the run counts, which the JAX package never reads
    assert list(got) == list(want) + ["writer_workers", "writer_chunks",
                                      "writer_busy_s", "count_wait_s"]
    assert got["d2h_mb"] > 0 and got["scan_thread_s"] > 0
    assert all(v >= 0 for v in got.values())


@pytest.mark.parametrize("tag,kw,pkw", [
    ("sort8", dict(sort_batches=8), {}), ("arrival", dict(bucket_sites=0), {}),
    ("permissive", {}, dict(permissive_window=True))],
    ids=["sort8", "arrival", "permissive"])
def test_example_panel_matches_jax_fixture(repo_root, tmp_path, tag, kw, pkw):
    """The example panel with each option against the JAX package's
    records (tests/fixtures/example_array.<tag>.FastSMC.ibd.gz, made on
    the CPU with its plain decoder), which chip_smoke.py also reads."""
    params = fastsmc_tpu_torch.DecodingParams.fastsmc_defaults(
        str(repo_root / "artifacts" / "panels" / "example_array" / "example"),
        str(repo_root / "artifacts" / "n300.array.decodingQuantities.npz"),
        str(tmp_path / tag), use_known_seed=True, **pkw)
    got = _records(fastsmc_tpu_torch.FastSMC(params, device="cpu", **kw)
                   .run(verbose=False))
    want = _records(str(repo_root / "tests" / "fixtures"
                        / f"example_array.{tag}.FastSMC.ibd.gz"))
    assert len(want) > 1000
    _assert_same_records(got, want)
