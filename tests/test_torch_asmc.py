"""The port's ASMC, and FastSMC without hashing, on the CPU (the kernels'
plain versions) against the JAX package's ASMC and FastSMC on the CPU
(``use_pallas=False``), on the same panels, jobs and batches. Each side
reads the panel with its own loader and runs on its own DecodingParams.

Tolerances: sums over n pairs atol 1e-5 * n (f32 sums in another order);
per-pair posterior means rtol 1e-5 (they are in generations); the
decode_pairs API's whole-chromosome posteriors atol 3e-5 and their means
rtol 5e-5; MAP states equal except at ties within 1e-5; FastSMC records
equal in their first 9 columns, floats rtol 1e-4.

The golden ``tests/fixtures/example_array.asmc_job7of100.npz`` was made by
the JAX package on the CPU, from the repository root, with::

    import numpy as np
    from fastsmc_tpu.config import DecodingParams
    from fastsmc_tpu.io.haps import load_data
    from fastsmc_tpu.pipelines.asmc import ASMC
    root = "artifacts/panels/example_array/example"
    dq = "artifacts/n300.array.decodingQuantities.npz"
    data = load_data(DecodingParams.asmc(root, dq, "x", fastsmc=True,
                                         use_known_seed=True))
    p = DecodingParams.asmc(root, dq, "x", do_posterior_sums=True,
                            do_major_minor_posterior_sums=True,
                            use_known_seed=True, jobs=100, job_ind=7)
    r = ASMC(p, data=data, use_pallas=False,
             batch_size=64).decode_all_in_job(verbose=False)
    np.savez_compressed(
        "tests/fixtures/example_array.asmc_job7of100.npz",
        **{f: getattr(r, f) for f in ("sum_over_pairs", "sum_over_pairs00",
                                      "sum_over_pairs01", "sum_over_pairs11")})

(the whole 150-sample panel, pairs 2,691..3,138 of the flat enumeration).
"""

import gzip

import numpy as np
import pytest
import torch

from fastsmc_tpu.config import DecodingParams as JaxParams
from fastsmc_tpu.io.haps import load_data as jax_load_data
from fastsmc_tpu.pipelines import asmc as jax_asmc
from fastsmc_tpu.pipelines.asmc import ASMC as JaxASMC
from fastsmc_tpu.pipelines.fastsmc import FastSMC as JaxFastSMC

import fastsmc_tpu_torch
from fastsmc_tpu_torch.config import DecodingParams
from fastsmc_tpu_torch.engine import kernels
from fastsmc_tpu_torch.io.haps import load_data
from fastsmc_tpu_torch.pipelines import asmc

SUMS = ("sum_over_pairs", "sum_over_pairs00", "sum_over_pairs01",
        "sum_over_pairs11")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain versions run many small ops per site: one intra-op thread
    runs them faster than many, and keeps parallel test workers from
    contending for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def panel(synthetic_panel_root):
    """The 150-sample, 640-site synthetic panel's root and decoding
    quantities' path, and the panel loaded whole (its map is in FastSMC's
    format) by the port and by the JAX package."""
    root, dq, d = synthetic_panel_root
    args = (root, dq, str(d / "load"))
    return (root, dq,
            load_data(DecodingParams.asmc(*args, fastsmc=True,
                                          use_known_seed=True)),
            jax_load_data(JaxParams.asmc(*args, fastsmc=True,
                                         use_known_seed=True)))


def _params(panel, out, cls=DecodingParams, **kw):
    root, dq = panel[:2]
    return cls.asmc(root, dq, str(out), use_known_seed=True, **kw)


def _pair(panel, out, batch_size=64, **kw):
    """(port on the CPU, JAX package on the CPU) over the same panel."""
    port = asmc.ASMC(_params(panel, out / "port", **kw), data=panel[2],
                     device="cpu", batch_size=batch_size)
    ref = JaxASMC(_params(panel, out / "jax", JaxParams, **kw),
                  data=panel[3], use_pallas=False, batch_size=batch_size)
    return port, ref


def _assert_sums(got, want, n_pairs, fields=SUMS):
    for f in fields:
        g, w = getattr(got, f), getattr(want, f)
        assert g.shape == w.shape and g.dtype == w.dtype == np.float32, f
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * n_pairs,
                                   err_msg=f)


def _assert_maps_match(got, want, post):
    """MAP rows [n, L] equal, except where the posterior ``post`` [L, K, n]
    holds the two states within 1e-5 of each other: a tie that f32 sums
    taken in another order may break the other way."""
    i, t = np.nonzero(got != want)
    gap = (post[t, want[i, t].astype(int), i]
           - post[t, got[i, t].astype(int), i])
    assert len(gap) <= 1e-4 * got.size, len(gap)
    assert len(gap) == 0 or np.abs(gap).max() <= 1e-5, gap


def test_copied_helpers_equal_jax():
    rng = np.random.default_rng(0)
    for within_only in (False, True):
        tot = 150 if within_only else 2 * 150 * 150 - 150
        idx = np.concatenate([rng.integers(0, tot, 500), [0, tot - 1]])
        got = asmc.ASMC.pairs_from_flat_indices(idx, within_only)
        want = JaxASMC.pairs_from_flat_indices(idx, within_only)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    for h in range(8):
        assert asmc.hap_to_dip_id(h) == jax_asmc.hap_to_dip_id(h)
    for ind in range(4):
        for hap in (1, 2):
            assert asmc.dip_to_hap_id(ind, hap) == \
                jax_asmc.dip_to_hap_id(ind, hap)
    for s in ("ind3#1", "a#b#2", "x#2"):
        assert asmc.combined_id_to_ind_plus_hap(s) == \
            jax_asmc.combined_id_to_ind_plus_hap(s)
    for bad in ("ind3", "#1", "ind3#3"):
        with pytest.raises(ValueError):
            asmc.combined_id_to_ind_plus_hap(bad)
    import dataclasses
    for cls in ("DecodingReturnValues", "DecodePairsReturnStruct"):
        got = [(f.name, f.default) for f in
               dataclasses.fields(getattr(asmc, cls))]
        want = [(f.name, f.default) for f in
                dataclasses.fields(getattr(jax_asmc, cls))]
        assert got == want, cls


def test_decode_all_in_job_matches_jax(panel, tmp_path):
    """jobs=200, job 3: 224 pairs in batches of 64, the last one partial
    (32 pairs, decoded as they are by the port, padded and corrected by
    the JAX package); then write_outputs' files."""
    kw = dict(do_posterior_sums=True, do_major_minor_posterior_sums=True,
              jobs=200, job_ind=3)
    port, ref = _pair(panel, tmp_path, **kw)
    start, end = port._job_pair_range()
    assert (start, end) == ref._job_pair_range() and end - start == 224
    assert port._job_pairs() == ref._job_pairs()
    before = dict(kernels.LAUNCHES)
    got = port.decode_all_in_job(verbose=False)
    assert dict(kernels.LAUNCHES) == before       # CPU: plain versions
    want = ref.decode_all_in_job(verbose=False)
    _assert_sums(got, want, 224)
    assert (got.sites, got.states) == (want.sites, want.states)
    np.testing.assert_array_equal(got.site_was_flipped,
                                  want.site_was_flipped)
    np.testing.assert_allclose(got.sum_over_pairs.sum(1), 224, rtol=1e-5)
    port.write_outputs(got)
    ref.write_outputs(want)
    for suffix in ("sumOverPairs", "00.sumOverPairs", "01.sumOverPairs",
                   "11.sumOverPairs"):
        g, w = (np.loadtxt(str(tmp_path / side) + f".{suffix}.gz")
                for side in ("port", "jax"))
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5 * 224,
                                   err_msg=suffix)


def test_per_pair_streams_match_jax(panel, tmp_path):
    """within_only: the 150 within-sample pairs in batches of 64, 64, 22;
    .perPairPosteriorMeans.gz and .perPairMAP.gz."""
    kw = dict(do_per_pair_posterior_mean=True, do_per_pair_map=True,
              within_only=True)
    port, ref = _pair(panel, tmp_path, **kw)
    port.decode_all_in_job(verbose=False)
    ref.decode_all_in_job(verbose=False)
    L = panel[2].sites
    for kind in ("perPairPosteriorMeans", "perPairMAP"):
        g, w = (np.loadtxt(str(tmp_path / side) + f".{kind}.gz")
                for side in ("port", "jax"))
        assert g.shape == w.shape == (150, L), kind
        if kind == "perPairMAP":
            h = np.arange(150, dtype=np.int32)
            post = port._full_posterior(2 * h, 2 * h + 1, L)
            _assert_maps_match(g, w, post)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5)


def test_expected_coal_times_file_doubles_means(panel, tmp_path):
    kw = dict(do_per_pair_posterior_mean=True, within_only=True,
              jobs=5, job_ind=2)
    port = asmc.ASMC(_params(panel, tmp_path / "a", **kw), data=panel[2],
                     device="cpu")
    port.decode_all_in_job(verbose=False)
    ect = tmp_path / "times.intervalsInfo"
    with open(ect, "w") as fh:
        for k, t in enumerate(port.dq.expected_times):
            fh.write(f"{k}\t{2.0 * t}\t{k + 1}\n")
    port2 = asmc.ASMC(_params(panel, tmp_path / "b",
                              expected_coal_times_file=str(ect), **kw),
                      data=panel[2], device="cpu")
    np.testing.assert_allclose(
        port2.decoder.tables.exp_times[:port.dq.states].numpy(),
        2.0 * port.dq.expected_times, rtol=1e-6)
    port2.decode_all_in_job(verbose=False)
    m1 = np.loadtxt(str(tmp_path / "a") + ".perPairPosteriorMeans.gz")
    m2 = np.loadtxt(str(tmp_path / "b") + ".perPairPosteriorMeans.gz")
    assert m1.shape == (30, panel[2].sites)
    np.testing.assert_allclose(m2, 2.0 * m1, rtol=1e-5)


def test_decode_all_chunked_matches_jax(panel, tmp_path):
    """Three 256-site chunks with 2 cM halos; 224 pairs, batch 64."""
    port, ref = _pair(panel, tmp_path, do_posterior_sums=True, jobs=200,
                      job_ind=5)
    got = port.decode_all_in_job(verbose=False, chunk_sites=256)
    want = ref.decode_all_in_job(verbose=False, chunk_sites=256)
    _assert_sums(got, want, 224, ("sum_over_pairs",))
    assert got.sum_over_pairs00 is None and want.sum_over_pairs00 is None


def test_decode_pairs_api_matches_jax(panel, tmp_path):
    """Every field of DecodePairsReturnStruct; pairs by index and by
    ``<iid>#<hap>``."""
    port, ref = _pair(panel, tmp_path)
    a, b = [1, "ind2#2", 8, 100], [2, "ind3#1", 9, 205]
    got = port.decode_pairs(a, b, per_pair_posteriors=True,
                            sum_of_posteriors=True)
    want = ref.decode_pairs(a, b, per_pair_posteriors=True,
                            sum_of_posteriors=True)
    assert got.per_pair_indices == want.per_pair_indices
    assert got.per_pair_indices[1] == (5, "ind2#2", 6, "ind3#1")
    # posteriors scaled by each state's expected time: unscale to compare;
    # atol 3e-5 per pair: f32 differences grow over the whole 1,024-site
    # window (1.4e-5 seen here, under 1e-5 on the 64-128-site windows of
    # test_torch_kernels.py)
    expt = port.expected_coal_times[:, None]
    for f, n in (("per_pair_posteriors", 1), ("sum_of_posteriors", 4)):
        g, w = getattr(got, f), getattr(want, f)
        assert g.shape == w.shape, f
        np.testing.assert_allclose(g / expt, w / expt, rtol=0, atol=3e-5 * n,
                                   err_msg=f)
    for f in ("per_pair_posterior_means", "min_posterior_means"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=5e-5, err_msg=f)
    for f in ("argmin_posterior_means", "per_pair_maps", "min_maps",
              "argmin_maps"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    assert got.per_pair_maps.dtype == np.int32
    with pytest.raises(ValueError):
        port.decode_pairs([1], [2, 3])


def test_example_array_reproduces_jax_golden(repo_root, tmp_path):
    """The JAX-made sums of pairs 2,691..3,138 (jobs=100, job 7) of the
    example panel, decoded in one batch of 448 on the CPU."""
    root = str(repo_root / "artifacts" / "panels" / "example_array"
               / "example")
    dq = str(repo_root / "artifacts" / "n300.array.decodingQuantities.npz")
    data = load_data(DecodingParams.asmc(root, dq, str(tmp_path / "l"),
                                         fastsmc=True, use_known_seed=True))
    p = DecodingParams.asmc(root, dq, str(tmp_path / "g"),
                            do_posterior_sums=True,
                            do_major_minor_posterior_sums=True,
                            use_known_seed=True, jobs=100, job_ind=7)
    a = fastsmc_tpu_torch.ASMC(p, data=data, device="cpu", batch_size=448)
    assert a._job_pair_range() == (2691, 3139)
    got = a.decode_all_in_job(verbose=False)
    want = np.load(repo_root / "tests" / "fixtures"
                   / "example_array.asmc_job7of100.npz")
    for f in SUMS:
        assert getattr(got, f).shape == want[f].shape == (6759, 69)
        np.testing.assert_allclose(getattr(got, f), want[f], rtol=0,
                                   atol=1e-5 * 448, err_msg=f)


def test_no_batches_takes_the_oracle(panel, tmp_path):
    """params.no_batches decodes pair by pair with the scalar
    OracleDecoder (the port's copy of the JAX package's); its outputs
    equal the kernel path's plain versions."""
    kw = dict(do_posterior_sums=True, do_major_minor_posterior_sums=True,
              do_per_pair_posterior_mean=True, do_per_pair_map=True,
              within_only=True, jobs=50, job_ind=4)
    res = {}
    for tag, nb in (("plain", False), ("oracle", True)):
        a = asmc.ASMC(_params(panel, tmp_path / tag, no_batches=nb, **kw),
                      data=panel[2], device="cpu")
        assert type(a.decoder).__name__ == \
            ("OracleDecoder" if nb else "GpuDecoder")
        res[tag] = a.decode_all_in_job(verbose=False)
    _assert_sums(res["oracle"], res["plain"], 3)
    for kind in ("perPairPosteriorMeans", "perPairMAP"):
        g, w = (np.loadtxt(str(tmp_path / tag) + f".{kind}.gz")
                for tag in ("oracle", "plain"))
        np.testing.assert_allclose(g, w, rtol=1e-5, err_msg=kind)


def test_batch_shrinks_to_the_memory_budget(panel, tmp_path):
    """A batch takes at most half the device's free memory, in whole
    32-pair blocks; on the CPU the batch is not capped."""
    # 640 sites -> 1,024-site window, 72 padded states: 332 KiB a pair
    assert asmc.max_batch(200 << 20, 640, 69) == 288
    assert asmc.max_batch(1 << 20, 640, 69) == kernels.PAIRS_PER_BLOCK
    # a whole-chromosome window (8,192 sites) with 79 GiB free
    assert asmc.max_batch(79 << 30, 6400, 69) == 15584
    a = asmc.ASMC(_params(panel, tmp_path / "m"), data=panel[2],
                  device="cpu", batch_size=8192)
    assert a.batch_size == 8192


def _records(path):
    with gzip.open(path, "rt") as fh:
        return [line.split("\t") for line in fh.read().splitlines()]


def test_fastsmc_no_hashing_matches_jax(panel, tmp_path):
    """No hashing: job 2 of 100 (449 pairs of the whole panel) in batches
    of 224, 224 and 1, decoded over the whole chromosome; the same
    records in the same order as the JAX package's."""
    root, dq, data, jax_data = panel

    def params(tag, cls=DecodingParams):
        return cls.fastsmc_defaults(
            root, dq, str(tmp_path / tag), use_known_seed=True,
            hashing=False, jobs=100, job_ind=2, batch_size=224)

    want = _records(JaxFastSMC(params("jax", JaxParams), data=jax_data,
                               use_pallas=False).run(verbose=False))
    port = fastsmc_tpu_torch.FastSMC(params("port"), data=data, device="cpu")
    before = dict(kernels.LAUNCHES)
    got = _records(port.run(verbose=False))
    assert dict(kernels.LAUNCHES) == before
    assert got and len(got[0]) == 13
    assert [r[:9] for r in got] == [r[:9] for r in want]
    g = np.array([[float(x) for x in r[9:]] for r in got])
    w = np.array([[float(x) for x in r[9:]] for r in want])
    np.testing.assert_allclose(g, w, rtol=1e-4)
    assert port._cpt == 449 and port.n_segments == len(got)
