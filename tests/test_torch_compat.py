"""The port's reference-module surface (``fastsmc_tpu_torch.compat``)
against the JAX package's (``fastsmc_tpu.compat``), on the CPU: the mirror
of ``tests/test_compat.py`` on the in-repo example panel, through an
ASMC-format copy of it (``io/inputs.py``; the panel's own map is in FastSMC
format).

The port's ``HMM``, ``ASMC`` and ``FastSMC`` decode through the kernels'
wrappers, which on ``device="cpu"`` run their plain versions; the JAX side
runs its XLA decoder. Posteriors and per-pair values agree within 1e-5,
sums over P pairs within 1e-5 * P, MAP states are equal but for ties within
1e-5 in the JAX posterior.
"""

import numpy as np
import pytest
import torch

import fastsmc_tpu.compat as jax_compat

import fastsmc_tpu_torch.compat as compat
from fastsmc_tpu_torch.io import writers
from fastsmc_tpu_torch.io.haps import load_data
from fastsmc_tpu_torch.io.inputs import write_asmc_panel

from test_torch_prepare import one_blas_thread  # noqa: F401

ATOL = 1e-5


@pytest.fixture(scope="module")
def files(repo_root, tmp_path_factory):
    """(ASMC-format copy of the example panel, artifact, output dir)."""
    d = tmp_path_factory.mktemp("compat")
    root = write_asmc_panel(str(repo_root / "artifacts" / "panels" /
                                "example_array" / "example"),
                            str(d / "panel" / "example"))
    return root, str(repo_root / "artifacts" /
                     "n300.array.decodingQuantities.npz"), d


def _params(mod, files, **kw):
    root, dq, d = files
    return mod.DecodingParams(root, dq, str(d / "hmm"), doPosteriorSums=True,
                              **kw)


def assert_maps_equal_but_ties(got, want, post):
    """MAP state arrays ``[..., L]`` equal but where ``post`` ``[..., K,
    L]`` holds the two states within ATOL of each other."""
    flip = np.nonzero(got != want)
    if flip[0].size:
        idx = flip[:-1]
        gap = np.abs(post[(*idx, want[flip], flip[-1])]
                     - post[(*idx, got[flip], flip[-1])])
        assert gap.max() <= ATOL


# ---------------------------------------------------------------------------
# the pybind value types
# ---------------------------------------------------------------------------

def test_decoding_params_camel_case():
    """notebooks/fastsmc.ipynb configures params attribute-style with the
    pybind camelCase names (pybind.cpp:146-178)."""
    DecodingMode = compat.DecodingMode
    p = compat.DecodingParams()
    p.decodingQuantFile = "dq.npz"
    p.inFileRoot = "in"
    p.outFileRoot = "out"
    p.decodingModeString = "array"
    p.decodingMode = DecodingMode.arrayFolded
    p.foldData = True
    p.usingCSFS = True
    p.batchSize = 32
    p.recallThreshold = 3
    p.min_m = 1.5
    p.hashing = True
    p.FastSMC = True
    p.BIN_OUT = True
    p.outputIbdSegmentLength = True
    p.time = 50
    p.noConditionalAgeEstimates = True
    p.doPerPairMAP = True
    p.doPerPairPosteriorMean = True
    assert p.validateParamsFastSMC()
    assert p.batch_size == 32 and p.batchSize == 32
    assert p.bin_out and p.BIN_OUT and p.fastsmc and p.FastSMC
    assert p.decodingMode == DecodingMode.arrayFolded
    # the enum is distinct from decodingModeString (DecodingParams.cpp:
    # 502-533): assigning it keeps the string, validate re-derives it
    p.decodingMode = DecodingMode.sequence
    assert p.decodingMode == DecodingMode.sequence
    assert p.decoding_mode == "array" and p.fold_data
    assert p.validateParamsFastSMC()
    assert p.decodingMode == DecodingMode.arrayFolded
    ref = jax_compat.DecodingParams("in", "dq.npz", "out")
    got = compat.DecodingParams("in", "dq.npz", "out")
    assert vars(got) == vars(ref)


def test_decoding_params_rejects_unknown_attrs_and_unflagged_validate():
    p = compat.DecodingParams()
    with pytest.raises(AttributeError):
        p.decodingQuantFlie = "typo.npz"
    with pytest.raises(AttributeError):
        p.batchSzie = 64
    p.inFileRoot = "in"
    assert not p.fastsmc
    with pytest.raises(RuntimeError):
        p.validateParamsFastSMC()


def test_decoding_params_pybind_ctor():
    # positional per the reference 18-arg ctor order (pybind.cpp:121-141)
    p = compat.DecodingParams("in", "dq", "out", 4, 2, "array")
    assert p.inFileRoot == "in" and p.jobs == 4 and p.jobInd == 2
    p2 = compat.DecodingParams("in", "dq", doPosteriorSums=True,
                               withinOnly=True)
    assert p2.doPosteriorSums and p2.withinOnly
    assert vars(p2) == vars(jax_compat.DecodingParams(
        "in", "dq", doPosteriorSums=True, withinOnly=True))
    with pytest.raises(TypeError):
        compat.DecodingParams("in", "dq", bogusArgument=1)
    # the FastSMC overload requires the flag (DecodingParams.cpp:65-70)
    with pytest.raises(RuntimeError):
        compat.DecodingParams(in_dir="a", decoding_quants="b", out_dir="c",
                              FastSMC=False)
    fast = compat.DecodingParams(in_dir="a", decoding_quants="b",
                                 out_dir="c")
    assert vars(fast) == vars(jax_compat.DecodingParams(
        in_dir="a", decoding_quants="b", out_dir="c"))


def test_individual_set_genotype():
    ind = compat.Individual(8)
    ind.setGenotype(1, 3, True)
    ind.setGenotype(2, 5, 1)
    assert ind.genotype1[3] and ind.genotype2[5]
    assert not ind.genotype1[5] and not ind.genotype2[3]
    with pytest.raises(ValueError):
        ind.setGenotype(3, 0, True)


def test_data_surface(files):
    p = _params(compat, files)
    d, ref = compat.Data(p), jax_compat.Data(_params(jax_compat, files))
    native = load_data(p)
    assert d.sites == ref.sites == native.sites == 6759
    assert d.sampleSize == ref.sampleSize == 150
    assert d.haploidSampleSize == ref.haploidSampleSize == 300
    assert d.FamIDList == ref.FamIDList and d.IIDList == ref.IIDList
    assert d.famAndIndNameList == ref.famAndIndNameList
    assert d.famAndIndNameList[0] == f"{d.FamIDList[0]}\t{d.IIDList[0]}"
    for name in ("geneticPositions", "physicalPositions", "recRateAtMarker",
                 "siteWasFlippedDuringFolding"):
        np.testing.assert_array_equal(getattr(d, name), getattr(ref, name))
    assert d.decodingUsesCSFS == ref.decodingUsesCSFS
    for i in (0, 77, 149):
        for g in ("genotype1", "genotype2"):
            np.testing.assert_array_equal(getattr(d.individuals[i], g),
                                          getattr(ref.individuals[i], g))
    assert compat.Data.countHapLines(files[0]) == 6759


def test_decoding_quantities_member_views(files):
    dq = compat.DecodingQuantities(files[1])
    ref = jax_compat.DecodingQuantities(files[1])
    assert dq.states == ref.states == 69
    assert dq.CSFSSamples == ref.CSFSSamples
    for name in ("initialStateProb", "expectedTimes", "columnRatios",
                 "timeVector", "classicEmissionTable",
                 "compressedEmissionTable", "CSFSmap", "foldedCSFSmap",
                 "ascertainedCSFSmap", "foldedAscertainedCSFSmap"):
        np.testing.assert_array_equal(getattr(dq, name), getattr(ref, name))
    for name in ("Dvectors", "Bvectors", "Uvectors", "rowRatioVectors",
                 "homozygousEmissionMap"):
        got, want = getattr(dq, name), getattr(ref, name)
        assert list(got) == list(want), name
        key = list(got)[3]
        np.testing.assert_array_equal(got[key], want[key])


def test_binary_reader_camel_case(files):
    """compat.BinaryDataReader over a .bibd.gz the port's writer made: the
    same lines as the JAX package's reader, and the camelCase fields of the
    port's IbdPairDataLine."""
    path = str(files[2] / "records.bibd.gz")
    rng = np.random.default_rng(5)
    n = 40
    w = writers.IbdBinaryWriter(path, [f"f{i}" for i in range(9)],
                                [f"i{i}" for i in range(9)], 22,
                                True, True, True)
    w.write_block(rng.integers(0, 9, n), rng.integers(1, 3, n),
                  rng.integers(0, 9, n), rng.integers(1, 3, n),
                  rng.integers(0, 10 ** 6, n), rng.integers(10 ** 6, 10 ** 7, n),
                  rng.random(n), rng.random(n), rng.random(n) * 1e4,
                  rng.random(n) * 1e4)
    w.close()
    rd, ref = compat.BinaryDataReader(path), jax_compat.BinaryDataReader(path)
    lines = []
    while rd.moreLinesInFile():
        line = rd.getNextLine()
        assert line.toString() == ref.getNextLine().toString()
        lines.append(line)
    assert not ref.moreLinesInFile() and len(lines) == n
    with pytest.raises(RuntimeError):
        rd.getNextLine()
    first = lines[0]
    assert isinstance(first, compat.IbdPairDataLine)
    assert (first.ind1FamId, first.ind1Id, first.ind1Hap, first.ibdStart,
            first.ibdEnd, first.lengthInCentimorgans, first.ibdScore,
            first.postEst, first.mapEst) == \
        (first.ind1_fam_id, first.ind1_id, first.ind1_hap, first.ibd_start,
         first.ibd_end, first.length_cm, first.score, first.post_est,
         first.map_est)
    first.ibdScore = 0.5
    assert first.score == 0.5 and first.chromosome == 22


def test_preparedecoding_submodule(repo_root, tmp_path):
    """`from asmc.preparedecoding import *` equivalent, on the port's own
    artifact reader."""
    from fastsmc_tpu_torch import preparedecoding as pdec
    from fastsmc_tpu_torch.io.decoding_quantities import DecodingQuantities
    native = DecodingQuantities.load_npz(
        str(repo_root / "artifacts" / "example.decodingQuantities.npz"))
    dq = pdec.DecodingQuantities(native)
    dq.save_intervals(str(tmp_path / "model"))
    assert (tmp_path / "model.intervalsInfo").read_text().count("\n") == 69
    assert dq.states == 69
    assert compat.preparedecoding is pdec


def test_fastsmc_in_dir_kwargs(repo_root):
    """FastSMC(in_dir=..., out_dir=...) keyword ctor (pybind.cpp:233)."""
    panel = str(repo_root / "artifacts" / "panels" / "example_array" /
                "example")
    fs = compat.FastSMC(in_dir=panel, out_dir="out", device="cpu")
    assert fs._params.decoding_quant_file == (
        panel + ".decodingQuantities.gz")
    with pytest.raises(TypeError):
        compat.FastSMC(in_dir=panel)


# ---------------------------------------------------------------------------
# the decoders
# ---------------------------------------------------------------------------

def test_asmc_decode_pairs(files):
    root, dq, d = files
    a = compat.ASMC(root, dq, str(d / "asmc"), device="cpu")
    ref = jax_compat.ASMC(root, dq, str(d / "asmc_jax"))
    kw = dict(per_pair_posteriors=True, sum_of_posteriors=True,
              per_pair_posterior_means=True, per_pair_MAPs=True)
    a.decodePairs([0, 3], [7, 40], **kw)
    ref.decodePairs([0, 3], [7, 40], **kw)
    got, want = a.get_copy_of_results(), ref.get_copy_of_results()
    assert got.per_pair_indices == want.per_pair_indices
    times = np.asarray(compat.DecodingQuantities(dq).expectedTimes)
    post = want.per_pair_posteriors / times[None, :, None]
    np.testing.assert_allclose(got.per_pair_posteriors / times[None, :, None],
                               post, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got.sum_of_posteriors / times[:, None],
                               want.sum_of_posteriors / times[:, None],
                               rtol=0, atol=2 * ATOL)
    np.testing.assert_allclose(got.per_pair_posterior_means,
                               want.per_pair_posterior_means,
                               rtol=ATOL, atol=ATOL * times.max())
    assert_maps_equal_but_ties(got.per_pair_MAPs, want.per_pair_MAPs, post)
    ref_view = a.get_ref_of_results()
    np.testing.assert_array_equal(ref_view.min_MAPs, got.min_MAPs)
    np.testing.assert_array_equal(ref_view.argmin_MAPs, got.argmin_MAPs)


@pytest.fixture(scope="module")
def hmms(files):
    """(port HMM on the CPU, JAX HMM) on the whole panel."""
    return (compat.HMM(compat.Data(_params(compat, files)),
                       _params(compat, files), device="cpu"),
            jax_compat.HMM(jax_compat.Data(_params(jax_compat, files)),
                           _params(jax_compat, files)))


@pytest.mark.parametrize("window", [(1000, 1128), (6700, 6759), (0, None)])
def test_hmm_make_pair_obs_and_decode(hmms, window):
    """Haplotypes 0 and 7 over a window inside the panel, one running past
    its end in the 64-site bucket, and the whole chromosome."""
    hmm, ref = hmms
    obs = hmm.makePairObs(1, 0, 2, 3)
    want_obs = ref.makePairObs(1, 0, 2, 3)
    np.testing.assert_array_equal(obs.obsBits, want_obs.obsBits)
    np.testing.assert_array_equal(obs.homMinorBits, want_obs.homMinorBits)
    post = hmm.decode(obs, *window)
    want = ref.decode(want_obs, *window)
    assert post.shape == want.shape == (69, (window[1] or 6759) - window[0])
    np.testing.assert_allclose(post, want, rtol=0, atol=ATOL)


def test_hmm_decode_summarize(hmms):
    hmm, ref = hmms
    pmap, pmean = hmm.decodeSummarize(hmm.makePairObs(2, 5, 1, 9))
    wmap, wmean = ref.decodeSummarize(ref.makePairObs(2, 5, 1, 9))
    assert pmap.shape == pmean.shape == (6759,)
    times = np.asarray(ref._dq.expected_times)
    np.testing.assert_allclose(pmean, wmean, rtol=ATOL,
                               atol=ATOL * times.max())
    post = ref.decode(ref.makePairObs(2, 5, 1, 9))
    states = np.searchsorted(times, pmap), np.searchsorted(times, wmap)
    assert_maps_equal_but_ties(states[0], states[1], post)


@pytest.mark.parametrize("how", ["decodePairs", "decodeHapPairs"])
def test_hmm_buffered_decoding(files, how):
    """decodePairs([0, 2], [1, 2]): 4 hap combos across 0 and 1 and the one
    pair within 2 (HMM.cpp:413-440), then finishDecoding; decodeHapPairs
    with one pair. The sums within 1e-5 per pair of the JAX package's."""
    sides = []
    for mod, kw in ((compat, dict(device="cpu")), (jax_compat, {})):
        hmm = mod.HMM(mod.Data(_params(mod, files)), _params(mod, files),
                      **kw)
        if how == "decodePairs":
            hmm.decodePairs([0, 2], [1, 2])
        else:
            hmm.decodeHapPairs([4], [13])
        n = len(hmm.getBatchBuffer())
        hmm.finishDecoding()
        assert len(hmm.getBatchBuffer()) == 0
        sides.append((hmm.getDecodingReturnValues(), n))
    (got, n), (want, m) = sides
    assert n == m == (5 if how == "decodePairs" else 1)
    sums = np.asarray(got.sumOverPairs)
    assert sums.shape == (6759, 69) and got.sites == 6759
    np.testing.assert_allclose(sums, want.sumOverPairs, rtol=0,
                               atol=ATOL * n)
    np.testing.assert_allclose(sums.sum(axis=1), n, atol=1e-3)


def test_hmm_decode_all_and_state_threshold(files):
    """decodeAll(1000, 7): the 44 pairs of job 7 of the whole panel's
    44,850, through the port's ASMC; and getStateThreshold."""
    sides = []
    for mod, kw in ((compat, dict(device="cpu")), (jax_compat, {})):
        hmm = mod.HMM(mod.Data(_params(mod, files)), _params(mod, files),
                      **kw)
        hmm.decodeAll(1000, 7)
        sides.append(hmm)
    got, want = (h.getDecodingReturnValues().sumOverPairs for h in sides)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL * 44)
    np.testing.assert_allclose(np.asarray(got).sum(axis=1), 44, rtol=1e-3)
    assert sides[0].getStateThreshold() == sides[1].getStateThreshold()
    t = sides[0].getStateThreshold()
    disc = sides[0].getDecodingQuantities().discretization
    assert disc[t] >= 100 and (t == 0 or disc[t - 1] < 100)


def test_default_device_is_cuda_and_raises_without_it(files):
    """HMM, ASMC and FastSMC decode on "cuda" unless told otherwise, and
    without CUDA they raise instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without CUDA")
    root, dq, d = files
    p = _params(compat, files)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        compat.HMM(compat.Data(p), p)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        compat.ASMC(root, dq, str(d / "asmc_cuda"))
    fs = compat.FastSMC(compat.DecodingParams(in_dir=root, decoding_quants=dq,
                                              out_dir=str(d / "fs_cuda")))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fs.run()
