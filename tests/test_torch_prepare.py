"""The port's model builder (``fastsmc_tpu_torch.prepare``,
``preparedecoding``) against the JAX package's, on the CPU.

Both sides are host numpy/scipy and read the same files, so every
comparison is bit for bit (``assert_same``), and the text outputs byte for
byte. The inputs are all in the repository: the CEU demography and the
69-state discretisation are written out of
``artifacts/n300.array.decodingQuantities.npz`` (``io/inputs.py``), the
allele frequencies come from the example panel. The full 69-state model
takes tens of seconds a side (scipy's ``expm`` of one 4x4 generator per
distance, demography epoch and interval), so the transition quantities of
the CEU model are compared on a slice of the distance grid, and the whole
pipeline on an 8-interval grid at n = 8 with a 3-epoch demography;
``tests/test_torch_walkthrough.py`` runs the CEU 69-state pipeline once in
the port.
"""

import dataclasses
import gzip

import numpy as np
import pytest

from fastsmc_tpu import preparedecoding as jax_pdec
from fastsmc_tpu.io.decoding_quantities import \
    DecodingQuantities as JaxQuantities
from fastsmc_tpu.prepare import conditioned_sfs as jax_cs
from fastsmc_tpu.prepare import csfs as jax_csfs
from fastsmc_tpu.prepare import make_dq as jax_make
from fastsmc_tpu.prepare import transition as jax_tr

from fastsmc_tpu_torch import preparedecoding as pdec
from fastsmc_tpu_torch.io.decoding_quantities import DecodingQuantities
from fastsmc_tpu_torch.io.inputs import write_model_files
from fastsmc_tpu_torch.prepare import conditioned_sfs as cs
from fastsmc_tpu_torch.prepare import csfs
from fastsmc_tpu_torch.prepare import make_dq
from fastsmc_tpu_torch.prepare import transition as tr

from test_torch_host import assert_same

# the 4-interval grid of tests/test_conditioned_sfs.py
N_SMALL, NE, MU = 8, 1000.0, 1e-6
DISC4 = np.array([0.0, 500.0, 2000.0, 6000.0])
# an 8-interval grid (generations) and a 3-epoch demography (generation,
# coalescent-scaled size) for the whole pipeline at n = 8
DISC8 = (0, 100, 300, 600, 1000, 2000, 5000, 10000)
DEMO3 = ((0, 10000), (1000, 5000), (5000, 20000))


@pytest.fixture(scope="module", autouse=True)
def one_blas_thread():
    """BLAS held to one thread in this module: scipy's ``expm``
    runs one 4x4 product after another, and the idle threads of a pool
    per test worker spin on the cores the other workers need (also
    imported by the other surface test files). Without ``threadpoolctl``,
    which the project does not require, the pools keep their sizes and the
    tests only take longer."""
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:
        yield
        return
    with threadpool_limits(limits=1, user_api="blas"):
        yield


def write_small_model(d):
    """(3-epoch demography, 8-interval discretisation) files in ``d``."""
    demo, disc = str(d / "three.demo"), str(d / "eight.disc")
    with open(demo, "w") as fh:
        fh.write("".join(f"{t}\t{n}\n" for t, n in DEMO3))
    with open(disc, "w") as fh:
        fh.write("".join(f"{b}\n" for b in DISC8))
    return demo, disc


@pytest.fixture(scope="module")
def model(repo_root, tmp_path_factory):
    """(CEU demography, its 69-state discretisation, example panel root,
    artifact, 3-epoch demography, 8-interval discretisation)."""
    d = tmp_path_factory.mktemp("model")
    art = str(repo_root / "artifacts" / "n300.array.decodingQuantities.npz")
    demo, disc = write_model_files(DecodingQuantities.load(art),
                                   str(d / "CEU"))
    panel = str(repo_root / "artifacts" / "panels" / "example_array" /
                "example")
    return (demo, disc, panel, art, *write_small_model(d))


def test_model_files_read_back_as_the_artifact(model):
    """The written demography and discretisation read back (through both
    packages' readers, equal bits) as the artifact's time/size vectors and
    boundaries, the appended inf included."""
    demo, disc, _, art, _, _ = model
    want = JaxQuantities.load(art)
    tv, sv = tr.read_demography(demo)
    assert_same((tv, sv), jax_tr.read_demography(demo))
    b = tr.read_discretization(disc)
    assert_same(b, jax_tr.read_discretization(disc))
    assert np.array_equal(tv.astype(np.float32), want.time_vector)
    assert np.array_equal(sv, want.size_vector)
    assert np.array_equal(b.astype(np.float32), want.discretization)
    assert len(b) == 70 and b[-1] == np.inf


def test_transition_quantities_equal(model):
    demo, disc = model[:2]
    args = (*tr.read_demography(demo), tr.read_discretization(disc))
    port, ref = tr.Transition(*args), jax_tr.Transition(*args)
    assert port.states == ref.states == 69
    for name in ("expected_times", "column_ratios", "discretization"):
        assert_same(getattr(port, name), getattr(ref, name), name)
    assert_same(port.initial_state_prob(), ref.initial_state_prob())
    assert_same(port.get_coal_dist(), ref.get_coal_dist())
    grid = make_dq.genetic_distance_grid()
    assert_same(grid, jax_make.genetic_distance_grid())
    assert_same(make_dq.physical_distance_grid(),
                jax_make.physical_distance_grid())
    pick = grid[::400]
    assert_same(port.decoding_quantities_batch(pick),
                ref.decoding_quantities_batch(pick))


def test_conditioned_sfs_equal(tmp_path):
    """ConditionedSFS at n = 8 on the 4-interval grid, and the .csfs file
    written from it, read back by both packages' CSFS."""
    kw = dict(mu=MU, max_efolds=1.0, order=8)
    mats = cs.ConditionedSFS([0.0], [NE], DISC4, N_SMALL, **kw).compute()
    want = jax_cs.ConditionedSFS([0.0], [NE], DISC4, N_SMALL, **kw).compute()
    assert_same([np.asarray(m) for m in mats],
                [np.asarray(m) for m in want])
    paths = []
    for mod, m in ((cs, mats), (jax_cs, want)):
        paths.append(str(tmp_path / f"{mod.__name__}.csfs"))
        mod.write_csfs(paths[-1], [0.0], [NE], MU, N_SMALL, DISC4, m)
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()
    got, ref = csfs.CSFS.load(paths[0]), jax_csfs.CSFS.load(paths[0])
    assert got.keys() == ref.keys()
    for k in got.keys():
        assert_same(got.entries[k].csfs, ref.entries[k].csfs)


def test_allele_frequencies_and_emission_equal(model):
    panel = model[2]
    assert_same(csfs.AlleleFrequencies.from_haps(panel),
                jax_csfs.AlleleFrequencies.from_haps(panel))
    et = np.array([10.0, 100.0, 1000.0, 31337.0])
    assert_same(csfs.compute_classic_emission(et, 1.65e-8),
                jax_csfs.compute_classic_emission(et, 1.65e-8))


@pytest.fixture(scope="module")
def prepared(model):
    """(port, JAX) prepare_decoding on the 8-interval grid at n = 8 and
    the 3-epoch demography, the CSFS computed from the demography."""
    _, _, panel, _, demo3, disc8 = model
    kw = dict(demography_file=demo3, discretization_file=disc8,
              file_root=panel, samples=8, verbose=False)
    return make_dq.prepare_decoding(**kw), jax_make.prepare_decoding(**kw)


def test_prepare_decoding_equal(prepared):
    port, ref = prepared
    assert port.states == 8 and port.csfs_samples == 8
    assert_same(port, ref)


def test_written_outputs_equal(prepared, tmp_path):
    """write_reference_text and write_intervals_info byte for byte;
    save_npz's arrays as load_npz reads them back (an .npz carries zip
    timestamps, so arrays, not file bytes), and the port's load_npz gives
    back exactly what its save_npz wrote."""
    port, ref = prepared
    for mod, dq, tag in ((make_dq, port, "port"), (jax_make, ref, "jax")):
        mod.write_reference_text(dq, str(tmp_path / f"{tag}.dq.gz"))
        mod.write_intervals_info(dq, str(tmp_path / f"{tag}.intervalsInfo"))
        dq.save_npz(str(tmp_path / f"{tag}.npz"))
    for name in ("dq.gz", "intervalsInfo"):
        opener = gzip.open if name.endswith(".gz") else open
        with opener(tmp_path / f"port.{name}", "rb") as a, \
                opener(tmp_path / f"jax.{name}", "rb") as b:
            assert a.read() == b.read(), name
    back = DecodingQuantities.load_npz(str(tmp_path / "port.npz"))
    assert_same(back, port)
    jax_back = JaxQuantities.load_npz(str(tmp_path / "jax.npz"))
    assert_same(back, jax_back)
    assert_same(dataclasses.asdict(DecodingQuantities.load(
        str(tmp_path / "port.npz"))), dataclasses.asdict(back))


def test_save_npz_round_trips_the_artifact(model, tmp_path):
    """The 69-state artifact through the port's save_npz and load_npz
    comes back field for field."""
    dq = DecodingQuantities.load_npz(model[3])
    dq.save_npz(str(tmp_path / "a.npz"))
    assert_same(DecodingQuantities.load_npz(str(tmp_path / "a.npz")), dq)


def test_preparedecoding_adapter_equal(model, tmp_path):
    """The naming adapter: prepare_decoding (computed CSFS) and the
    precomputed-CSFS entry point, and the wrapper's save methods, byte for
    byte against the JAX package's."""
    _, _, panel, _, demo3, disc8 = model
    kw = dict(demography=demo3, discretization=disc8, file_root=panel,
              samples=8)
    port = pdec.prepare_decoding(**kw)
    ref = jax_pdec.prepare_decoding(**kw)
    assert_same(port.native, ref.native)
    for dq, tag in ((port, "port"), (ref, "jax")):
        dq.save_decoding_quantities(str(tmp_path / tag))
        dq.save_intervals(str(tmp_path / tag))
    with gzip.open(tmp_path / "port.decodingQuantities.gz", "rb") as a, \
            gzip.open(tmp_path / "jax.decodingQuantities.gz", "rb") as b:
        assert a.read() == b.read()
    assert (tmp_path / "port.intervalsInfo").read_bytes() == \
        (tmp_path / "jax.intervalsInfo").read_bytes()
    assert port.states == 8          # attribute passthrough
    # the precomputed-CSFS path on a .csfs computed for the same model
    csfs_file = str(tmp_path / "eight.csfs")
    cs.compute_csfs_file(demo3, disc8, 8, csfs_file, mu=pdec.DEFAULT_MU)
    again = pdec.prepare_decoding_precomputed_csfs(csfs_file, **kw)
    assert_same(again.native, port.native)
