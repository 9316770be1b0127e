"""The port's own host modules against the JAX package's, on the CPU.

fastsmc_tpu_torch keeps copies of the JAX package's host layers (config,
panel and decoding-quantities readers, the native library, emissions, dense
operators, the oracle's DecodeContext, the GERMLINE2 scan, writers, the
C++ RNG stack, the synthetic biobank panel and the interval F1). Each side
is built here from the same files and seeds and must give the same bits:
every comparison is exact.

The helpers at the top build the two sides' objects for the other test
files: the JAX package's for the reference, the port's for the port. One
departure is on purpose: the port guards its CSFS emissions, which the
JAX package, like ASMC, uses unguarded (``engine/emissions.py``). Where
the two sides' emissions meet, the JAX side is given the guarded inputs
(``guarded_jax_quantities``, ``guard_jax_sums``).
"""

import dataclasses
import gzip

import numpy as np
import pytest

from fastsmc_tpu import native as jax_native
from fastsmc_tpu.config import DecodingParams as JaxParams
from fastsmc_tpu.engine.oracle import DecodeContext as JaxContext
from fastsmc_tpu.hashing.germline import HashingScan as JaxScan
from fastsmc_tpu.io import writers as jax_writers
from fastsmc_tpu.io.decoding_quantities import \
    DecodingQuantities as JaxQuantities
from fastsmc_tpu.io.haps import load_data as jax_load_data
from fastsmc_tpu.utils import cxx_rng as jax_rng
from scripts.biobank_probe import make_panel as jax_make_panel
from scripts.f1_vs_reference import f1_scores as jax_f1_scores

from fastsmc_tpu_torch import native
from fastsmc_tpu_torch.config import DecodingParams
from fastsmc_tpu_torch.engine.oracle import DecodeContext
from fastsmc_tpu_torch.hashing.germline import HashingScan
from fastsmc_tpu_torch.io import writers
from fastsmc_tpu_torch.io.decoding_quantities import DecodingQuantities
from fastsmc_tpu_torch.io.haps import load_data
from fastsmc_tpu_torch.probes.biobank import make_panel
from fastsmc_tpu_torch.probes.f1 import f1_scores
from fastsmc_tpu_torch.utils import cxx_rng

from test_torch_pipeline import tiny_panel  # noqa: F401


# ---------------------------------------------------------------------------
# helpers for the port's tests: one configuration, two packages
# ---------------------------------------------------------------------------

def port_params(p: JaxParams) -> DecodingParams:
    """The port's ``DecodingParams`` with every field of ``p``."""
    return DecodingParams(**dataclasses.asdict(p))


def jax_params(p: DecodingParams) -> JaxParams:
    """The JAX package's ``DecodingParams`` with every field of ``p``."""
    return JaxParams(**dataclasses.asdict(p))


CSFS_TABLES = ("csfs", "folded_csfs", "ascertained_csfs",
               "folded_ascertained_csfs")


def guarded_jax_quantities(dq: JaxQuantities) -> JaxQuantities:
    """The JAX package's quantities with the port's first guard step:
    every negative entry of the four CSFS tables set to +0.0."""
    return dataclasses.replace(dq, **{
        k: np.where(getattr(dq, k) < 0, np.float32(0.0), getattr(dq, k))
        for k in CSFS_TABLES})


def guard_jax_sums(e):
    """The port's second guard step on the JAX package's emission tables
    ``e``, in place, and ``e``: at the CSFS sites, where both major
    ``em1 + em0minus1`` and then both minor ``(em1 + em0minus1) +
    em2minus0`` is below 0 in float32, the class's last difference
    becomes minus the rest of the sum."""
    i = e.use_csfs_at
    em1, d0, d2 = e.em1[i], e.em0minus1[i], e.em2minus0[i]
    major = em1 + d0
    d0 = np.where(major < 0, -em1, d0)
    major = em1 + d0
    e.em0minus1[i] = d0
    e.em2minus0[i] = np.where(major + d2 < 0, -major, d2)
    return e


def guarded_jax_emissions(prepare):
    """The JAX package's ``prepare_emissions`` with the port's guard: the
    function to patch over ``fastsmc_tpu.engine.oracle.prepare_emissions``
    where a JAX pipeline builds its own context."""
    def guarded(data, dq, params):
        return guard_jax_sums(prepare(data, guarded_jax_quantities(dq),
                                      params))
    return guarded


def contexts(params: JaxParams, load_params: JaxParams = None):
    """(JAX, port) ``DecodeContext`` of one configuration, each side with
    its own panel and decoding quantities read from ``params``' files (the
    panel as ``load_params`` reads it, where given: e.g. with
    ``fastsmc=True`` for a FastSMC-format map). The JAX side's emissions
    carry the port's guard: its quantities are guarded before the build
    and its class sums after."""
    lp = params if load_params is None else load_params
    jctx = JaxContext.build(params, jax_load_data(lp), guarded_jax_quantities(
        JaxQuantities.load(params.decoding_quant_file)))
    guard_jax_sums(jctx.emissions)
    q = port_params(params)
    ctx = DecodeContext.build(q, load_data(port_params(lp)),
                              DecodingQuantities.load(q.decoding_quant_file))
    return jctx, ctx


# ---------------------------------------------------------------------------
# the comparisons
# ---------------------------------------------------------------------------

def assert_same(a, b, path="") -> None:
    """Equal bit for bit, field by field, through dataclasses, dicts,
    lists and arrays; dtypes must match too."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            assert_same(getattr(a, f.name), getattr(b, f.name),
                        f"{path}.{f.name}")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), path
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    else:
        assert a == b, path


def _example(repo_root, **kw):
    root = str(repo_root / "artifacts" / "panels" / "example_array" /
               "example")
    dq = str(repo_root / "artifacts" / "n300.array.decodingQuantities.npz")
    return JaxParams.asmc(root, dq, fastsmc=True, use_known_seed=True, **kw)


def _panel_params(root, dq, **kw):
    return JaxParams.fastsmc_defaults(root, dq, root + ".out",
                                      use_known_seed=True, **kw)


def test_params_equal(repo_root):
    for p in (_example(repo_root),
              _example(repo_root, decoding_mode="sequence", jobs=9,
                       job_ind=4),
              JaxParams.fastsmc_defaults("x", "y.npz", "z",
                                         hashing=False, jobs=16)):
        assert dataclasses.asdict(port_params(p)) == dataclasses.asdict(p)
    with pytest.raises(ValueError, match="jobs value is incorrect"):
        DecodingParams.fastsmc_defaults("x", jobs=20)


@pytest.mark.parametrize("which", ["example", "example job 3 of 4",
                                   "example unfolded", "tiny", "synthetic"])
def test_load_data_equal(which, repo_root, tiny_panel,  # noqa: F811
                         synthetic_panel_root):
    if which.startswith("example"):
        kw = {"example job 3 of 4": dict(jobs=4, job_ind=3),
              "example unfolded": dict(use_ancestral=True)}.get(which, {})
        p = _example(repo_root, **kw)
    else:
        root, dq, _ = synthetic_panel_root
        p = _panel_params(tiny_panel if which == "tiny" else root, dq)
    want = jax_load_data(p)
    got = load_data(port_params(p))
    assert got.n_haps == want.n_haps > 0
    assert_same(got, want)
    # the undistinguished counts (native sampler, glibc/mt19937 streams)
    assert_same(got.calculate_undistinguished_counts(50),
                want.calculate_undistinguished_counts(50))


@pytest.mark.parametrize("name", ["n300.array.decodingQuantities.npz",
                                  "example.decodingQuantities.npz",
                                  "panels/example_array/"
                                  "example.decodingQuantities.gz"])
def test_decoding_quantities_equal(name, repo_root):
    path = str(repo_root / "artifacts" / name)
    assert_same(DecodingQuantities.load(path), JaxQuantities.load(path))


@pytest.mark.parametrize("mode", ["array", "sequence"])
def test_decode_context_tables_equal(mode, repo_root):
    """The tables the decoders are built from, bit for bit: the dense
    operators, the emissions, the operator indices, the expected times and
    the initial state probabilities. The JAX side's emissions carry the
    port's guard (``contexts``): built from quantities whose CSFS tables
    are zeroed where negative, then their negative class sums raised."""
    from fastsmc_tpu.engine.dense import build_dense_operators as jax_dense

    from fastsmc_tpu_torch.engine.dense import build_dense_operators
    jctx, ctx = contexts(_example(repo_root, decoding_mode=mode))
    assert ctx.params.decoding_sequence == (mode == "sequence")
    assert_same(ctx.emissions, jctx.emissions)
    for f in ("gap_idx", "rate_idx", "homoz_idx", "seq_gap_idx",
              "seq_gap_idx_bwd", "scaling_skip"):
        assert_same(getattr(ctx, f), getattr(jctx, f), f)
    for f in ("expected_times", "initial_state_prob", "column_ratios",
              "discretization", "homozygous_emissions"):
        assert_same(getattr(ctx.dq, f), getattr(jctx.dq, f), f)
    used = np.unique(np.concatenate(
        [jctx.gap_idx] + ([jctx.seq_gap_idx, jctx.seq_gap_idx_bwd,
                           jctx.rate_idx] if mode == "sequence" else [])))
    dq, jdq = ctx.dq, jctx.dq
    got = build_dense_operators(dq.D[used], dq.B[used], dq.U[used],
                                dq.RR[used], dq.column_ratios)
    want = jax_dense(jdq.D[used], jdq.B[used], jdq.U[used], jdq.RR[used],
                     jdq.column_ratios)
    assert_same(list(got), list(want))


def _scan(cls, params, data, native_scan: bool):
    calls = []
    scan = cls(params, data, lambda *a: calls.append(tuple(map(int, a))))
    scan.run(use_native=native_scan, overlap=False)
    return calls


@pytest.mark.parametrize("native_scan", [True, False],
                         ids=["native", "python"])
@pytest.mark.parametrize("which", ["example", "synthetic"])
def test_hashing_scan_candidates_equal(which, native_scan, repo_root,
                                       synthetic_panel_root):
    if which == "example":
        p = _panel_params(*(str(repo_root / "artifacts" / "panels" /
                                "example_array" / "example"),
                            str(repo_root / "artifacts" /
                                "n300.array.decodingQuantities.npz")))
    else:
        root, dq, _ = synthetic_panel_root
        p = _panel_params(root, dq, min_m=0.5)
    q = port_params(p)
    want = _scan(JaxScan, p, jax_load_data(p), native_scan)
    got = _scan(HashingScan, q, load_data(q), native_scan)
    assert len(got) > 0
    assert got == want


def test_native_library_builds_outside_the_jax_package():
    lib = native.get_lib()
    assert lib is not None
    path = native.library_path()
    assert path.exists() and "fastsmc_tpu_torch" in path.parts
    assert path.parent == native.BUILD_DIR


def test_native_library_key_names_the_cpu(monkeypatch):
    """A build/ carried to another CPU is not reused: the library is
    compiled with -march=native."""
    here = native.library_path()
    assert native._cpu_identity() == native._cpu_identity()
    monkeypatch.setattr(native, "_cpu_identity", lambda: "another CPU")
    assert native.library_path() != here
    assert native.library_path().parent == here.parent


def test_cxx_rng_streams_equal():
    for seed in (0, 1, 1234, 2**31 + 5):
        a, b = cxx_rng.GlibcRand(seed), jax_rng.GlibcRand(seed)
        assert [a.rand() for _ in range(1000)] == \
            [b.rand() for _ in range(1000)]
        a, b = cxx_rng.MT19937(seed), jax_rng.MT19937(seed)
        assert [a() for _ in range(1500)] == [b() for _ in range(1500)]
        a, b = cxx_rng.MT19937(seed), jax_rng.MT19937(seed)
        assert [cxx_rng.uniform_int(a, 0, n) for n in range(1, 300)] == \
            [jax_rng.uniform_int(b, 0, n) for n in range(1, 300)]
        x, y = np.arange(101), np.arange(101)
        cxx_rng.cxx_shuffle(x, cxx_rng.MT19937(seed))
        jax_rng.cxx_shuffle(y, jax_rng.MT19937(seed))
        assert_same(x, y)
        a, b = cxx_rng.GlibcRand(seed), jax_rng.GlibcRand(seed)
        assert [cxx_rng.sample_hypergeometric(a, 200, k, 48)
                for k in range(-1, 202, 7)] == \
            [jax_rng.sample_hypergeometric(b, 200, k, 48)
             for k in range(-1, 202, 7)]


def _block(n, seed):
    rng = np.random.default_rng(seed)
    ind = rng.integers(0, 4, (2, n)).astype(np.int32)
    return (ind[0], 1 + rng.integers(0, 2, n), ind[1],
            1 + rng.integers(0, 2, n), rng.integers(1, 10**6, n),
            rng.integers(10**6, 10**7, n),
            rng.random(n).astype(np.float32), rng.random(n),
            rng.random(n).astype(np.float32), rng.random(n).astype(np.float32))


def _gunzip(path):
    with gzip.open(path, "rb") as fh:
        return fh.read()


@pytest.mark.parametrize("kind", ["text threaded", "text", "text python",
                                  "binary", "sums", "per-pair"])
def test_writer_bytes_equal(kind, tmp_path, monkeypatch):
    ids = ([f"f{i}" for i in range(4)], [f"i{i}" for i in range(4)])
    if kind == "text python":
        monkeypatch.setattr(native, "get_lib", lambda: None)
        monkeypatch.setattr(jax_native, "get_lib", lambda: None)
    if kind == "text":                  # the port's pool at W = 1
        monkeypatch.setattr(writers, "_usable_cores", lambda: 2)
    out = {}
    for tag, mod in (("port", writers), ("jax", jax_writers)):
        path = str(tmp_path / f"{tag}.gz")
        if kind.startswith("text"):
            kw = {} if mod is writers else \
                {"threaded": kind == "text threaded"}
            w = mod.IbdTextWriter(path, *ids, 7, **kw)
            for seed in range(3):
                w.write_block(*_block(40, seed))
            w.write_block(*_block(5, 9)[:6], None, _block(5, 9)[7])
            w.close()
        elif kind == "binary":
            w = mod.IbdBinaryWriter(path, *ids, 7, True, True, False)
            for seed in range(3):
                b = _block(40, seed)
                w.write_block(*b[:8], b[8], None)
            w.close()
        elif kind == "sums":
            rng = np.random.default_rng(3)
            mats = rng.random((3, 50, 6)).astype(np.float32)
            mod.write_sum_over_pairs(path, mats[0])
            mod.write_major_minor_sums(path, *mats, rng.random(50) < 0.5)
        else:
            rng = np.random.default_rng(4)
            w = mod.PerPairStreamWriter(path)
            w.write_rows(rng.random((5, 30)).astype(np.float32))
            w.close()
            w = mod.PerPairStreamWriter(path + ".map.gz", integers=True)
            w.write_rows(rng.integers(0, 69, (5, 30)))
            w.close()
        out[tag] = [_gunzip(path)]
        if kind == "sums":
            out[tag] += [_gunzip(f"{path}.{c}.sumOverPairs.gz")
                         for c in ("00", "01", "11")]
        if kind == "per-pair":
            out[tag].append(_gunzip(path + ".map.gz"))
    assert out["port"] == out["jax"] and len(out["port"][0]) > 100


def test_make_panel_equal():
    assert_same(make_panel(256, seed=0), jax_make_panel(256, seed=0))


def test_f1_scores_equal(repo_root):
    fx = repo_root / "tests" / "fixtures"
    a = str(fx / "example_array.golden.FastSMC.ibd.gz")
    b = str(fx / "example_array.seq.FastSMC.ibd.gz")
    for x, y in ((a, b), (b, a), (a, a)):
        got = f1_scores(x, y)
        assert got == jax_f1_scores(x, y)
    assert f1_scores(a, a)["bp_f1"] == 1.0 and f1_scores(a, b)["bp_f1"] < 1
