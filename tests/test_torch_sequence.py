"""Sequence mode in the port on the CPU (the kernels' plain versions)
against the JAX package: the lax.scan BatchedDecoder, PallasDecoder in
interpret mode, the scalar oracle, and the FastSMC and ASMC pipelines, on
the same panels, windows and pairs.

Tolerances: posteriors and sums over n pairs atol 1e-5 (times n) -- f32
sums taken in another order in a K=69 product renormalised at every
site; against the scalar oracle atol 2e-4 (the bound of
tests/test_regression.py:119); per-pair means rtol 1e-5 (they are in
generations); MAP states equal except at ties within 1e-5; FastSMC records
equal in their first 9 columns, floats rtol 1e-4. Each side reads the
panel with its own loader and decodes from its own DecodeContext
(test_torch_host.contexts).

The two goldens were made by the JAX package on the CPU, from the
repository root, with::

    import shutil
    import numpy as np
    from fastsmc_tpu.config import DecodingParams
    from fastsmc_tpu.io.haps import load_data
    from fastsmc_tpu.pipelines.asmc import ASMC
    from fastsmc_tpu.pipelines.fastsmc import FastSMC
    root = "artifacts/panels/example_array/example"
    dq = "artifacts/n300.array.decodingQuantities.npz"
    data = load_data(DecodingParams.asmc(root, dq, "x", fastsmc=True,
                                         use_known_seed=True))
    p = DecodingParams.asmc(root, dq, "x", decoding_mode="sequence",
                            do_posterior_sums=True,
                            do_major_minor_posterior_sums=True,
                            use_known_seed=True, jobs=100, job_ind=7)
    r = ASMC(p, data=data, use_pallas=False,
             batch_size=64).decode_all_in_job(verbose=False)
    np.savez_compressed(
        "tests/fixtures/example_array.seq_asmc_job7of100.npz",
        **{f: getattr(r, f) for f in ("sum_over_pairs", "sum_over_pairs00",
                                      "sum_over_pairs01", "sum_over_pairs11")})
    # the FastSMC golden: the JAX side given the port's emission guard,
    # which moves its scores by up to 1 % where they are small (the sums
    # golden, made before the guard, lies within its tolerance of it)
    import sys
    sys.path.insert(0, "tests")
    from fastsmc_tpu.engine import oracle
    from test_torch_host import guarded_jax_emissions
    oracle.prepare_emissions = guarded_jax_emissions(
        oracle.prepare_emissions)
    p = DecodingParams.fastsmc_defaults(root, dq, "/tmp/seq/ex",
                                        use_known_seed=True,
                                        decoding_mode="sequence")
    shutil.copy(FastSMC(p, use_pallas=False).run(verbose=False),
                "tests/fixtures/example_array.seq.FastSMC.ibd.gz")
"""

import numpy as np
import pytest
import torch

from fastsmc_tpu.config import DecodingParams as JaxParams
from fastsmc_tpu.engine import segments as jseg
from fastsmc_tpu.engine.hmm import BatchedDecoder as JaxBatchedDecoder
from fastsmc_tpu.engine.kernels import BwdOutputs as JaxBwdOutputs
from fastsmc_tpu.engine.kernels import PallasDecoder
from fastsmc_tpu.engine.oracle import decode_pair
from fastsmc_tpu.io.haps import load_data as jax_load_data
from fastsmc_tpu.pipelines.asmc import ASMC as JaxASMC
from fastsmc_tpu.pipelines.fastsmc import FastSMC as JaxFastSMC

import fastsmc_tpu_torch
from fastsmc_tpu_torch.config import DecodingParams
from fastsmc_tpu_torch.engine import kernels
from fastsmc_tpu_torch.engine.hmm import BatchedDecoder
from fastsmc_tpu_torch.engine.tables import DecodeTables
from fastsmc_tpu_torch.io.haps import load_data
from test_torch_host import contexts
from test_torch_pipeline import (_assert_same_records, _records,  # noqa: F401
                                 _tiny_params, tiny_panel)

SUMS = ("sum_over_pairs", "sum_over_pairs00", "sum_over_pairs01",
        "sum_over_pairs11")
ALL = dict(posterior=True, posterior_sums=True, per_pair_mean=True,
           per_pair_map=True, threshold_sums=True, major_minor_sums=True)


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
def example(repo_root):
    """The example panel (300 haplotypes x 6,759 sites, its map in FastSMC
    format), loaded whole by the port."""
    root = str(repo_root / "artifacts" / "panels" / "example_array"
               / "example")
    dq = str(repo_root / "artifacts" / "n300.array.decodingQuantities.npz")
    return root, dq, load_data(DecodingParams.asmc(
        root, dq, "unused", fastsmc=True, use_known_seed=True))


@pytest.fixture(scope="module")
def both(example):
    """(JAX, port) sequence-mode DecodeContext of the example panel."""
    root, dq, _ = example
    return contexts(
        JaxParams.asmc(root, dq, "unused", decoding_mode="sequence",
                       use_known_seed=True),
        JaxParams.asmc(root, dq, "unused", fastsmc=True,
                       use_known_seed=True))


@pytest.fixture(scope="module")
def jctx(both):
    return both[0]


@pytest.fixture(scope="module")
def ctx(both):
    return both[1]


def _pairs(seed, P, H=300):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, H, P).astype(np.int32)
    b = ((a + 1 + rng.integers(0, H - 1, P)) % H).astype(np.int32)
    return a, b


# (t0, T): a 1,024-site window inside the 6,759-site panel, and one
# running past its end
@pytest.mark.parametrize("t0,T", [(2000, 1024), (6700, 128)])
def test_plain_versions_match_jax_and_oracle(jctx, ctx, t0, T):
    """The plain BatchedDecoder and the kernels' plain versions against JAX
    BatchedDecoder (1e-5) and the JAX package's scalar oracle (2e-4)."""
    ha, hb = _pairs(t0, 4)
    want = np.asarray(JaxBatchedDecoder(jctx).decode_pairs(ha, hb, t0, T))
    spec = BatchedDecoder(ctx, "cpu").decode_pairs(ha, hb, t0, T).numpy()
    np.testing.assert_allclose(spec, want, rtol=0, atol=1e-5)
    post = kernels.GpuDecoder(ctx, "cpu").decode_pairs(
        ha, hb, t0, T)["posterior"].numpy()
    np.testing.assert_allclose(post, want, rtol=0, atol=1e-5)
    real = min(T, ctx.data.sites - t0)
    for i in range(2):
        ref = decode_pair(jctx, int(ha[i]), int(hb[i]), t0, t0 + real)
        np.testing.assert_allclose(post[:real, :, i].T, ref, rtol=0,
                                   atol=2e-4)


def test_decode_pairs_matches_pallas_interpret(jctx, ctx):
    """All six outputs of the plain versions against the Pallas kernels'
    sequence branch in interpret mode."""
    ha, hb = _pairs(1, 8)
    st = jseg.state_threshold(ctx.dq.discretization, 50, ctx.dq.states)
    got = kernels.GpuDecoder(ctx, "cpu").decode_pairs(
        ha, hb, 3000, 64, kernels.BwdOutputs(**ALL), st)
    want = PallasDecoder(jctx, interpret=True).decode_pairs(
        ha, hb, 3000, 64, JaxBwdOutputs(**ALL), st)
    for name in ALL:
        g, w = got[name].numpy(), np.asarray(want[name])
        assert g.shape == w.shape, name
        if name == "per_pair_map":
            np.testing.assert_array_equal(g, w)
        elif name == "per_pair_mean":
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5, err_msg=name)


def test_tables_from_numpy_equal_from_context(jctx, ctx):
    """The JAX PallasDecoder's sequence-mode tables through from_numpy give
    from_context's tables, and the same decode."""
    pallas = PallasDecoder(jctx, interpret=True)
    d = {k: np.asarray(v) for k, v in pallas._tables().items()}
    d.update(gap_op=pallas.gap_op, identity_op=pallas._identity_op,
             hap_bits=np.asarray(pallas.hap_bits),
             scaling_skip=pallas._scaling_skip, seq_op=pallas.seq_op,
             seq_op_bwd=pallas.seq_op_bwd, rate_op=pallas.rate_op)
    a = DecodeTables.from_numpy(d, ctx.dq.states, "cpu")
    b = DecodeTables.from_context(ctx, "cpu")
    assert a.sequence and b.sequence
    for f in ("K", "identity_op", "scaling_skip"):
        assert getattr(a, f) == getattr(b, f), f
    for f in ("Mf", "Mb", "gap_op", "em", "isp", "exp_times", "hap_bits",
              "seq_op", "seq_op_bwd", "rate_op", "homoz"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and torch.equal(x, y), f
    dec = kernels.GpuDecoder(ctx, "cpu")
    ha, hb = _pairs(2, 4)
    want = dec.decode_pairs(ha, hb, 500, 64)["posterior"]
    dec.tables = a
    assert torch.equal(dec.decode_pairs(ha, hb, 500, 64)["posterior"], want)


def test_seq_prologue_pads_past_panel_end(ctx):
    dec = kernels.GpuDecoder(ctx, "cpu")
    t, L = dec.tables, dec.L
    ha, hb = _pairs(3, 4)
    _, _, ops_f, ops_b, _ = dec.prologue(ha, hb, L - 10, 64)
    seq_f, seq_b = dec.seq_prologue(L - 10, 64)
    ident = t.identity_op
    # forward step t: seq-gap op and homozygous emissions of gap t0+t-1,
    # rate op of site t0+t; identity at step 0 and past the panel
    assert torch.equal(ops_f[1:10], t.seq_op[L - 10:L - 1].to(torch.int32))
    assert torch.equal(seq_f.rops[1:10], t.rate_op[L - 9:L].to(torch.int32))
    assert torch.equal(seq_f.hem[1:10], t.homoz[L - 10:L - 1])
    for x in (ops_f, seq_f.rops):
        assert x[0] == ident and torch.all(x[10:] == ident)
    assert torch.all(seq_f.hem[0] == 1) and torch.all(seq_f.hem[10:] == 1)
    # backward step pos: seq-gap bwd op, rate op and emissions of t0+pos
    assert torch.equal(ops_b[:9], t.seq_op_bwd[L - 10:L - 1].to(torch.int32))
    assert torch.equal(seq_b.rops[:9], t.rate_op[L - 10:L - 1].to(torch.int32))
    assert torch.equal(seq_b.hem[:9], t.homoz[L - 10:L - 1])
    assert torch.all(ops_b[9:] == ident) and torch.all(seq_b.rops[9:] == ident)
    assert torch.all(seq_b.hem[9:] == 1)
    for x in (seq_f.rops, seq_b.rops):
        assert x.dtype == torch.int32
    assert seq_f.hem.shape == seq_b.hem.shape == (64, t.KP)
    # padded states carry 1.0, as the TPU's 128 lanes do
    assert torch.all(t.homoz[:, dec.K:] == 1)


def test_fastsmc_tiny_panel_matches_jax_fused(tiny_panel, repo_root,
                                              tmp_path):
    """FastSMC in sequence mode against the JAX package's fused decode +
    extract path with the Pallas kernels' sequence branch (interpret)."""
    def params(tag, cls=DecodingParams):
        p = _tiny_params(tiny_panel, repo_root, str(tmp_path / tag), cls)
        p.decoding_mode = "sequence"
        return p.finalize()

    want = _records(JaxFastSMC(params("jax", JaxParams),
                               use_pallas="interpret",
                               flush_group=2).run(verbose=False))
    port = fastsmc_tpu_torch.FastSMC(params("port"), device="cpu")
    assert port.decoder.sequence
    got = _records(port.run(verbose=False))
    assert got and len(got[0]) == 13
    _assert_same_records(got, want)


@pytest.fixture(scope="module")
def synthetic(synthetic_panel_root):
    """The synthetic panel loaded whole by the port and by the JAX
    package."""
    root, dq, d = synthetic_panel_root
    args = (root, dq, str(d / "load"))
    return (root, dq,
            load_data(DecodingParams.asmc(*args, fastsmc=True,
                                          use_known_seed=True)),
            jax_load_data(JaxParams.asmc(*args, fastsmc=True,
                                         use_known_seed=True)))


def _asmc_pair(synthetic, out, **kw):
    root, dq, data, jax_data = synthetic
    kw.update(decoding_mode="sequence", use_known_seed=True)
    port = fastsmc_tpu_torch.ASMC(
        DecodingParams.asmc(root, dq, str(out / "port"), **kw), data=data,
        device="cpu", batch_size=64)
    ref = JaxASMC(JaxParams.asmc(root, dq, str(out / "jax"), **kw),
                  data=jax_data, use_pallas=False, batch_size=64)
    return port, ref


def test_asmc_sums_match_jax(synthetic, tmp_path):
    """jobs=200, job 3 of the synthetic panel (224 pairs in batches of 64,
    the last partial): sums and major/minor sums."""
    port, ref = _asmc_pair(synthetic, tmp_path, do_posterior_sums=True,
                           do_major_minor_posterior_sums=True, jobs=200,
                           job_ind=3)
    before = dict(kernels.LAUNCHES)
    got = port.decode_all_in_job(verbose=False)
    assert dict(kernels.LAUNCHES) == before       # CPU: plain versions
    want = ref.decode_all_in_job(verbose=False)
    for f in SUMS:
        g, w = getattr(got, f), getattr(want, f)
        assert g.shape == w.shape and g.dtype == w.dtype, f
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * 224, err_msg=f)


def test_asmc_per_pair_streams_match_jax(synthetic, tmp_path):
    """within_only: the 150 within-sample pairs' posterior means and MAP
    states."""
    port, ref = _asmc_pair(synthetic, tmp_path, within_only=True,
                           do_per_pair_posterior_mean=True,
                           do_per_pair_map=True)
    port.decode_all_in_job(verbose=False)
    ref.decode_all_in_job(verbose=False)
    L = synthetic[2].sites
    g, w = (np.loadtxt(str(tmp_path / side) + ".perPairPosteriorMeans.gz")
            for side in ("port", "jax"))
    assert g.shape == w.shape == (150, L)
    np.testing.assert_allclose(g, w, rtol=1e-5)
    g, w = (np.loadtxt(str(tmp_path / side) + ".perPairMAP.gz")
            for side in ("port", "jax"))
    h = np.arange(150, dtype=np.int32)
    post = port._full_posterior(2 * h, 2 * h + 1, L)          # [L, K, n]
    i, t = np.nonzero(g != w)
    gap = post[t, w[i, t].astype(int), i] - post[t, g[i, t].astype(int), i]
    assert len(gap) <= 1e-4 * g.size
    assert len(gap) == 0 or np.abs(gap).max() <= 1e-5


def test_example_asmc_reproduces_jax_golden(example, repo_root, tmp_path):
    """The JAX-made sequence-mode sums of pairs 2,691..3,138 (jobs=100,
    job 7) of the example panel, in one batch of 448."""
    root, dq, data = example
    p = DecodingParams.asmc(root, dq, str(tmp_path / "g"),
                            decoding_mode="sequence", do_posterior_sums=True,
                            do_major_minor_posterior_sums=True,
                            use_known_seed=True, jobs=100, job_ind=7)
    a = fastsmc_tpu_torch.ASMC(p, data=data, device="cpu", batch_size=448)
    assert a._job_pair_range() == (2691, 3139)
    got = a.decode_all_in_job(verbose=False)
    want = np.load(repo_root / "tests" / "fixtures"
                   / "example_array.seq_asmc_job7of100.npz")
    for f in SUMS:
        assert getattr(got, f).shape == want[f].shape == (6759, 69)
        np.testing.assert_allclose(getattr(got, f), want[f], rtol=0,
                                   atol=1e-5 * 448, err_msg=f)


def test_example_fastsmc_reproduces_jax_golden(example, repo_root,
                                               tmp_path):
    """The JAX-made sequence-mode records of the example panel: the same
    1,961 record keys in order, floats rtol 1e-4."""
    root, dq, data = example
    p = DecodingParams.fastsmc_defaults(root, dq, str(tmp_path / "ex"),
                                        use_known_seed=True,
                                        decoding_mode="sequence")
    got = _records(fastsmc_tpu_torch.FastSMC(p, data=data, device="cpu")
                   .run(verbose=False))
    want = _records(str(repo_root / "tests" / "fixtures"
                        / "example_array.seq.FastSMC.ibd.gz"))
    assert len(want) == 1961
    _assert_same_records(got, want)
