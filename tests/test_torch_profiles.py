"""The fast and turbo decode profiles in the port on the CPU (the kernels'
plain versions): their arithmetic against the JAX package's, and their
accuracy against the exact profile.

The approximate profiles round both operands of every product to bf16 and
store alpha as bf16; in array mode they normalise the carry once per
8-site block. What is checked, and how tightly:

  * fast and turbo give the same bits (turbo's operators are stored
    rounded, fast's are rounded as they are read);
  * turbo against the JAX PallasDecoder's turbo profile in interpret mode,
    whose CPU products of bf16 operands are the same exact products: atol
    1e-5 except where one bf16 rounding went the other way between the two
    f32 summation orders, after which the pass drifts at bf16 level: at
    most 2 % of the entries beyond 1e-5, none beyond 5e-2;
  * the fast profile against the exact one: posterior within 1.5e-2 on a
    2,048-site window of 8 pairs (the JAX package recorded 9.1e-3,
    PROFILE_ACCURACY.json), and bp-F1 >= 0.99 against the exact golden of
    the example panel (0.9976 there); ASMC's per-pair streams: means
    within relative 5e-2, MAP states equal at >= 80 % of the pair-sites;
  * FastSMC on the fast profile against the JAX package in interpret mode:
    its turbo profile's records exactly (floats rtol 1e-4); its fast
    profile's CPU products are a full f32 product, not the TPU's bf16
    pass, so against it a contract check, not a bit check (every segment
    matched, bp-F1 >= 0.98);
  * block normalisation (array mode), on the plain versions in f32: the
    posterior equals per-site normalisation's to f32 rounding (atol
    1e-6).

Each side reads the panel with its own loader and decodes from its own
DecodeContext (test_torch_host.contexts).
"""

import numpy as np
import pytest
import torch

from fastsmc_tpu.config import DecodingParams as JaxParams
from fastsmc_tpu.engine import segments as jseg
from fastsmc_tpu.engine.kernels import BwdOutputs as JaxBwdOutputs
from fastsmc_tpu.engine.kernels import PallasDecoder
from fastsmc_tpu.pipelines.fastsmc import FastSMC as JaxFastSMC

import fastsmc_tpu_torch
from fastsmc_tpu_torch.config import DecodingParams
from fastsmc_tpu_torch.engine import kernels
from fastsmc_tpu_torch.engine.oracle import DecodeContext
from fastsmc_tpu_torch.engine.tables import DecodeTables
from fastsmc_tpu_torch.io.decoding_quantities import DecodingQuantities
from fastsmc_tpu_torch.io.haps import load_data
from fastsmc_tpu_torch.pipelines import asmc
from fastsmc_tpu_torch.probes.f1 import f1_scores
from test_torch_host import contexts
from test_torch_pipeline import (_assert_same_records, _records,  # noqa: F401
                                 _tiny_params, tiny_panel)

ALL = dict(posterior=True, posterior_sums=True, per_pair_mean=True,
           per_pair_map=True, threshold_sums=True, major_minor_sums=True)
SUMS = ("sum_over_pairs", "sum_over_pairs00", "sum_over_pairs01",
        "sum_over_pairs11")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def example(repo_root):
    root = str(repo_root / "artifacts" / "panels" / "example_array"
               / "example")
    dq = str(repo_root / "artifacts" / "n300.array.decodingQuantities.npz")
    return root, dq, load_data(DecodingParams.asmc(
        root, dq, "unused", fastsmc=True, use_known_seed=True))


def _ctx(example, mode):
    root, dq, data = example
    params = DecodingParams.asmc(root, dq, "unused", decoding_mode=mode,
                                 use_known_seed=True)
    return DecodeContext.build(params, data, DecodingQuantities.load(dq))


@pytest.fixture(scope="module", params=["array", "sequence"])
def both(request, example):
    """(JAX, port) DecodeContext of the example panel in one mode."""
    root, dq, _ = example
    return contexts(
        JaxParams.asmc(root, dq, "unused", decoding_mode=request.param,
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


def test_fast_equals_turbo(ctx):
    """All six outputs, and alpha, bit for bit."""
    ha, hb = _pairs(0, 8)
    fast = kernels.GpuDecoder(ctx, "cpu", "fast")
    turbo = kernels.GpuDecoder(ctx, "cpu", "turbo")
    assert fast.tables.Mf.dtype == torch.float32
    assert turbo.tables.Mf.dtype == turbo.tables.Mb.dtype == torch.bfloat16
    assert fast.alpha_dtype == turbo.alpha_dtype == torch.bfloat16
    outs = kernels.BwdOutputs(**ALL)
    a = fast.decode_pairs(ha, hb, 1000, 128, outs, 11)
    b = turbo.decode_pairs(ha, hb, 1000, 128, outs, 11)
    for name in ALL:
        assert torch.equal(a[name], b[name]), name
    obs, em, ops_f, _, mask = fast.prologue(ha, hb, 1000, 128)
    seq_f = fast.seq_prologue(1000, 128)[0] if fast.sequence else None
    alpha = [kernels.forward(d.tables.Mf, em, obs, d.tables.isp, ops_f, mask,
                             seq_f, d.profile) for d in (fast, turbo)]
    assert alpha[0].dtype == torch.bfloat16
    assert torch.equal(*alpha)


def test_turbo_matches_jax_turbo_interpret(jctx, ctx):
    """All six outputs against PallasDecoder(precision="turbo") in
    interpret mode (the tolerance is in the module docstring)."""
    ha, hb = _pairs(1, 8)
    st = jseg.state_threshold(ctx.dq.discretization, 50, ctx.dq.states)
    T = 256 if not ctx.params.decoding_sequence else 64
    got = kernels.GpuDecoder(ctx, "cpu", "turbo").decode_pairs(
        ha, hb, 2000, T, kernels.BwdOutputs(**ALL), st)
    want = PallasDecoder(jctx, interpret=True,
                         precision="turbo").decode_pairs(
        ha, hb, 2000, T, JaxBwdOutputs(**ALL), st)
    for name in ("posterior", "threshold_sums"):
        d = np.abs(got[name].numpy() - np.asarray(want[name]))
        assert d.max() <= 5e-2, name
        assert (d > 1e-5).mean() <= 0.02, name
    for name in ("posterior_sums", "major_minor_sums"):
        d = np.abs(got[name].numpy() - np.asarray(want[name]))
        assert d.max() <= 5e-2 * 8, name
    expt = float(ctx.dq.expected_times.max())
    d = np.abs(got["per_pair_mean"].numpy() - np.asarray(want["per_pair_mean"]))
    assert d.max() <= 5e-2 * expt
    # MAP: differs only where the pass drifted
    post = got["posterior"].numpy()
    g, w = got["per_pair_map"].numpy(), np.asarray(want["per_pair_map"])
    t, p = np.nonzero(g != w)
    gap = post[t, g[t, p].astype(int), p] - post[t, w[t, p].astype(int), p]
    assert len(gap) <= 0.02 * g.size and (len(gap) == 0 or gap.max() <= 5e-2)


def test_fast_within_bound_of_exact(ctx):
    """A 2,048-site window of 8 pairs: posterior within 1.5e-2."""
    ha, hb = _pairs(2, 8)
    exact = kernels.GpuDecoder(ctx, "cpu").decode_pairs(ha, hb, 2000, 2048)
    fast = kernels.GpuDecoder(ctx, "cpu", "fast").decode_pairs(
        ha, hb, 2000, 2048)
    d = (exact["posterior"] - fast["posterior"]).abs().max().item()
    assert 0 < d <= 1.5e-2


def test_block_norm_matches_site_norm(example):
    """Array mode, exact arithmetic (f32 operands and alpha) with the carry
    normalised once per 8-site block against every site: the same
    posterior to f32 rounding; the unnormalised alpha is what differs. In
    sequence mode the plain versions refuse block normalisation: the
    homozygous half-steps underflow an unnormalised f32 carry."""
    ctx = _ctx(example, "array")
    dec = kernels.GpuDecoder(ctx, "cpu")
    t = dec.tables
    ha, hb = _pairs(3, 8)
    obs, em, ops_f, ops_b, mask = dec.prologue(ha, hb, 3000, 512)
    outs = kernels.BwdOutputs(posterior=True)
    post, alphas = [], []
    for nb in (False, True):
        alpha = kernels.forward_reference(t.Mf, em, obs, t.isp, ops_f, mask,
                                          norm_block=nb)
        alphas.append(alpha)
        post.append(kernels.backward_combine_reference(
            t.Mb, em, obs, alpha, ops_b, mask, dec.K, 0, outs,
            norm_block=nb)["posterior"])
    np.testing.assert_allclose(post[1].numpy(), post[0].numpy(), rtol=0,
                               atol=1e-6)
    # blocks end at sites 7, 15, ...: normalised there, not in between
    col = alphas[1].sum(dim=1)
    torch.testing.assert_close(col[7::8], torch.ones_like(col[7::8]))
    assert (col[1:7] - 1).abs().max() > 1e-3
    seq = kernels.GpuDecoder(_ctx(example, "sequence"), "cpu")
    seq_f, _ = seq.seq_prologue(3000, 64)
    obs, em, ops_f, _, mask = seq.prologue(ha, hb, 3000, 64)
    with pytest.raises(ValueError, match="array mode"):
        kernels.forward_reference(seq.tables.Mf, em, obs, seq.tables.isp,
                                  ops_f, mask, seq_f, norm_block=True)


def test_tables_from_numpy_turbo(jctx, ctx):
    """The JAX PallasDecoder's turbo tables (bf16 operators) through
    from_numpy: bf16 operators equal to from_context's, the same decode."""
    pallas = PallasDecoder(jctx, interpret=True, precision="turbo")
    d = {k: np.asarray(v) for k, v in pallas._tables().items()}
    d.update(gap_op=pallas.gap_op, identity_op=pallas._identity_op,
             hap_bits=np.asarray(pallas.hap_bits),
             scaling_skip=pallas._scaling_skip)
    if pallas.sequence:
        d.update(seq_op=pallas.seq_op, seq_op_bwd=pallas.seq_op_bwd,
                 rate_op=pallas.rate_op)
    a = DecodeTables.from_numpy(d, ctx.dq.states, "cpu")
    b = DecodeTables.from_context(ctx, "cpu", torch.bfloat16)
    for f in ("Mf", "Mb"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype == torch.bfloat16 and torch.equal(x, y), f
    dec = kernels.GpuDecoder(ctx, "cpu", "turbo")
    ha, hb = _pairs(4, 4)
    want = dec.decode_pairs(ha, hb, 100, 64)["posterior"]
    dec.tables = a
    assert torch.equal(dec.decode_pairs(ha, hb, 100, 64)["posterior"], want)


def test_unknown_profile_raises(example):
    root, dq, data = example
    p = DecodingParams.asmc(root, dq, "unused", use_known_seed=True)
    with pytest.raises(ValueError, match="profile"):
        asmc.ASMC(p, data=data, device="cpu", decode_profile="bf16")
    ctx = DecodeContext.build(p, data, DecodingQuantities.load(dq))
    with pytest.raises(ValueError, match="profile"):
        kernels.GpuDecoder(ctx, "cpu", "highest")


def test_fastsmc_tiny_panel_matches_jax_profiles(tiny_panel, repo_root,
                                                 tmp_path):
    """Port fast (and turbo, the same bytes) against the JAX package in
    interpret mode: its turbo profile rounds the operands to bf16 on the
    CPU too, so the same records, floats rtol 1e-4; its fast profile's CPU
    products are f32, so a contract check: every segment matched (seg-F1
    1.0), bp-F1 >= 0.98."""
    want = {}
    for profile in ("fast", "turbo"):
        want[profile] = JaxFastSMC(
            _tiny_params(tiny_panel, repo_root, str(tmp_path / f"j{profile}"),
                         JaxParams),
            use_pallas="interpret", flush_group=2,
            decode_profile=profile).run(verbose=False)
    got = {}
    for profile in ("fast", "turbo"):
        port = fastsmc_tpu_torch.FastSMC(
            _tiny_params(tiny_panel, repo_root, str(tmp_path / profile)),
            device="cpu", decode_profile=profile)
        assert port._alpha_budget == 32 << 20
        got[profile] = port.run(verbose=False)
    fast = _records(got["fast"])
    assert fast and fast == _records(got["turbo"])
    _assert_same_records(fast, _records(want["turbo"]))
    f1 = f1_scores(want["fast"], got["fast"])
    assert f1["seg_f1"] == 1.0 and f1["bp_f1"] >= 0.98, f1


def test_fastsmc_example_fast_f1_against_exact_golden(example, repo_root,
                                                      tmp_path):
    root, dq, data = example
    p = DecodingParams.fastsmc_defaults(root, dq, str(tmp_path / "ex"),
                                        use_known_seed=True)
    port = fastsmc_tpu_torch.FastSMC(p, data=data, device="cpu",
                                     decode_profile="fast")
    path = port.run(verbose=False)
    f1 = f1_scores(str(repo_root / "tests" / "fixtures"
                       / "example_array.golden.FastSMC.ibd.gz"), path)
    assert f1["bp_f1"] >= 0.99, f1


@pytest.fixture(scope="module")
def synthetic(synthetic_panel_root):
    root, dq, d = synthetic_panel_root
    return root, dq, load_data(DecodingParams.asmc(
        root, dq, str(d / "load"), fastsmc=True, use_known_seed=True))


def test_asmc_fast_sums(synthetic, tmp_path):
    """jobs=200, job 3 (224 pairs): turbo's sums equal fast's bit for bit,
    and fast's are within 5e-3 per pair of the exact profile's."""
    root, dq, data = synthetic
    res = {}
    for profile in ("exact", "fast", "turbo"):
        p = DecodingParams.asmc(root, dq, str(tmp_path / profile),
                                do_posterior_sums=True,
                                do_major_minor_posterior_sums=True,
                                use_known_seed=True, jobs=200, job_ind=3)
        res[profile] = asmc.ASMC(p, data=data, device="cpu", batch_size=64,
                                 decode_profile=profile).decode_all_in_job(
                                     verbose=False)
    for f in SUMS:
        assert np.array_equal(getattr(res["fast"], f),
                              getattr(res["turbo"], f)), f
        d = np.abs(getattr(res["fast"], f) - getattr(res["exact"], f))
        assert d.max() <= 5e-3 * 224, f


def test_bf16_alpha_widens_the_batch_cap():
    """A 2-byte alpha: an 8,192-site window at K=69 takes 188 bytes a pair
    and site instead of 332 -- with 79 GiB free, 27,520 pairs a batch
    instead of 15,584 (1.77x: the block partials keep their width)."""
    assert asmc.max_batch(79 << 30, 6400, 69) == 15584
    assert asmc.max_batch(79 << 30, 6400, 69, alpha_bytes=2) == 27520
    assert asmc.max_batch(200 << 20, 640, 69, 2) == 544


def test_asmc_fast_per_pair_streams_near_exact(example, tmp_path):
    """The per-pair streams (array mode) of the example panel's first 50
    within-sample pairs over the whole chromosome: on the fast profile the
    posterior means within relative 5e-2 of the exact profile's and the MAP
    states equal at >= 80 % of the pair-sites (chip_smoke.py's
    PROFILE_MEAN_RTOL and PROFILE_MAP_AGREE; the others are states of
    flat, near-tied posteriors), and turbo's streams equal fast's."""
    root, dq, data = example
    got = {}
    for profile in ("exact", "fast", "turbo"):
        out = str(tmp_path / profile)
        p = DecodingParams.asmc(root, dq, out, use_known_seed=True,
                                within_only=True, jobs=3, job_ind=1,
                                do_per_pair_posterior_mean=True,
                                do_per_pair_map=True)
        asmc.ASMC(p, data=data, device="cpu", batch_size=64,
                  decode_profile=profile).decode_all_in_job(verbose=False)
        got[profile] = (
            np.loadtxt(out + ".perPairPosteriorMeans.gz", dtype=np.float32),
            np.loadtxt(out + ".perPairMAP.gz", dtype=np.int64))
    (me, ae), (mf, af), (mt, at) = got.values()
    assert me.shape == mf.shape == (50, data.sites)
    assert np.array_equal(mf, mt) and np.array_equal(af, at)
    rel = np.abs(mf - me) / np.abs(me)
    assert 0 < rel.max() <= 5e-2
    assert 0.8 <= (af == ae).mean() < 1
