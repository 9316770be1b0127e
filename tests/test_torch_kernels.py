"""The port's decoders on the CPU (the kernels' plain versions) against the
JAX package: PallasDecoder in interpret mode and the lax.scan
BatchedDecoder, on the same panel, windows and hap pairs.

Tolerance: atol 1e-5 on posteriors and sums (rtol 1e-5 on the posterior
mean, whose values are in generations) -- f32 sums taken in another order
in a K=69 product that is renormalised at every site. MAP states must be
equal."""

import numpy as np
import pytest
import torch

from fastsmc_tpu.config import DecodingParams
from fastsmc_tpu.engine import segments as jseg
from fastsmc_tpu.engine.hmm import BatchedDecoder as JaxBatchedDecoder
from fastsmc_tpu.engine.kernels import BwdOutputs as JaxBwdOutputs
from fastsmc_tpu.engine.kernels import PallasDecoder
from fastsmc_tpu.engine.oracle import DecodeContext
from fastsmc_tpu.io.haps import load_data

from fastsmc_tpu_torch.engine import kernels
from fastsmc_tpu_torch.engine.hmm import BatchedDecoder, bucket_len
from fastsmc_tpu_torch.engine.tables import DecodeTables, padded_states

P = 8
# (t0, T): two windows inside the 640-site panel, one running past its end
WINDOWS = [(0, 64), (200, 128), (600, 64)]
ALL = dict(posterior=True, posterior_sums=True, per_pair_mean=True,
           per_pair_map=True, threshold_sums=True, major_minor_sums=True)


@pytest.fixture(scope="module")
def ctx(synthetic_panel_root, n300_dq):
    root, dq_path, d = synthetic_panel_root
    params = DecodingParams.fastsmc_defaults(root, dq_path, str(d / "tk"),
                                             use_known_seed=True)
    return DecodeContext.build(params, load_data(params), n300_dq)


@pytest.fixture(scope="module")
def pallas(ctx):
    return PallasDecoder(ctx, interpret=True)


@pytest.fixture(scope="module")
def gpu(ctx):
    return kernels.GpuDecoder(ctx, "cpu")


def _pairs(seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 300, P).astype(np.int32)
    b = ((a + 1 + rng.integers(0, 299, P)) % 300).astype(np.int32)
    return a, b


def _st(ctx):
    return jseg.state_threshold(ctx.dq.discretization, 50, ctx.dq.states)


@pytest.mark.parametrize("t0,T", WINDOWS)
def test_decode_pairs_matches_pallas_interpret(ctx, pallas, gpu, t0, T):
    ha, hb = _pairs(t0 + T)
    st = _st(ctx)
    before = dict(kernels.LAUNCHES)
    got = gpu.decode_pairs(ha, hb, t0, T, kernels.BwdOutputs(**ALL), st)
    want = pallas.decode_pairs(ha, hb, t0, T, JaxBwdOutputs(**ALL), st)
    assert dict(kernels.LAUNCHES) == before   # CPU tensors: plain versions
    assert set(got) == set(ALL)
    for name in ALL:
        g = got[name].numpy()
        w = np.asarray(want[name])
        assert g.shape == w.shape, name
        if name == "per_pair_map":
            np.testing.assert_array_equal(g, w)
        elif name == "per_pair_mean":
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("t0,T", WINDOWS)
def test_batched_decoder_matches_jax(ctx, gpu, t0, T):
    ha, hb = _pairs(7 * t0 + T)
    want = np.asarray(JaxBatchedDecoder(ctx).decode_pairs(ha, hb, t0, T))
    spec = BatchedDecoder(ctx, "cpu").decode_pairs(ha, hb, t0, T)
    np.testing.assert_allclose(spec.numpy(), want, rtol=0, atol=1e-5)
    post = gpu.decode_pairs(ha, hb, t0, T)["posterior"]
    np.testing.assert_allclose(post.numpy(), spec.numpy(), rtol=0,
                               atol=1e-5)


def test_tables_from_numpy_equal_from_context(ctx, pallas):
    d = {k: np.asarray(v) for k, v in pallas._tables().items()}
    d.update(gap_op=pallas.gap_op, identity_op=pallas._identity_op,
             hap_bits=np.asarray(pallas.hap_bits),
             scaling_skip=pallas._scaling_skip)
    a = DecodeTables.from_numpy(d, ctx.dq.states, "cpu")
    b = DecodeTables.from_context(ctx, "cpu")
    assert a.KP == b.KP == padded_states(ctx.dq.states) == 72
    for f in ("K", "identity_op", "scaling_skip"):
        assert getattr(a, f) == getattr(b, f), f
    for f in ("Mf", "Mb", "gap_op", "em", "isp", "exp_times", "hap_bits"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and torch.equal(x, y), f


def test_prologue_pads_past_panel_end(gpu):
    t = gpu.tables
    L = gpu.L
    ha, hb = _pairs(1)
    obs, em, ops_f, ops_b, mask = gpu.prologue(ha, hb, L - 10, 64)
    assert obs.shape == (64, 2, P) and em.shape == (64, 3, t.KP)
    assert torch.all(obs[10:, 0] == 1) and torch.all(obs[10:, 1] == 0)
    assert torch.all(em[10:, 0] == 1) and torch.all(em[10:, 1:] == 0)
    assert torch.all(ops_f[10:] == t.identity_op)
    assert torch.all(ops_b[9:] == t.identity_op)
    assert ops_f[0] == t.identity_op
    assert torch.equal(ops_f[1:10], t.gap_op[L - 10:L - 1].to(torch.int32))
    assert ops_f.dtype == ops_b.dtype == mask.dtype == torch.int32


def test_wrappers_take_plain_versions_on_cpu(gpu):
    t = gpu.tables
    ha, hb = _pairs(2)
    obs, em, ops_f, ops_b, mask = gpu.prologue(ha, hb, 100, 64)
    before = dict(kernels.LAUNCHES)
    alpha = kernels.forward(t.Mf, em, obs, t.isp, ops_f, mask)
    assert torch.equal(alpha, kernels.forward_reference(
        t.Mf, em, obs, t.isp, ops_f, mask))
    outs = kernels.BwdOutputs(posterior=True, threshold_sums=True)
    got = kernels.backward_combine(t.Mb, em, obs, alpha, ops_b, mask,
                                   gpu.K, 11, outs)
    want = kernels.backward_combine_reference(t.Mb, em, obs, alpha, ops_b,
                                              mask, gpu.K, 11, outs)
    assert set(got) == {"posterior", "threshold_sums"}
    for k in got:
        assert torch.equal(got[k], want[k])
    assert dict(kernels.LAUNCHES) == before
    # rows past K stay exactly zero; every column is a distribution
    assert torch.all(alpha[:, gpu.K:] == 0)
    np.testing.assert_allclose(got["posterior"].sum(1).numpy(), 1.0,
                               atol=1e-5)


def test_block_reduce_takes_plain_version_on_cpu():
    rng = np.random.default_rng(5)
    part = torch.tensor(rng.random((9, 4, 3, 8), np.float32))
    before = dict(kernels.LAUNCHES)
    got = kernels.block_reduce(part)
    assert dict(kernels.LAUNCHES) == before
    assert got.dtype == torch.float32 and got.shape == (4, 3, 8)
    np.testing.assert_allclose(got.numpy(),
                               part.numpy().astype(np.float64).sum(0),
                               rtol=1e-7)


def test_bucket_len_matches_jax():
    from fastsmc_tpu.engine.hmm import bucket_len as jax_bucket_len
    for n in (1, 63, 64, 65, 200, 1000, 4097):
        for m in (64, 256):
            assert bucket_len(n, m) == jax_bucket_len(n, m)


def test_cuda_device_without_cuda_raises(ctx):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        kernels.GpuDecoder(ctx, "cuda")
