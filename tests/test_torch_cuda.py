"""The CUDA kernels against their plain PyTorch versions on the card, at
small shapes. They need an NVIDIA GPU and skip without one. They use no
JAX and no conftest fixture, so on a machine with a card and no JAX run
them from the repository root with

    python -m pytest --noconftest -m cuda -q tests/test_torch_cuda.py

Tolerance: atol 1e-5 (f32 sums in another order in the K=69 product,
renormalised at every site)."""

import numpy as np
import pytest
import torch

from fastsmc_tpu_torch.engine import kernels

from fastsmc_tpu.engine.oracle import DecodeContext
from fastsmc_tpu.io.decoding_quantities import DecodingQuantities

pytestmark = pytest.mark.cuda

ATOL = 1e-5


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")


@pytest.fixture(scope="module")
def ctx(cuda):
    """1,024 founder-mosaic haplotypes x 6,400 sites, folded."""
    from scripts.biobank_probe import REPO, make_panel, params_for
    dq = DecodingQuantities.load_npz(
        f"{REPO}/artifacts/n300.array.decodingQuantities.npz")
    return DecodeContext.build(params_for(1024), make_panel(1024, seed=3), dq)


@pytest.fixture(scope="module")
def gpu(cuda, ctx):
    return kernels.GpuDecoder(ctx, "cuda")


def _inputs(dec, t0, T, P, seed=0):
    rng = np.random.default_rng(seed)
    ha = rng.integers(0, 1024, P)
    hb = (ha + 1 + rng.integers(0, 1023, P)) % 1024
    return dec.prologue(ha, hb, t0, T)


# (t0, T, P): ragged pair tile, a window past the panel end (L=6400),
# several tiles
SHAPES = [(100, 64, 40), (6370, 64, 32), (0, 256, 96)]


@pytest.mark.parametrize("t0,T,P", SHAPES)
def test_forward_kernel_matches_plain(gpu, t0, T, P):
    t = gpu.tables
    obs, em, ops_f, _, mask = _inputs(gpu, t0, T, P)
    n = kernels.LAUNCHES["hmm_forward"]
    got = kernels.forward(t.Mf, em, obs, t.isp, ops_f, mask)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["hmm_forward"] == n + 1
    want = kernels.forward_reference(t.Mf, em, obs, t.isp, ops_f, mask)
    torch.testing.assert_close(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("t0,T,P", SHAPES)
def test_backward_kernel_matches_plain(gpu, t0, T, P):
    t = gpu.tables
    obs, em, ops_f, ops_b, mask = _inputs(gpu, t0, T, P, seed=1)
    alpha = kernels.forward_reference(t.Mf, em, obs, t.isp, ops_f, mask)
    outs = kernels.BwdOutputs(posterior=True, threshold_sums=True)
    args = (t.Mb, em, obs, alpha, ops_b, mask, gpu.K, 11, outs)
    n = kernels.LAUNCHES["hmm_backward"]
    got = kernels.backward_combine(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["hmm_backward"] == n + 1
    want = kernels.backward_combine_reference(*args)
    for name in ("posterior", "threshold_sums"):
        torch.testing.assert_close(got[name], want[name], rtol=0, atol=ATOL)
    only_th = kernels.backward_combine(
        *args[:-1], kernels.BwdOutputs(posterior=False, threshold_sums=True))
    assert set(only_th) == {"threshold_sums"}
    torch.testing.assert_close(only_th["threshold_sums"],
                               got["threshold_sums"], rtol=0, atol=0)


def test_cuda_tensors_never_take_the_plain_path(gpu, ctx, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("plain version called on CUDA tensors")

    cpu = kernels.GpuDecoder(ctx, "cpu")
    rng = np.random.default_rng(3)
    ha, hb = rng.integers(0, 1024, 16), rng.integers(0, 1024, 16)
    outs = kernels.BwdOutputs(posterior=True, threshold_sums=True)
    want = cpu.decode_pairs(ha, hb, 64, 128, outs, 11)
    monkeypatch.setattr(kernels, "forward_reference", refuse)
    monkeypatch.setattr(kernels, "backward_combine_reference", refuse)
    before = dict(kernels.LAUNCHES)
    got = gpu.decode_pairs(ha, hb, 64, 128, outs, 11)
    assert kernels.LAUNCHES["hmm_forward"] == before.get("hmm_forward", 0) + 1
    assert kernels.LAUNCHES["hmm_backward"] == \
        before.get("hmm_backward", 0) + 1
    for name in want:
        torch.testing.assert_close(got[name].cpu(), want[name], rtol=0,
                                   atol=ATOL)


def test_outputs_without_kernel_raise_on_cuda(gpu):
    t = gpu.tables
    obs, em, ops_f, ops_b, mask = _inputs(gpu, 0, 64, 32)
    alpha = kernels.forward(t.Mf, em, obs, t.isp, ops_f, mask)
    with pytest.raises(NotImplementedError):
        kernels.backward_combine(t.Mb, em, obs, alpha, ops_b, mask, gpu.K,
                                 11, kernels.BwdOutputs(per_pair_map=True))
