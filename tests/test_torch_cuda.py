"""The CUDA kernels against their plain PyTorch versions on the card, at
small shapes. They need an NVIDIA GPU and skip without one. They use no
JAX and no conftest fixture, so on a machine with a card and no JAX run
them from the repository root with

    python -m pytest --noconftest -m cuda -q tests/test_torch_cuda.py

Tolerance: atol 1e-5 (f32 sums in another order in the K=69 product,
renormalised at every site); sums over P pairs atol 1e-5 * P; per-pair
means, and they only, also rtol 1e-5 (they are in generations); MAP
states equal but for ties within 1e-5."""

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
    """All six outputs on CUDA tensors: one forward, one backward and two
    block-reduction launches, no plain version, the CPU decoder's
    values."""
    def refuse(*a, **k):
        raise AssertionError("plain version called on CUDA tensors")

    cpu = kernels.GpuDecoder(ctx, "cpu")
    rng = np.random.default_rng(3)
    ha, hb = rng.integers(0, 1024, 40), rng.integers(0, 1024, 40)
    outs = kernels.BwdOutputs(**{n: True for n in kernels.KERNEL_OUTPUTS})
    want = cpu.decode_pairs(ha, hb, 64, 128, outs, 11)
    for name in ("forward_reference", "backward_combine_reference",
                 "block_reduce_reference"):
        monkeypatch.setattr(kernels, name, refuse)
    before = dict(kernels.LAUNCHES)
    got = gpu.decode_pairs(ha, hb, 64, 128, outs, 11)
    torch.cuda.synchronize()
    launched = {k: kernels.LAUNCHES[k] - before.get(k, 0)
                for k in ("hmm_forward", "hmm_backward", "hmm_block_reduce")}
    assert launched == {"hmm_forward": 1, "hmm_backward": 1,
                        "hmm_block_reduce": 2}
    assert set(got) == set(kernels.KERNEL_OUTPUTS)
    for name in want:
        g, w = got[name].cpu(), want[name]
        if name == "per_pair_map":
            assert_map_matches(g, w, want["posterior"])
        elif name == "per_pair_mean":
            torch.testing.assert_close(g, w, rtol=1e-5, atol=ATOL)
        elif name in ("posterior_sums", "major_minor_sums"):
            torch.testing.assert_close(g, w, rtol=0, atol=ATOL * 40)
        else:
            torch.testing.assert_close(g, w, rtol=0, atol=ATOL)


def assert_map_matches(got_map, want_map, post_want):
    """MAP states equal, except where the plain version's posterior has
    the two states within ATOL of each other (a tie that an f32 sum taken
    in another order may break the other way)."""
    flip = (got_map != want_map).nonzero()
    t, p = flip[:, 0], flip[:, 1]
    gap = (post_want[t, want_map[t, p].long(), p]
           - post_want[t, got_map[t, p].long(), p])
    assert gap.numel() == 0 or float(gap.abs().max()) <= ATOL, gap
    assert gap.numel() <= 1e-4 * got_map.numel(), gap.numel()


# pairs: a whole number of 32-pair blocks, and 5 dead lanes in the last
@pytest.mark.parametrize("P", [8192, 8187])
def test_four_outputs_match_plain(gpu, P):
    """posterior_sums, per_pair_mean, per_pair_map and major_minor_sums of
    the kernels against the plain version, with 32-pair blocks summed by
    the reduction kernel; a second launch gives the same bits, and the MAP
    state is the first maximum of the kernel's own posterior."""
    t = gpu.tables
    obs, em, ops_f, ops_b, mask = _inputs(gpu, 1000, 64, P, seed=2)
    alpha = kernels.forward(t.Mf, em, obs, t.isp, ops_f, mask)
    outs = kernels.BwdOutputs(posterior=True, posterior_sums=True,
                              per_pair_mean=True, per_pair_map=True,
                              major_minor_sums=True)
    args = (t.Mb, em, obs, alpha, ops_b, mask, gpu.K, 11, outs, t.exp_times)
    before = dict(kernels.LAUNCHES)
    got = kernels.backward_combine(*args)
    again = kernels.backward_combine(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["hmm_backward"] == \
        before.get("hmm_backward", 0) + 2
    assert kernels.LAUNCHES["hmm_block_reduce"] == \
        before.get("hmm_block_reduce", 0) + 4
    want = kernels.backward_combine_reference(*args)
    assert set(got) == set(want) == {"posterior", "posterior_sums",
                                     "per_pair_mean", "per_pair_map",
                                     "major_minor_sums"}
    for name in got:
        assert torch.equal(got[name], again[name]), name
        assert bool(torch.isfinite(got[name]).all()), name
    assert torch.equal(got["per_pair_map"],
                       got["posterior"].argmax(dim=1).float())
    # the FastSMC outputs alone run the other instantiation: same posterior
    fastsmc = kernels.backward_combine(
        *args[:8], kernels.BwdOutputs(posterior=True, threshold_sums=True))
    assert torch.equal(fastsmc["posterior"], got["posterior"])
    assert_map_matches(got["per_pair_map"], want["per_pair_map"],
                       want["posterior"])
    torch.testing.assert_close(got["posterior"], want["posterior"],
                               rtol=0, atol=ATOL)
    torch.testing.assert_close(got["per_pair_mean"], want["per_pair_mean"],
                               rtol=1e-5, atol=ATOL)
    for name in ("posterior_sums", "major_minor_sums"):
        torch.testing.assert_close(got[name], want[name], rtol=0,
                                   atol=ATOL * P)
    # each site's sums over the real pairs: the pairs' posteriors sum to 1
    torch.testing.assert_close(got["posterior_sums"].sum(1),
                               torch.full((64,), float(P), device="cuda"),
                               rtol=1e-4, atol=0)
    torch.testing.assert_close(got["major_minor_sums"].sum(1),
                               got["posterior_sums"], rtol=0,
                               atol=ATOL * P)


def test_block_reduce_matches_plain(cuda):
    rng = np.random.default_rng(4)
    part = torch.tensor(rng.random((256, 64, 3, 72), np.float32),
                        device="cuda")
    n = kernels.LAUNCHES["hmm_block_reduce"]
    got = kernels.block_reduce(part)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["hmm_block_reduce"] == n + 1
    assert got.shape == (64, 3, 72)
    # both add in f64; the rounding to f32 may differ by one ulp
    torch.testing.assert_close(got, kernels.block_reduce_reference(part),
                               rtol=2e-7, atol=0)
