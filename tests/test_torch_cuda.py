"""The CUDA kernels against their plain PyTorch versions on the card, at
small shapes. They need an NVIDIA GPU and skip without one. They use no
JAX and no conftest fixture, so on a machine with a card and no JAX run
them from the repository root with

    python -m pytest --noconftest -m cuda -q tests/test_torch_cuda.py

Tolerance: atol 1e-5 (f32 sums in another order in the K=69 product,
renormalised at every site; the forward's exact products run as 3xTF32 on
tensor cores, which add with truncation and read 4-6e-6 at T=8192); sums over P pairs atol 1e-5 * P; per-pair
means, and they only, also rtol 1e-5 (they are in generations); MAP
states equal but for ties within 1e-5. On the fast/turbo profiles the
kernel and its plain version are two bf16 trajectories that can part after
one rounding goes the other way: per-pair outputs atol 5e-3 in array mode
and 5e-2 in sequence mode (chip_smoke.py's APPROX_ATOL, with the readings
behind it); a few pairs' drift does not average out over these small pair
counts, so the sums over P pairs are held at that atol * P against the
plain version, and within 1e-5 * P against the kernel's own posterior
output summed over pairs; turbo equals fast bit for bit. The alpha-wall
probe's kernels: raw alpha within ALPHA_WALL_FWD_RTOL of the plain value
at every element, the backward output within ALPHA_WALL_BWD_ATOL and its
raw carry after site 1 within ALPHA_WALL_CARRY_RTOL of the plain value."""

import os

import numpy as np
import pytest
import torch

from fastsmc_tpu_torch.engine import kernels
from fastsmc_tpu_torch.engine.oracle import DecodeContext
from fastsmc_tpu_torch.io.decoding_quantities import DecodingQuantities
from fastsmc_tpu_torch.probes import alpha_wall
from fastsmc_tpu_torch.probes.biobank import make_panel, params_for

DQ = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "artifacts", "n300.array.decodingQuantities.npz")

pytestmark = pytest.mark.cuda

ATOL = 1e-5
APPROX_ATOL = {"array": 5e-3, "sequence": 5e-2}
# the alpha-wall probe's kernels against their plain versions, per pass:
# bf16 operands, f32 sums in another order, the carry rounded to bf16 at
# every site (chip_smoke.py's gates, with the readings behind them)
ALPHA_WALL_FWD_RTOL = 1.6e-2
ALPHA_WALL_BWD_ATOL = 2e-4
ALPHA_WALL_CARRY_RTOL = 1.6e-2


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")


@pytest.fixture(scope="module")
def ctx(cuda):
    """1,024 founder-mosaic haplotypes x 6,400 sites, folded."""
    return DecodeContext.build(params_for(1024), make_panel(1024, seed=3),
                               DecodingQuantities.load_npz(DQ))


@pytest.fixture(scope="module")
def gpu(cuda, ctx):
    return kernels.GpuDecoder(ctx, "cuda")


@pytest.fixture(scope="module")
def seq_ctx(cuda):
    """The same panel in sequence mode."""
    params = params_for(1024)
    params.decoding_mode = "sequence"
    return DecodeContext.build(params.finalize(), make_panel(1024, seed=3),
                               DecodingQuantities.load_npz(DQ))


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
    got = kernels.forward(t.Mf, em, obs, t.isp, ops_f, mask, split=t.split)
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
    alpha = kernels.forward(t.Mf, em, obs, t.isp, ops_f, mask, split=t.split)
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


def _in_order_sum(part):
    """part[0] + part[1] + ... in f64, b ascending, rounded once to f32: the
    reduction kernel's arithmetic, written out."""
    acc = torch.zeros(part.shape[1:], dtype=torch.float64, device=part.device)
    for b in range(part.shape[0]):
        acc += part[b].double()
    return acc.float()


@pytest.mark.parametrize("E", [1, 5, 217, 64 * 3 * 72, 1024 * 3 * 72])
@pytest.mark.parametrize("nblk", [1, 3, 256, 257])
def test_block_reduce_equals_in_order_sum(cuda, nblk, E):
    """The reduction gives the in-order f64 sum's bits, at ragged element
    counts and at the major/minor sums' partials at T=64 and T=1024
    (E = T * 3 * 72), for one block to 257."""
    rng = np.random.default_rng(nblk * 1000 + E)
    part = torch.tensor(rng.standard_normal((nblk, E), np.float32) * 1e3,
                        device="cuda")
    got = kernels.block_reduce(part)
    assert torch.equal(got, _in_order_sum(part))


@pytest.mark.parametrize("E,offset", [(5, 1), (217, 1), (64 * 3 * 72, 1),
                                      (64 * 3 * 72, 2), (1024 * 3 * 72, 1)])
def test_block_reduce_of_a_misaligned_view(cuda, E, offset):
    """Contiguous views of a larger tensor give the in-order f64 sum's
    bits: at a storage offset of 1-2 floats (a base that is not 16-byte
    aligned), and ``part[1:]``."""
    rng = np.random.default_rng(E + offset)
    nblk = 257
    big = torch.tensor(rng.random(nblk * E + offset + E, np.float32),
                       device="cuda")
    for part in (big[offset:offset + nblk * E].view(nblk, E),
                 big[:(nblk + 1) * E].view(nblk + 1, E)[1:]):
        assert part.is_contiguous()
        got = kernels.block_reduce(part)
        assert torch.equal(got, _in_order_sum(part))


VARIANTS = [("sequence", "exact"), ("array", "fast"), ("array", "turbo"),
            ("sequence", "fast"), ("sequence", "turbo")]


def _variant(ctx, seq_ctx, mode, profile):
    return kernels.GpuDecoder(ctx if mode == "array" else seq_ctx, "cuda",
                              profile)


@pytest.mark.parametrize("mode,profile", VARIANTS)
@pytest.mark.parametrize("t0,T,P", SHAPES)
def test_variant_kernels_match_plain(cuda, ctx, seq_ctx, mode, profile, t0,
                                     T, P):
    """Each sequence-mode and fast/turbo instantiation, all six outputs,
    against the plain versions on the kernel's own alpha."""
    dec = _variant(ctx, seq_ctx, mode, profile)
    t = dec.tables
    obs, em, ops_f, ops_b, mask = _inputs(dec, t0, T, P, seed=6)
    seq_f = seq_b = None
    if dec.sequence:
        seq_f, seq_b = dec.seq_prologue(t0, T)
    fwd = kernels.kernel_name("hmm_forward", dec.sequence, profile)
    bwd = kernels.kernel_name("hmm_backward", dec.sequence, profile)
    before = dict(kernels.LAUNCHES)
    alpha = kernels.forward(t.Mf, em, obs, t.isp, ops_f, mask, seq_f,
                            profile, t.split)
    outs = kernels.BwdOutputs(**{n: True for n in kernels.KERNEL_OUTPUTS})
    args = (t.Mb, em, obs, alpha, ops_b, mask, dec.K, 11, outs, t.exp_times,
            seq_b, profile)
    got = kernels.backward_combine(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[fwd] == before.get(fwd, 0) + 1
    assert kernels.LAUNCHES[bwd] == before.get(bwd, 0) + 1
    assert alpha.dtype == kernels.alpha_dtype(profile)
    want_alpha = kernels.forward_reference(t.Mf, em, obs, t.isp, ops_f, mask,
                                           seq_f, profile)
    want = kernels.backward_combine_reference(*args)
    atol = ATOL if profile == "exact" else APPROX_ATOL[mode]
    a, w = alpha.float(), want_alpha.float()
    torch.testing.assert_close(a / a.sum(1, keepdim=True),
                               w / w.sum(1, keepdim=True), rtol=0, atol=atol)
    for name in ("posterior", "threshold_sums"):
        torch.testing.assert_close(got[name], want[name], rtol=0, atol=atol)
    torch.testing.assert_close(got["per_pair_mean"], want["per_pair_mean"],
                               rtol=0, atol=atol * float(t.exp_times.max()))
    for name in ("posterior_sums", "major_minor_sums"):
        torch.testing.assert_close(got[name], want[name], rtol=0,
                                   atol=atol * P)
    # the sums' epilogue against the kernel's own posterior
    post = got["posterior"]
    oz, oh = obs[:, 0], obs[:, 1]
    classes = torch.stack([oz * (1 - oh), 1 - oz, oh], dim=1)   # [T, 3, P]
    torch.testing.assert_close(got["posterior_sums"], post.sum(2), rtol=0,
                               atol=ATOL * P)
    torch.testing.assert_close(got["major_minor_sums"],
                               torch.einsum("tkp,tcp->tck", post, classes),
                               rtol=0, atol=ATOL * P)
    assert torch.equal(got["per_pair_map"], post.argmax(dim=1).float())
    for x in got.values():
        assert bool(torch.isfinite(x).all())


@pytest.mark.parametrize("mode,profile", [
    ("array", "exact"), ("sequence", "exact"), ("array", "fast"),
    ("sequence", "fast")])
def test_backward_batch_invariance(cuda, ctx, seq_ctx, mode, profile):
    """The same 3,137 pairs as the first 3,137 of an 8,192-pair backward
    launch and alone, on one alpha: their posterior, threshold sums, means
    and MAP states are equal bit for bit (a block's pairs depend on no
    other block, and the operators' bulk copies on no grid size)."""
    dec = _variant(ctx, seq_ctx, mode, profile)
    t = dec.tables
    T, P, n = 64, 8192, 3137
    obs, em, ops_f, ops_b, mask = _inputs(dec, 1000, T, P, seed=8)
    seq_f = seq_b = None
    if dec.sequence:
        seq_f, seq_b = dec.seq_prologue(1000, T)
    alpha = kernels.forward(t.Mf, em, obs, t.isp, ops_f, mask, seq_f,
                            profile, t.split)
    outs = kernels.BwdOutputs(posterior=True, threshold_sums=True,
                              per_pair_mean=True, per_pair_map=True)

    def bwd(obs, alpha):
        return kernels.backward_combine(t.Mb, em, obs, alpha, ops_b, mask,
                                        dec.K, 11, outs, t.exp_times, seq_b,
                                        profile)

    full = bwd(obs, alpha)
    alone = bwd(obs[..., :n].contiguous(), alpha[..., :n].contiguous())
    assert set(full) == set(alone) == {"posterior", "threshold_sums",
                                       "per_pair_mean", "per_pair_map"}
    for name in full:
        assert torch.equal(full[name][..., :n], alone[name]), name


# (t0, T, P): dead lanes in the last 16- and 32-pair groups, inside the
# panel and in a window padded past its end (L=6400)
FORWARD_SHAPES = [(2048, 128, 8187), (6370, 64, 8187)]


@pytest.mark.parametrize("mode,profile", [
    ("array", "exact"), ("sequence", "exact"), ("array", "fast"),
    ("array", "turbo"), ("sequence", "fast"), ("sequence", "turbo")])
@pytest.mark.parametrize("t0,T,P", FORWARD_SHAPES)
def test_forward_branches_match_plain(cuda, ctx, seq_ctx, mode, profile, t0,
                                      T, P):
    """Each forward branch against its plain version (exact: raw alpha
    within ATOL; fast/turbo: columns normalised, within APPROX_ATOL[mode]);
    a second launch gives the same bits; each launch counts once."""
    dec = _variant(ctx, seq_ctx, mode, profile)
    t = dec.tables
    obs, em, ops_f, _, mask = _inputs(dec, t0, T, P, seed=10)
    seq_f = dec.seq_prologue(t0, T)[0] if dec.sequence else None
    name = kernels.kernel_name("hmm_forward", dec.sequence, profile)
    n = kernels.LAUNCHES[name]
    got = kernels.forward(t.Mf, em, obs, t.isp, ops_f, mask, seq_f, profile,
                          t.split)
    again = kernels.forward(t.Mf, em, obs, t.isp, ops_f, mask, seq_f,
                            profile, t.split)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] == n + 2
    assert torch.equal(got, again)
    assert got.dtype == kernels.alpha_dtype(profile)
    assert bool(torch.isfinite(got).all())
    want = kernels.forward_reference(t.Mf, em, obs, t.isp, ops_f, mask,
                                     seq_f, profile)
    if profile == "exact":
        torch.testing.assert_close(got, want, rtol=0, atol=ATOL)
    else:
        a, w = got.float(), want.float()
        torch.testing.assert_close(a / a.sum(1, keepdim=True),
                                   w / w.sum(1, keepdim=True), rtol=0,
                                   atol=APPROX_ATOL[mode])


@pytest.mark.parametrize("mode,profile", [
    ("array", "exact"), ("sequence", "exact"), ("array", "fast"),
    ("sequence", "fast")])
def test_forward_batch_invariance(cuda, ctx, seq_ctx, mode, profile):
    """The same 3,137 pairs as the first 3,137 of an 8,192-pair forward
    launch and alone: their alpha is equal bit for bit (no sum crosses a
    pair, and the block shape the launch picks changes no pair's sums)."""
    dec = _variant(ctx, seq_ctx, mode, profile)
    t = dec.tables
    T, P, n = 64, 8192, 3137
    obs, em, ops_f, _, mask = _inputs(dec, 1000, T, P, seed=11)
    seq_f = dec.seq_prologue(1000, T)[0] if dec.sequence else None

    def fwd(obs):
        return kernels.forward(t.Mf, em, obs, t.isp, ops_f, mask, seq_f,
                               profile, t.split)

    assert torch.equal(fwd(obs)[..., :n], fwd(obs[..., :n].contiguous()))


@pytest.mark.parametrize("mode", ["array", "sequence"])
def test_turbo_equals_fast_on_the_card(cuda, ctx, seq_ctx, mode):
    fast = _variant(ctx, seq_ctx, mode, "fast")
    turbo = _variant(ctx, seq_ctx, mode, "turbo")
    rng = np.random.default_rng(7)
    ha, hb = rng.integers(0, 1024, 96), rng.integers(0, 1024, 96)
    outs = kernels.BwdOutputs(**{n: True for n in kernels.KERNEL_OUTPUTS})
    a = fast.decode_pairs(ha, hb, 500, 256, outs, 11)
    b = turbo.decode_pairs(ha, hb, 500, 256, outs, 11)
    for name in a:
        assert torch.equal(a[name], b[name]), name


# the bf16 array forward kernel's edges: P against its pair tiles (a warp
# owns 4 C pairs, C = 1, 2, 4, 8 by the batch; a block W warps), aligned
# and not (a lane stores its C pairs' alpha as one vector only where P is a
# multiple of C), and T against the 8-site normalisation blocks
TILE_P = [1, 3, 5, 31, 33, 65, 2048, 3137, 8187, 8192, 16381, 16384]
TILE_T = [1, 7, 8, 9, 1024]


@pytest.fixture(scope="module")
def tile_decs(cuda, ctx):
    return {p: _variant(ctx, None, "array", p) for p in ("fast", "turbo")}


@pytest.mark.parametrize("profile", ["fast", "turbo"])
@pytest.mark.parametrize("T", TILE_T)
@pytest.mark.parametrize("P", TILE_P)
def test_tile_forward_matches_plain_at_its_edges(tile_decs, profile, T, P):
    """The fast/turbo array forward against its plain version (columns
    normalised, within APPROX_ATOL["array"]); one launch counted."""
    dec = tile_decs[profile]
    t = dec.tables
    obs, em, ops_f, _, mask = _inputs(dec, 2000, T, P, seed=12)
    name = kernels.kernel_name("hmm_forward", False, profile)
    n = kernels.LAUNCHES[name]
    got = kernels.forward(t.Mf, em, obs, t.isp, ops_f, mask, None, profile)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] == n + 1
    assert got.dtype == torch.bfloat16 and got.shape == (T, t.KP, P)
    assert bool(torch.isfinite(got).all())
    want = kernels.forward_reference(t.Mf, em, obs, t.isp, ops_f, mask, None,
                                     profile)
    a, w = got.float(), want.float()
    torch.testing.assert_close(a / a.sum(1, keepdim=True),
                               w / w.sum(1, keepdim=True), rtol=0,
                               atol=APPROX_ATOL["array"])


@pytest.mark.parametrize("P", TILE_P)
def test_tile_forward_turbo_equals_fast(tile_decs, P):
    fast, turbo = tile_decs["fast"], tile_decs["turbo"]
    obs, em, ops_f, _, mask = _inputs(fast, 2000, 64, P, seed=13)
    a = kernels.forward(fast.tables.Mf, em, obs, fast.tables.isp, ops_f,
                        mask, None, "fast")
    b = kernels.forward(turbo.tables.Mf, em, obs, turbo.tables.isp, ops_f,
                        mask, None, "turbo")
    assert torch.equal(a, b)


@pytest.mark.parametrize("P,n", [(65, 1), (3137, 33), (8192, 3137),
                                 (16384, 2048), (27296, 8192)])
def test_tile_forward_batch_invariance(tile_decs, P, n):
    """The first n pairs of a P-pair fast array forward and the same n
    pairs alone, each launch at the pair tile its batch picks: alpha equal
    bit for bit."""
    dec = tile_decs["fast"]
    t = dec.tables
    obs, em, ops_f, _, mask = _inputs(dec, 3000, 64, P, seed=14)

    def fwd(obs):
        return kernels.forward(t.Mf, em, obs, t.isp, ops_f, mask, None,
                               "fast")

    assert torch.equal(fwd(obs)[..., :n], fwd(obs[..., :n].contiguous()))


# the alpha-wall probe's kernels at KC=128 (the only width they take), a
# short window, and P=40 (dead lanes in the second 32-pair block)
ALPHA_WALL_SHAPE = alpha_wall.Shape(KC=128, KA=72, S=8, P=40, T=64, G=5)


@pytest.mark.parametrize("name", list(alpha_wall.VARIANTS))
def test_alpha_wall_kernels_match_plain(cuda, name):
    """Each probe variant's kernel against its plain version on the card:
    alpha raw within ALPHA_WALL_FWD_RTOL of the plain value at every
    element, the backward output within ALPHA_WALL_BWD_ATOL, one launch
    each."""
    shape = ALPHA_WALL_SHAPE
    inp = alpha_wall.make_inputs(shape, "cuda", seed=4)
    key = "alpha_wall_" + ("forward" if name.startswith("fwd")
                           else "backward")
    before = kernels.LAUNCHES[key]
    got = alpha_wall.run_variant(name, inp, shape)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[key] == before + 1
    want = alpha_wall.run_variant(name, inp, shape, plain=True)
    assert got.dtype == want.dtype and got.shape == want.shape
    got, want = got.float(), want.float()
    assert bool(torch.isfinite(got).all())
    if name.startswith("fwd"):
        torch.testing.assert_close(got, want, rtol=ALPHA_WALL_FWD_RTOL,
                                   atol=0)
    else:
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=ALPHA_WALL_BWD_ATOL)
        _, carry = alpha_wall.run_variant(name, inp, shape, carry_site=1)
        _, want_carry = alpha_wall.run_variant(name, inp, shape, plain=True,
                                               carry_site=1)
        assert alpha_wall.max_errors(carry, want_carry)[1] \
            <= ALPHA_WALL_CARRY_RTOL


@pytest.mark.parametrize("S", [1, 8])
@pytest.mark.parametrize("KA", [10, 72, 128])
@pytest.mark.parametrize("P", [5, 37, 40])
@pytest.mark.parametrize("name", [n for n, v in alpha_wall.VARIANTS.items()
                                  if v[0] == "fwd"])
def test_alpha_wall_forward_at_its_edges(cuda, name, P, KA, S):
    """The tensor-core forward against its plain version at the layout's
    edges: a ragged last m-tile (P=5, 37; 40 = 2.5 tiles), odd P (alpha's
    odd rows not 4-byte aligned, so stored element by element), KA below
    16, at its default and at KC, and S=1 (every site normalised under
    block normalisation) and 8: alpha raw within ALPHA_WALL_FWD_RTOL of the
    plain value at every element, finite; two launches give the same
    bytes."""
    shape = alpha_wall.Shape(KC=128, KA=KA, S=S, P=P, T=64, G=5)
    inp = alpha_wall.make_inputs(shape, "cuda", seed=P + KA + S)
    got = alpha_wall.run_variant(name, inp, shape)
    again = alpha_wall.run_variant(name, inp, shape)
    want = alpha_wall.run_variant(name, inp, shape, plain=True)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.equal(got.view(torch.int16), again.view(torch.int16))
    got = got.float()
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want.float(), rtol=ALPHA_WALL_FWD_RTOL,
                               atol=0)


@pytest.mark.parametrize("name", [n for n, v in alpha_wall.VARIANTS.items()
                                  if v[0] == "fwd"])
def test_alpha_wall_forward_into_a_misaligned_view(cuda, name):
    """The forward's stores where TMA cannot store them: alpha 2 bytes past
    a 16-byte boundary, so no row is 4-byte aligned and every element is
    stored alone, at P=64, where the wrapper's own alpha is stored by TMA:
    the same bytes."""
    from fastsmc_tpu_torch.engine._build import load_library
    shape = alpha_wall.Shape(KC=128, KA=72, S=8, P=64, T=64, G=5)
    inp = alpha_wall.make_inputs(shape, "cuda", seed=9)
    _, every, norm_block = alpha_wall.VARIANTS[name]
    want = alpha_wall.run_variant(name, inp, shape)
    buf = torch.zeros(want.numel() + 1, dtype=torch.bfloat16, device="cuda")
    got = buf[1:].view(want.shape)
    rc = load_library(alpha_wall.LIBRARY).fastsmc_alpha_wall_forward(
        inp["M"].data_ptr(), shape.G, inp["em"].data_ptr(),
        inp["obs"].data_ptr(), inp["isp"].data_ptr(), inp["ops"].data_ptr(),
        got.data_ptr(), shape.T, shape.P, shape.KC, shape.KA, shape.S,
        int(every), int(norm_block), 0, torch.cuda.current_stream().cuda_stream)
    assert rc == 0
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.parametrize("KA", [10, 72, 128])
@pytest.mark.parametrize("P", [5, 37, 40])
@pytest.mark.parametrize("name", [n for n, v in alpha_wall.VARIANTS.items()
                                  if v[0] == "bwd"])
def test_alpha_wall_backward_at_its_edges(cuda, name, P, KA):
    """The tensor-core backward against its plain version at the layout's
    edges: a ragged last m-tile (P=5, 37; 40 = 2.5 tiles), KA below 16,
    at its default and at KC, and the raw carry at the pass's first site
    (T-1), inside a block (1), at a block end (S) and at the last site
    (0): output within ALPHA_WALL_BWD_ATOL, carry within
    ALPHA_WALL_CARRY_RTOL (relative); asking for the carry changes no
    output bit."""
    shape = alpha_wall.Shape(KC=128, KA=KA, S=8, P=P, T=64, G=5)
    inp = alpha_wall.make_inputs(shape, "cuda", seed=P + KA)
    out = alpha_wall.run_variant(name, inp, shape)
    want = alpha_wall.run_variant(name, inp, shape, plain=True)
    assert bool(torch.isfinite(out).all())
    torch.testing.assert_close(out, want, rtol=0, atol=ALPHA_WALL_BWD_ATOL)
    for site in (0, 1, shape.S, shape.T - 1):
        got, carry = alpha_wall.run_variant(name, inp, shape,
                                            carry_site=site)
        _, want_carry = alpha_wall.run_variant(name, inp, shape, plain=True,
                                               carry_site=site)
        assert torch.equal(got, out)
        assert carry.shape == (128, P)
        assert alpha_wall.max_errors(carry, want_carry)[1] \
            <= ALPHA_WALL_CARRY_RTOL, site


def _packed_call(dec, inputs):
    """A 512-site window of 128 pairs, each with its own scan window, ages
    on, through the primitives in the order FastSMC's dispatch calls them:
    forward, backward and count, the host's read of the counts, the
    compaction at the caps they size. ``inputs`` are the pair and window
    arrays, as host arrays or staged tensors; returns ``(packed, ages,
    threshold sums)``, the last masked to the windows (on a mesh, the
    shards' side by side on the first device)."""
    from fastsmc_tpu_torch.engine import segments as seg
    ha, hb, w0, w1 = inputs
    dq = DecodingQuantities.load_npz(DQ)
    st = seg.state_threshold(dq.discretization, params_for(1024).time,
                             dq.states)
    prob = seg.probability_threshold(dq.initial_state_prob, st)
    c = dec.count_pass(dec.forward_pass(ha, hb, 1024, 512), st, 0, 512,
                       prob, dq.states, True, w0, w1)
    cap, kcap = seg.sized_caps(dec.read_counts(c))
    packed, ages = dec.extract_counted(c, cap, kcap, dq.states)
    th = c.th if not isinstance(c, list) else torch.cat(
        [x.th.to(packed.device) for x in c], dim=1)
    return packed, ages, th


def _packed_inputs(seed=4, P=128):
    rng = np.random.default_rng(seed)
    ha = rng.integers(0, 1024, P).astype(np.int32)
    hb = ((ha + 1 + rng.integers(0, 8, P)) % 1024).astype(np.int32)
    w0 = rng.integers(0, 128, P).astype(np.int32)
    w1 = (w0 + rng.integers(256, 512, P)).clip(max=512).astype(np.int32)
    return ha, hb, w0, w1


def test_decode_extract_packed_waits_for_nothing(ctx, tmp_path):
    """FastSMC's dispatch as it runs (``FastSMC._queue_group``: staging, the
    forward ahead, each batch's backward and count, the host's read of the
    counts, the sized extraction, the group's rows to pinned memory and
    the previous group's drain) makes no call that waits for the card
    (torch.cuda.set_sync_debug_mode("error") raises on one) but the event
    waits, which the mode lets pass: every flush group after the first of
    a hashing run on ``ctx``'s panel, in groups of 2, ages on."""
    from fastsmc_tpu_torch.pipelines.fastsmc import FastSMC

    params = params_for(1024)
    params.out_file_root = str(tmp_path / "out")
    params.use_known_seed = True
    params.do_per_pair_posterior_mean = params.do_per_pair_map = True
    f = FastSMC(params.finalize(), data=ctx.data,
                dq=DecodingQuantities.load_npz(DQ), device="cuda",
                flush_group=2)
    queue, groups = f._queue_group, []

    def checked(entries):
        if not groups:
            groups.append(0)
            return queue(entries)
        torch.cuda.set_sync_debug_mode("error")
        try:
            res = queue(entries)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        groups.append(len(entries))
        return res

    f._queue_group = checked
    path = f.run(verbose=False)
    assert len(groups) > 2 and sum(groups) > 2
    assert f.stats["overflow_redos"] == 0 and f.n_segments > 0
    assert os.path.getsize(path) > 0


def test_packed_rows_match_the_cpu_plain_path(gpu, ctx):
    """The card's packed row and age rows unpack to the runs of the plain
    versions on the CPU: the same (pair, start, end) in the same order,
    run scores within ATOL per site, posterior-mean ages within relative
    1e-4, MAP ages equal on at least 99 % of the runs."""
    from fastsmc_tpu_torch.engine import segments as seg

    arrays = _packed_inputs()
    got = _packed_call(gpu, arrays)
    want = _packed_call(kernels.GpuDecoder(ctx, "cpu"), arrays)
    runs = []
    for packed, ages, _ in (got, want):
        kcap = (len(packed) - 2) // 3
        start, b, score, nk, nr = seg.unpack_extract_rows(
            packed.cpu().numpy(), kcap)
        assert 0 < nk <= kcap <= nr + 256
        runs.append((start[:nk], b[:nk], score[:nk],
                     ages.cpu().numpy()[:, :nk]))
    (gs, gb, gscore, gages), (ws, wb, wscore, wages) = runs
    assert len(ws) > 0
    np.testing.assert_array_equal(gs, ws)
    np.testing.assert_array_equal(gb, wb)
    length = wb - ws % 512 + 1
    assert (np.abs(gscore - wscore) <= ATOL * length).all()
    np.testing.assert_allclose(gages[0], wages[0], rtol=1e-4)
    assert (gages[1] == wages[1]).mean() >= 0.99


def test_mesh_on_one_card_matches_meshless(gpu, ctx):
    """A mesh of two shards on cuda:0 gives the meshless decoder's per-pair
    outputs and extraction bit for bit, its sums within relative 1e-6,
    and leaves torch's current device where it was."""
    from fastsmc_tpu_torch.engine import segments as seg
    from fastsmc_tpu_torch.parallel import ShardedDecoder, make_mesh

    current = torch.cuda.current_device()
    sd = ShardedDecoder(ctx, make_mesh(devices=["cuda:0"] * 2))
    rng = np.random.default_rng(5)
    ha, hb = rng.integers(0, 1024, 64), rng.integers(0, 1024, 64)
    outs = kernels.BwdOutputs(**{n: True for n in kernels.KERNEL_OUTPUTS})
    before = dict(kernels.LAUNCHES)
    got = sd.decode_pairs(ha, hb, 64, 128, outs, 11)
    want = gpu.decode_pairs(ha, hb, 64, 128, outs, 11)
    torch.cuda.synchronize()
    assert torch.cuda.current_device() == current
    assert kernels.LAUNCHES["hmm_forward"] == before.get("hmm_forward", 0) + 3
    for name in ("posterior", "per_pair_mean", "per_pair_map",
                 "threshold_sums"):
        assert torch.equal(got[name], want[name]), name
    for name in ("posterior_sums", "major_minor_sums"):
        torch.testing.assert_close(got[name], want[name], rtol=1e-6, atol=0)
    arrays = _packed_inputs()
    packed, ages, th = _packed_call(sd, arrays)
    f_packed, f_ages, f_th = _packed_call(gpu, arrays)
    assert torch.cuda.current_device() == current
    assert torch.equal(th, f_th)
    start, b, score, ns_kept, _ = seg.merge_packed_shards(
        packed.cpu().numpy(), 512, len(arrays[0]) // 2)
    f_start, f_b, f_score, nk, _ = seg.unpack_extract_rows(
        f_packed.cpu().numpy(), (len(f_packed) - 2) // 3)
    assert sum(ns_kept) == nk > 0
    np.testing.assert_array_equal(start, f_start[:nk])
    np.testing.assert_array_equal(b, f_b[:nk])
    np.testing.assert_array_equal(score, f_score[:nk])
    np.testing.assert_array_equal(
        np.concatenate([a[:, :n] for a, n in zip(ages.cpu().numpy(),
                                                 ns_kept)], axis=1),
        f_ages.cpu().numpy()[:, :nk])


@pytest.mark.parametrize("P", [1, 5])
def test_compat_hmm_matches_plain_on_a_window(cuda, P, tmp_path):
    """compat.HMM on the ASMC-format copy of the example panel (the inputs
    of chip_smoke.py's phase 19d), the window [1000, 1128) (mid-panel),
    P pairs: the kernels' posterior within ATOL of the plain version's, and
    with P = 5 the buffered batch's sums over the whole chromosome (the
    backward kernel's posterior_sums and the block reduction) within
    ATOL * P."""
    from fastsmc_tpu_torch import compat
    from fastsmc_tpu_torch.io.inputs import write_asmc_panel
    root = write_asmc_panel(
        os.path.join(os.path.dirname(DQ), "panels", "example_array",
                     "example"), str(tmp_path / "asmc" / "example"))
    params = compat.DecodingParams(root, DQ, str(tmp_path / "hmm"),
                                   doPosteriorSums=True)
    data = compat.Data(params)
    sides = []
    for dev in ("cuda", "cpu"):
        hmm = compat.HMM(data, params, device=dev)
        if P == 1:
            hmm.decodeHapPairs([0], [7])
        else:
            hmm.decodePairs([0, 2], [1, 2])
        batch = hmm.getBatchBuffer()
        assert len(batch) == P
        before = dict(kernels.LAUNCHES)
        post = hmm._decode_window(batch, 1000, 1128)["posterior"]
        if dev == "cuda":
            assert kernels.LAUNCHES["hmm_forward"] == \
                before.get("hmm_forward", 0) + 1
        hmm.finishDecoding()
        sides.append((post, hmm.getDecodingReturnValues().sumOverPairs))
    (post, sums), (want_post, want_sums) = sides
    assert post.shape == want_post.shape == (128, 69, P)
    np.testing.assert_allclose(post, want_post, rtol=0, atol=ATOL)
    np.testing.assert_allclose(sums, want_sums, rtol=0, atol=ATOL * P)
