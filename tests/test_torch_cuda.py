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


def _packed_call(dec, inputs):
    """decode_extract_packed on a 512-site window of 128 pairs, each with
    its own scan window, ages on, caps that hold every run; ``inputs`` are
    the pair and window arrays, as host arrays or staged tensors."""
    from fastsmc_tpu_torch.engine import segments as seg
    ha, hb, w0, w1 = inputs
    dq = DecodingQuantities.load_npz(DQ)
    st = seg.state_threshold(dq.discretization, params_for(1024).time,
                             dq.states)
    prob = seg.probability_threshold(dq.initial_state_prob, st)
    return dec.decode_extract_packed(ha, hb, 1024, 512, st, 0, 512, prob,
                                     4096, 4096, dq.states, need_ages=True,
                                     w0=w0, w1=w1)


def _packed_inputs(seed=4, P=128):
    rng = np.random.default_rng(seed)
    ha = rng.integers(0, 1024, P).astype(np.int32)
    hb = ((ha + 1 + rng.integers(0, 8, P)) % 1024).astype(np.int32)
    w0 = rng.integers(0, 128, P).astype(np.int32)
    w1 = (w0 + rng.integers(256, 512, P)).clip(max=512).astype(np.int32)
    return ha, hb, w0, w1


def test_decode_extract_packed_waits_for_nothing(gpu):
    """Staging a batch, its decode and capped extraction, and the copy of
    its packed row to pinned memory make no call that waits for the card
    (torch.cuda.set_sync_debug_mode("error") raises on one)."""
    from fastsmc_tpu_torch.pipelines.fastsmc import _to_host

    arrays = _packed_inputs()

    def queue():
        staged = [kernels.stage(x, gpu.device) for x in arrays]
        packed, ages, _ = _packed_call(gpu, [d for d, _ in staged])
        rows = (_to_host(packed), _to_host(ages))
        event = torch.cuda.Event()
        event.record()
        return staged, rows, event

    queue()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        staged, (packed, ages), event = queue()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    event.synchronize()
    assert packed.is_pinned() and packed.dtype == torch.int32
    assert 0 < int(packed[-2]) <= 4096 and ages.shape == (2, 4096)


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
        start, b, score, nk, nr = seg.unpack_extract_rows(
            packed.cpu().numpy(), 4096)
        assert nk <= 4096 and nr <= 4096
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
        f_packed.cpu().numpy(), 4096)
    assert sum(ns_kept) == nk > 0
    np.testing.assert_array_equal(start, f_start[:nk])
    np.testing.assert_array_equal(b, f_b[:nk])
    np.testing.assert_array_equal(score, f_score[:nk])
    np.testing.assert_array_equal(
        np.concatenate([a[:, :n] for a, n in zip(ages.cpu().numpy(),
                                                 ns_kept)], axis=1),
        f_ages.cpu().numpy()[:, :nk])
