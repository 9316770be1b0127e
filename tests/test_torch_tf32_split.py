"""3xTF32 holds the exact profile's gate: a numpy emulation of the forward
kernel's exact-profile arithmetic against the JAX package, on the CPU.

The forward kernel (``fastsmc_tpu_torch/csrc/hmm_forward.cu``) computes the
exact profile's products on tensor cores as 3xTF32: each operand x is split
into hi = rna(x) and lo = rna(x - hi), where rna rounds to a 10-bit mantissa
to nearest, ties away from zero (``cvt.rna.tf32.f32``), and each product is
lo*hi + hi*lo + hi*hi summed in f32. The operators' split is made once on
the host (``DecodeTables.Mf_hi``, ``Mf_lo``), the carry's at every site.
Here that arithmetic runs in numpy (f32 products and sums) over 64 random
pairs of the example panel and its whole 6,759-site window. The JAX package
gives its forward pass only through its posterior, so the emulated alpha
goes through the port's plain exact backward, and that posterior is held
within KERNEL_ATOL = 1e-5 of the JAX package's plain ``BatchedDecoder``
posterior on the same pairs (the gate the kernel is held to on the card).
A single TF32 pass, rna(M) @ rna(c), must read at least 10x the 3xTF32
error: the split is what holds the gate. Readings: 3xTF32 7.6e-7 from JAX
(posterior) and 9.4e-7 from the port's plain f32 alpha; one pass 2.6e-3 and
2.5e-3. On the card the kernel reads more than this emulation (4-6e-6 from
the plain version at T=8192): its tensor cores add with truncation, not to
nearest (PERF.md §6).
"""

import numpy as np
import pytest
import torch

from fastsmc_tpu.config import DecodingParams as JaxParams
from fastsmc_tpu.engine.hmm import BatchedDecoder as JaxBatchedDecoder

from fastsmc_tpu_torch.engine import kernels
from fastsmc_tpu_torch.engine.tables import DecodeTables

from test_torch_host import contexts

KERNEL_ATOL = 1e-5
PAIRS = 64


def rna(x: np.ndarray) -> np.ndarray:
    """f32 rounded to TF32 (10 mantissa bits, ties away from zero), as f32."""
    b = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((b + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def three_pass(M, c):
    """M @ c on 3xTF32, the small products first, every sum in f32."""
    mh, ch = rna(M), rna(c)
    ml, cl = rna(M - mh), rna(c - ch)
    return (ml @ ch + mh @ cl) + mh @ ch


def one_pass(M, c):
    return rna(M) @ rna(c)


def emulated_forward(product, Mf, em, obs, isp, ops, mask):
    """The exact forward (kernels.forward_reference) with ``product`` for
    the operator product; numpy f32 throughout."""
    def emission(t):
        return em[t, 0][:, None] + em[t, 1][:, None] * obs[t, 0][None] \
            + em[t, 2][:, None] * obs[t, 1][None]

    T = obs.shape[0]
    alpha = np.empty((T, Mf.shape[-1], obs.shape[2]), np.float32)
    c = isp[:, None] * emission(0)
    c = c / c.sum(axis=0, keepdims=True)
    alpha[0] = c
    for t in range(1, T):
        c = product(Mf[ops[t]], c) * emission(t)
        if mask[t]:
            c = c * (np.float32(1.0) / c.sum(axis=0, keepdims=True))
        alpha[t] = c
    return alpha


@pytest.fixture(scope="module")
def decoded(repo_root, tmp_path_factory):
    root = str(repo_root / "artifacts" / "panels" / "example_array"
               / "example")
    dq = str(repo_root / "artifacts" / "n300.array.decodingQuantities.npz")
    out = str(tmp_path_factory.mktemp("tf32") / "out")
    jctx, ctx = contexts(JaxParams.fastsmc_defaults(
        root, dq, out, use_known_seed=True))
    H, L = ctx.data.hap_bits.shape
    rng = np.random.default_rng(0)
    ha = rng.integers(0, H, PAIRS).astype(np.int32)
    hb = ((ha + 1 + rng.integers(0, H - 1, PAIRS)) % H).astype(np.int32)
    want = np.asarray(JaxBatchedDecoder(jctx).decode_pairs(ha, hb, 0, L))
    dec = kernels.GpuDecoder(ctx, "cpu")
    t = dec.tables
    obs, em, ops_f, ops_b, mask = dec.prologue(ha, hb, 0, L)
    plain = kernels.forward_reference(t.Mf, em, obs, t.isp, ops_f, mask)
    args = [x.numpy() for x in (t.Mf, em, obs, t.isp, ops_f, mask)]
    res = {"L": L, "tables": t}
    for name, product in (("3xtf32", three_pass), ("1xtf32", one_pass)):
        alpha = torch.from_numpy(emulated_forward(product, *args))
        post = kernels.backward_combine_reference(
            t.Mb, em, obs, alpha, ops_b, mask, dec.K, 0,
            kernels.BwdOutputs())["posterior"][:, :dec.K]
        res[name] = {"posterior": float(np.abs(post.numpy() - want).max()),
                     "alpha": float((alpha - plain).abs().max())}
    return res


def test_window_is_the_whole_panel(decoded):
    assert decoded["L"] == 6759


def test_three_pass_tf32_posterior_within_kernel_atol_of_jax(decoded):
    assert decoded["3xtf32"]["posterior"] <= KERNEL_ATOL, decoded


def test_three_pass_tf32_alpha_within_kernel_atol_of_plain(decoded):
    assert decoded["3xtf32"]["alpha"] <= KERNEL_ATOL, decoded


@pytest.mark.parametrize("what", ["posterior", "alpha"])
def test_single_pass_tf32_reads_ten_times_the_error(decoded, what):
    assert decoded["1xtf32"][what] >= 10 * decoded["3xtf32"][what], decoded


def test_host_split_tables_are_tf32(decoded):
    t: DecodeTables = decoded["tables"]
    for x in (t.Mf_hi, t.Mf_lo):
        assert x.dtype == torch.float32 and x.shape == t.Mf.shape
        assert int((x.view(torch.int32) & 0x1FFF).abs().max()) == 0
    Mf = t.Mf.numpy()
    hi = rna(Mf)
    assert np.array_equal(t.Mf_hi.numpy(), hi)
    assert np.array_equal(t.Mf_lo.numpy(), rna(Mf - hi))


def test_host_split_sums_to_the_operators(decoded):
    t: DecodeTables = decoded["tables"]
    Mf = t.Mf.double()
    err = ((t.Mf_hi.double() + t.Mf_lo.double()) - Mf).abs()
    assert bool((err <= 2.0 ** -22 * Mf.abs()).all())
    assert float(t.Mf.abs().max()) > 0
