"""Forward and backward+combine decode: CUDA kernels and their plain versions.

Counterpart of ``fastsmc_tpu/engine/kernels.py`` (``PallasDecoder``): array
and sequence mode, on the exact, fast and turbo profiles. Each kernel has a
plain PyTorch version in this module:

  * :func:`forward` launches ``csrc/hmm_forward.cu`` (replaces the Pallas
    ``_make_fwd_kernel``); :func:`forward_reference` is its plain version.
  * :func:`backward_combine` launches ``csrc/hmm_backward.cu`` (replaces
    ``_make_bwd_kernel``) for all six :class:`BwdOutputs`, and for the two
    sums over pairs ``csrc/hmm_reduce.cu`` (:func:`block_reduce`), which
    adds the backward kernel's per-block partials;
    :func:`backward_combine_reference` and :func:`block_reduce_reference`
    are their plain versions.

The profiles are the JAX package's (``_PRECISIONS`` kernels.py:59-73,
``_profile_kwargs`` pipelines/asmc.py:33-42). "exact": f32 products, f32
alpha, the carry normalised at every scaling site. "fast" and "turbo": both
operands of every product rounded to bf16 (to nearest even) and the product
accumulated in f32 -- the TPU's single-pass matrix unit -- and alpha stored
as bf16; turbo stores the operators as bf16, fast rounds f32 operators as
it reads them, so the two give the same bits. In array mode the
approximate profiles normalise the carry only at the last site of each
``BLOCK_SITES``-site block (kernels.py:135-148, :233-243, :394-398); the
posterior combine renormalises every site, so this is exact in exact
arithmetic.

The forward kernel computes the exact profile's products on tensor cores as
3xTF32 (each operand split into two TF32 values, three products summed in
f32; never a single TF32 pass) and the sequence-mode fast/turbo products as
bf16 on tensor cores, each held to its plain version by the same tolerance
as before; its array-mode fast/turbo branch runs on the FP32 pipe with the
plain version's order of sums, the only order that stays within that
branch's tolerance, from the operators' bf16 values transposed
(``tables.tile_operators``, made once per operator tensor;
csrc/hmm_forward.cu).

A wrapper runs the plain version only for tensors on the CPU. For a CUDA
tensor it launches its kernel or raises; ``LAUNCHES`` counts the launches
of each kernel instantiation (:func:`kernel_name`).
"""

from __future__ import annotations

import collections
import contextlib
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.utils.weak import WeakIdKeyDictionary

from ..utils.timer import SpanRecorder
from . import segments as seg
from ._build import load_library
from .oracle import DecodeContext
from .tables import DecodeTables, tile_operators

# launches per kernel instantiation since the last clear(): the wrapper
# adds one exactly where it launches its kernel
LAUNCHES: collections.Counter = collections.Counter()

PROFILES = ("exact", "fast", "turbo")
# the C interface's profile codes (csrc/hmm_common.cuh)
_PROFILE_CODE = {"exact": 0, "fast": 1, "turbo": 2}
# sites per normalisation block on the approximate profiles, array mode; the
# TPU's S (kernels.py:401-434) is a VMEM shape, 8 wherever it fits. Every
# decode window (a power-of-two multiple of 64 sites) is a whole number of
# blocks.
BLOCK_SITES = 8


class BwdOutputs(NamedTuple):
    posterior: bool = True
    posterior_sums: bool = False
    per_pair_mean: bool = False
    per_pair_map: bool = False           # argmax_k posterior (state index)
    threshold_sums: bool = False         # sum_{k < state_threshold} posterior
    major_minor_sums: bool = False       # 00/01/11-partitioned pair sums


class Seq(NamedTuple):
    """Sequence-mode operands of one pass over a window (kernels.py:506-531):
    the rate operator of each step and the homozygous emission the step's
    first product is weighted by; the step's first operator (the seq-gap
    one) is the pass's ``ops``."""
    rops: torch.Tensor   # int32 [T]
    hem: torch.Tensor    # f32 [T, KP]


# outputs the backward kernel produces
KERNEL_OUTPUTS = BwdOutputs._fields
# pairs a backward-kernel block owns (kPairs in csrc/hmm_common.cuh): the
# over-pairs sums leave one partial per block
PAIRS_PER_BLOCK = 32


def kernel_name(kernel: str, seq: bool, profile: str) -> str:
    """``LAUNCHES`` key of one instantiation, e.g. ``hmm_forward`` (array,
    exact), ``hmm_backward_seq``, ``hmm_forward_seq_turbo``."""
    return kernel + ("_seq" if seq else "") + \
        ("" if profile == "exact" else f"_{profile}")


def alpha_dtype(profile: str) -> torch.dtype:
    return torch.float32 if profile == "exact" else torch.bfloat16


def operator_dtype(profile: str) -> torch.dtype:
    return torch.bfloat16 if profile == "turbo" else torch.float32


def _check_profile(profile: str) -> None:
    if profile not in PROFILES:
        raise ValueError(f"unknown decode profile {profile!r}; one of "
                         f"{PROFILES}")


def resolve_device(device) -> torch.device:
    """``torch.device(device)``; a CUDA device without CUDA raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           "available")
    return dev


def _emission(em_t, obs_t):
    """[3, KP] component rows x [2, P] observations -> [KP, P]."""
    return (em_t[0][:, None] + em_t[1][:, None] * obs_t[0][None, :]
            + em_t[2][:, None] * obs_t[1][None, :])


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 (nearest even), back in f32."""
    return x.to(torch.bfloat16).float()


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


def _mm(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``a @ x`` for x [S, P], with each column's bits independent of P: a
    matrix product's order of additions a column does not depend on the
    width, but a one-column product is a matrix-vector one, so one column
    is multiplied as two. The plain versions build on it and on
    :func:`_col_sum`, so that a pair's bits do not depend on its batch, as
    the kernels' do not."""
    if x.shape[-1] == 1:
        return (a @ x.expand(-1, 2))[:, :1]
    return a @ x


def _col_sum(x: torch.Tensor, ones: torch.Tensor) -> torch.Tensor:
    """Sum over the state axis of ``x`` [S, P], per pair: ``[P]``, as a
    product with ``ones`` (an f32 ones matrix [2, >= S]); torch's CPU
    reduction over the leading axis picks its order of additions from the
    width."""
    return _mm(ones[:, :x.shape[0]], x)[0]


def _ones(KP: int, device) -> torch.Tensor:
    return torch.ones((2, KP), dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _profile_ops(profile: str, seq, norm_block):
    _check_profile(profile)
    approx = profile != "exact"
    if norm_block is None:
        norm_block = approx and seq is None
    if norm_block and seq is not None:
        # two half-steps a site: the homozygous emissions of long gaps
        # underflow an unnormalised f32 carry within a block
        raise ValueError("block normalisation is for array mode only")
    return (_bf16 if approx else _identity), norm_block


def forward_reference(Mf, em, obs, isp, ops, mask, seq: Optional[Seq] = None,
                      profile: str = "exact",
                      norm_block: Optional[bool] = None) -> torch.Tensor:
    """alpha ``[T, KP, P]`` (bf16 on the approximate profiles): the forward
    recursion of kernels.py:96-165. ``norm_block`` (default: the profile's
    rule) normalises at site 0 and at the last site of each
    ``BLOCK_SITES``-site block instead of where ``mask`` is set."""
    rnd, norm_block = _profile_ops(profile, seq, norm_block)
    T = obs.shape[0]
    M = rnd(Mf.index_select(0, ops).float())          # [T, KP, KP]
    if seq is not None:
        M2 = rnd(Mf.index_select(0, seq.rops).float())
    alpha = torch.empty((T, Mf.shape[-1], obs.shape[2]),
                        dtype=alpha_dtype(profile), device=obs.device)
    ones = _ones(Mf.shape[-1], obs.device)
    c = isp[:, None] * _emission(em[0], obs[0])
    c = c / _col_sum(c, ones)
    alpha[0] = c
    for t in range(1, T):
        if seq is None:
            c = _mm(M[t], rnd(c)) * _emission(em[t], obs[t])
        else:
            # kernels.py:128-134: homozygous half-step, then marker step
            mid = _mm(M[t], rnd(c)) * seq.hem[t][:, None]
            c = _mm(M2[t], rnd(mid)) * _emission(em[t], obs[t])
        if norm_block:
            if t % BLOCK_SITES == BLOCK_SITES - 1:
                c = c * (1.0 / _col_sum(c, ones))
        else:
            c = c * torch.where(mask[t] != 0, 1.0 / _col_sum(c, ones), 1.0)
        alpha[t] = c
    return alpha


def backward_combine_reference(Mb, em, obs, alpha, ops, mask, K: int,
                               state_threshold: int, outs: BwdOutputs,
                               exp_times=None, seq: Optional[Seq] = None,
                               profile: str = "exact",
                               norm_block: Optional[bool] = None) -> dict:
    """Backward recursion + posterior combine of kernels.py:185-293.
    Returns the requested outputs at the kernel's padded shapes, all f32:
    posterior [T, KP, P], posterior_sums [T, KP], per_pair_mean,
    per_pair_map, threshold_sums [T, P], major_minor_sums [T, 3, KP].
    With ``norm_block`` beta is normalised at the last site of each
    ``BLOCK_SITES``-site block counted from the window's end."""
    rnd, norm_block = _profile_ops(profile, seq, norm_block)
    T, KP, P = alpha.shape
    dev = alpha.device
    M = rnd(Mb.index_select(0, ops).float())
    if seq is not None:
        M2 = rnd(Mb.index_select(0, seq.rops).float())
    f32 = dict(dtype=torch.float32, device=dev)
    shapes = dict(posterior=(T, KP, P), posterior_sums=(T, KP),
                  per_pair_mean=(T, P), per_pair_map=(T, P),
                  threshold_sums=(T, P), major_minor_sums=(T, 3, KP))
    out = {name: torch.empty(shapes[name], **f32)
           for name in BwdOutputs._fields if getattr(outs, name)}
    ones = _ones(KP, dev)
    beta = torch.where(torch.arange(KP, device=dev) < K, 1.0 / K, 0.0)
    beta = beta.to(torch.float32)[:, None].expand(KP, P)
    for pos in range(T - 1, -1, -1):
        if pos < T - 1:
            e = _emission(em[pos + 1], obs[pos + 1])
            if seq is None:
                c = _mm(M[pos], rnd(beta * e))
            else:
                # kernels.py:227-230
                mid = _mm(M[pos], rnd(beta * seq.hem[pos][:, None]))
                c = _mm(M2[pos], rnd(mid * e))
            if norm_block:
                g = T - 1 - pos
                beta = c * (1.0 / _col_sum(c, ones)) \
                    if g % BLOCK_SITES == BLOCK_SITES - 1 else c
            else:
                beta = c * torch.where(mask[pos] != 0,
                                       1.0 / _col_sum(c, ones), 1.0)
        post = alpha[pos].float() * beta
        post = post / _col_sum(post, ones)
        if outs.posterior:
            out["posterior"][pos] = post
        if outs.posterior_sums:
            out["posterior_sums"][pos] = post.sum(dim=1)
        if outs.per_pair_mean:
            out["per_pair_mean"][pos] = _col_sum(post * exp_times[:, None],
                                                 ones)
        if outs.per_pair_map:
            out["per_pair_map"][pos] = post.argmax(dim=0).float()
        if outs.threshold_sums:
            out["threshold_sums"][pos] = _col_sum(post[:state_threshold],
                                                  ones)
        if outs.major_minor_sums:
            # augmentSumOverPairs classes (HMM.cpp:1063-1069)
            oz, oh = obs[pos, 0], obs[pos, 1]
            out["major_minor_sums"][pos, 0] = (post * (oz * (1.0 - oh))).sum(1)
            out["major_minor_sums"][pos, 1] = (post * (1.0 - oz)).sum(1)
            out["major_minor_sums"][pos, 2] = (post * oh).sum(1)
    return out


def block_reduce_reference(part: torch.Tensor) -> torch.Tensor:
    """``part[0] + part[1] + ...`` over the leading (block) axis, in f64,
    rounded once to f32."""
    return part.double().sum(dim=0).float()


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _check(name, x, dtype, shape):
    if x.device.type != "cuda" or x.dtype != dtype or tuple(x.shape) != shape \
            or not x.is_contiguous():
        raise ValueError(f"{name}: want a contiguous {dtype} CUDA tensor of "
                         f"shape {shape}, got {x.dtype} {tuple(x.shape)} on "
                         f"{x.device} (contiguous={x.is_contiguous()})")


def _check_inputs(M, em, obs, ops, mask, seq, profile):
    if obs.device.type != "cuda":
        raise ValueError(f"no kernel for tensors on {obs.device}")
    _check_profile(profile)
    T, _, P = obs.shape
    G, KP, _ = M.shape
    _check("operators", M, operator_dtype(profile), (G, KP, KP))
    _check("em", em, torch.float32, (T, 3, KP))
    _check("obs", obs, torch.float32, (T, 2, P))
    _check("ops", ops, torch.int32, (T,))
    _check("mask", mask, torch.int32, (T,))
    tensors = [M, em, ops, mask]
    if seq is not None:
        _check("rops", seq.rops, torch.int32, (T,))
        _check("hem", seq.hem, torch.float32, (T, KP))
        tensors += list(seq)
    if any(x.device != obs.device for x in tensors):
        raise ValueError("kernel inputs lie on different devices")
    return T, P, G, KP


def _seq_ptrs(seq: Optional[Seq]):
    return (None, None) if seq is None else (seq.rops.data_ptr(),
                                             seq.hem.data_ptr())


def _raise_on(rc: int, kernel: str):
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError {rc}")


# each operator tensor's table for the forward's bf16 array branch
# (tables.tile_operators) and the tensor's version it was made from
_TILE_TABLES = WeakIdKeyDictionary()


def _tile_table(Mf: torch.Tensor) -> torch.Tensor:
    """``tile_operators(Mf)``, made at the first launch on ``Mf`` and again
    only after ``Mf`` changes in place."""
    hit = _TILE_TABLES.get(Mf)
    if hit is None or hit[0] != Mf._version:
        hit = (Mf._version, tile_operators(Mf))
        _TILE_TABLES[Mf] = hit
    return hit[1]


def forward(Mf, em, obs, isp, ops, mask, seq: Optional[Seq] = None,
            profile: str = "exact", split=None) -> torch.Tensor:
    """alpha ``[T, KP, P]`` (f32 exact, bf16 fast/turbo): the CUDA forward
    kernel for CUDA tensors, :func:`forward_reference` for CPU tensors.
    ``Mf`` is bf16 on the turbo profile, f32 otherwise. The exact profile
    needs ``split = (hi, lo)``, the operators' TF32 split that its kernel
    reads (``DecodeTables.split``); the plain version reads ``Mf``. The
    fast/turbo array-mode kernel reads ``tile_operators(Mf)``."""
    if profile == "exact" and split is None:
        raise ValueError("the exact forward needs the operators' TF32 "
                         "split (DecodeTables.split)")
    if obs.device.type == "cpu":
        return forward_reference(Mf, em, obs, isp, ops, mask, seq, profile)
    T, P, G, KP = _check_inputs(Mf, em, obs, ops, mask, seq, profile)
    _check("isp", isp, torch.float32, (KP,))
    lo = None
    if profile == "exact":
        Mf, lo = split
        _check("Mf_hi", Mf, torch.float32, (G, KP, KP))
        _check("Mf_lo", lo, torch.float32, (G, KP, KP))
    elif seq is None:
        Mf = _tile_table(Mf)
    alpha = torch.empty((T, KP, P), dtype=alpha_dtype(profile),
                        device=obs.device)
    name = kernel_name("hmm_forward", seq is not None, profile)
    rc = load_library().fastsmc_hmm_forward(
        Mf.data_ptr(), None if lo is None else lo.data_ptr(),
        _PROFILE_CODE[profile], G, em.data_ptr(), obs.data_ptr(),
        isp.data_ptr(), ops.data_ptr(), *_seq_ptrs(seq), mask.data_ptr(),
        alpha.data_ptr(), T, P, KP, obs.device.index or 0,
        torch.cuda.current_stream(obs.device).cuda_stream)
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    return alpha


def block_reduce(part: torch.Tensor) -> torch.Tensor:
    """Sum over the leading (block) axis of ``part`` ``[nblk, ...]`` f32, in
    a fixed order: the CUDA reduction kernel for a CUDA tensor,
    :func:`block_reduce_reference` for a CPU tensor."""
    if part.device.type == "cpu":
        return block_reduce_reference(part)
    _check("part", part, torch.float32, tuple(part.shape))
    out = torch.empty(part.shape[1:], dtype=torch.float32, device=part.device)
    rc = load_library().fastsmc_block_reduce(
        part.data_ptr(), out.data_ptr(), part.shape[0], out.numel(),
        part.device.index or 0,
        torch.cuda.current_stream(part.device).cuda_stream)
    _raise_on(rc, "block_reduce")
    LAUNCHES["hmm_block_reduce"] += 1
    return out


def backward_combine(Mb, em, obs, alpha, ops, mask, K: int,
                     state_threshold: int, outs: BwdOutputs,
                     exp_times=None, seq: Optional[Seq] = None,
                     profile: str = "exact") -> dict:
    """Requested :class:`BwdOutputs` at padded shapes (see
    :func:`backward_combine_reference`): the CUDA backward+combine kernel,
    and the block reduction for the sums over pairs, for CUDA tensors; the
    plain version for CPU tensors. ``exp_times`` ``[KP]`` is needed for
    ``per_pair_mean``; ``alpha`` is bf16 on the fast/turbo profiles."""
    if obs.device.type == "cpu":
        return backward_combine_reference(Mb, em, obs, alpha, ops, mask, K,
                                          state_threshold, outs, exp_times,
                                          seq, profile)
    T, P, G, KP = _check_inputs(Mb, em, obs, ops, mask, seq, profile)
    _check("alpha", alpha, alpha_dtype(profile), (T, KP, P))
    if not 0 <= state_threshold <= K <= KP:
        raise ValueError(f"need 0 <= state_threshold={state_threshold} <= "
                         f"K={K} <= KP={KP}")
    if outs.per_pair_mean:
        if exp_times is None:
            raise ValueError("per_pair_mean needs exp_times")
        _check("exp_times", exp_times, torch.float32, (KP,))
    nblk = -(-P // PAIRS_PER_BLOCK)
    shapes = dict(posterior=(T, KP, P), threshold_sums=(T, P),
                  per_pair_mean=(T, P), per_pair_map=(T, P),
                  posterior_sums=(nblk, T, KP),
                  major_minor_sums=(nblk, T, 3, KP))
    buf = {name: torch.empty(shape, dtype=torch.float32, device=obs.device)
           for name, shape in shapes.items() if getattr(outs, name)}

    def ptr(name):
        return buf[name].data_ptr() if name in buf else None

    name = kernel_name("hmm_backward", seq is not None, profile)
    rc = load_library().fastsmc_hmm_backward(
        Mb.data_ptr(), _PROFILE_CODE[profile], G, em.data_ptr(),
        obs.data_ptr(), alpha.data_ptr(), ops.data_ptr(), *_seq_ptrs(seq),
        mask.data_ptr(),
        exp_times.data_ptr() if outs.per_pair_mean else None,
        ptr("posterior"), ptr("threshold_sums"), ptr("per_pair_mean"),
        ptr("per_pair_map"), ptr("posterior_sums"), ptr("major_minor_sums"),
        T, P, K, KP, state_threshold, obs.device.index or 0,
        torch.cuda.current_stream(obs.device).cuda_stream)
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    for name in ("posterior_sums", "major_minor_sums"):
        if name in buf:
            buf[name] = block_reduce(buf[name])
    return buf


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------

class GpuDecoder:
    """Device tables + the two kernels, with the ``PallasDecoder`` interface
    the pipelines use, in the context's decoding mode and on one of
    :data:`PROFILES`. Given ``spans`` (the calling pipeline's recorder),
    each decode records its prologue, forward and backward (with the block
    reduction) and each extraction phase (the count, the sized compaction)
    its own span there, named under the caller's ``span_prefix``:
    ``<prefix>.decode.prologue``, ``.decode.forward``, ``.decode.backward``
    and ``<prefix>.extract``."""

    supports_fused_extract = True

    def __init__(self, ctx: DecodeContext, device,
                 decode_profile: str = "exact",
                 spans: Optional[SpanRecorder] = None,
                 span_prefix: str = "fastsmc"):
        _check_profile(decode_profile)
        self.spans = spans
        self.span_prefix = span_prefix
        self.device = resolve_device(device)
        self.profile = decode_profile
        self.alpha_dtype = alpha_dtype(decode_profile)
        self.tables = DecodeTables.from_context(
            ctx, self.device, operator_dtype(decode_profile))
        self.sequence = self.tables.sequence
        self.K = self.tables.K
        self.L = self.tables.L

    @property
    def exp_times(self) -> torch.Tensor:
        """The expected times [KP] the ``per_pair_mean`` output weights the
        posterior by; set it with K times (``DecodeTables.set_expected_
        times``)."""
        return self.tables.exp_times

    @exp_times.setter
    def exp_times(self, times) -> None:
        self.tables.set_expected_times(times)

    def prologue(self, hap_a, hap_b, t0: int, T: int):
        """Kernel inputs for the window [t0, t0+T) (kernels.py:467-504):
        obs [T, 2, P] (oz=1, oh=0 past the panel), em [T, 3, KP] (identity
        rows past ``real``), ops_f/ops_b [T] (identity outside the window's
        real gaps; the seq-gap operators in sequence mode) and the scaling
        mask [T], all on the tables' device. ``hap_a``/``hap_b`` are int
        tensors on that device (:func:`stage`; then nothing here waits for
        the device) or host arrays."""
        t = self.tables
        L, dev = self.L, t.device
        real = min(T, L - t0)
        steps = torch.arange(T, device=dev)
        site = t0 + steps
        valid = steps < real
        site_c = site.clamp(max=L - 1)
        ha = torch.as_tensor(hap_a, device=dev).long()
        hb = torch.as_tensor(hap_b, device=dev).long()
        a = t.hap_bits[ha[:, None], site_c[None, :]]           # [P, T]
        b = t.hap_bits[hb[:, None], site_c[None, :]]
        xor = torch.where(valid, (a ^ b).float(), 0.0)
        hom = torch.where(valid, (a & b).float(), 0.0)
        obs = torch.stack([1.0 - xor.T, hom.T], dim=1).contiguous()
        ident_em = torch.zeros((3, t.KP), device=dev)
        ident_em[0] = 1.0
        em = torch.where(valid[:, None, None], t.em[site_c],
                         ident_em).contiguous()
        gap_f = (site - 1).clamp(0, L - 2)
        gap_b = site.clamp(0, L - 2)
        op_f, op_b = (t.seq_op, t.seq_op_bwd) if self.sequence \
            else (t.gap_op, t.gap_op)
        ops_f = torch.where((steps >= 1) & valid, op_f[gap_f], t.identity_op)
        ops_b = torch.where(steps < real - 1, op_b[gap_b], t.identity_op)
        mask = (site % t.scaling_skip) == 0
        return (obs, em, ops_f.to(torch.int32), ops_b.to(torch.int32),
                mask.to(torch.int32))

    def seq_prologue(self, t0: int, T: int):
        """Sequence-mode operands of the forward and the backward pass over
        [t0, t0+T) (kernels.py:506-531): forward step t takes the rate
        operator of site t0+t and the homozygous emissions of gap t0+t-1,
        backward step pos those of site and gap t0+pos; identity operators
        and all-ones emissions outside the window's real gaps."""
        t = self.tables
        L, dev = self.L, t.device
        real = min(T, L - t0)
        steps = torch.arange(T, device=dev)
        site = t0 + steps
        rate = t.rate_op[site.clamp(max=L - 1)]
        fwd = (steps >= 1) & (steps < real)
        bwd = steps < real - 1
        hem_f = torch.where(fwd[:, None], t.homoz[(site - 1).clamp(0, L - 2)],
                            1.0)
        hem_b = torch.where(bwd[:, None], t.homoz[site.clamp(0, L - 2)], 1.0)
        return (Seq(torch.where(fwd, rate, t.identity_op).to(torch.int32),
                    hem_f.contiguous()),
                Seq(torch.where(bwd, rate, t.identity_op).to(torch.int32),
                    hem_b.contiguous()))

    def _span(self, name: str):
        return contextlib.nullcontext() if self.spans is None \
            else self.spans.span(f"{self.span_prefix}.{name}")

    def forward_pass(self, hap_a, hap_b, t0: int, T: int) -> "Forward":
        """The prologue and the forward kernel over [t0, t0+T), queued."""
        t = self.tables
        with self._span("decode.prologue"):
            obs, em, ops_f, ops_b, mask = self.prologue(hap_a, hap_b, int(t0),
                                                        int(T))
            seq_f = seq_b = None
            if self.sequence:
                seq_f, seq_b = self.seq_prologue(int(t0), int(T))
        with self._span("decode.forward"):
            alpha = forward(t.Mf, em, obs, t.isp, ops_f, mask, seq_f,
                            self.profile, t.split)
        return Forward(obs, em, ops_b, mask, seq_b, alpha)

    def backward_pass(self, fwd: "Forward", outs: BwdOutputs,
                      state_threshold: int) -> dict:
        """The backward+combine kernel after :meth:`forward_pass`, queued;
        alpha is freed once the caller drops ``fwd``."""
        t = self.tables
        with self._span("decode.backward"):
            return backward_combine(t.Mb, fwd.em, fwd.obs, fwd.alpha,
                                    fwd.ops_b, fwd.mask, self.K,
                                    int(state_threshold), outs, t.exp_times,
                                    fwd.seq_b, self.profile)

    def decode_pairs(self, hap_a, hap_b, t0: int = 0,
                     t_len: Optional[int] = None,
                     outputs: BwdOutputs = BwdOutputs(),
                     state_threshold: int = 0) -> dict:
        """Decode hap pairs over [t0, t0+t_len); the requested outputs at
        ``PallasDecoder.decode_pairs``'s shapes: posterior [T, K, P],
        posterior_sums [T, K], per_pair_mean / per_pair_map /
        threshold_sums [T, P], major_minor_sums [T, 3, K]."""
        T = self.L - t0 if t_len is None else int(t_len)
        r = self.backward_pass(self.forward_pass(hap_a, hap_b, t0, T),
                               outputs, state_threshold)
        if "posterior" in r:
            r["posterior"] = r["posterior"][:, :self.K]
        for name in ("posterior_sums", "major_minor_sums"):
            if name in r:
                r[name] = r[name][..., :self.K]
        return r

    def count_pass(self, fwd: "Forward", state_threshold: int, s0: int,
                   s1: int, prob_threshold: float, age_threshold: int,
                   need_ages: bool = True, w0=None, w1=None) -> "Counted":
        """The backward after ``fwd`` (the posterior only with ages), the
        window mask and the count phase (``segments.count_runs``), queued;
        the counts are copied to pinned host memory behind an event. Read
        them with :meth:`read_counts`, then extract with
        :meth:`extract_counted`, which frees the posterior."""
        outs = BwdOutputs(posterior=need_ages, threshold_sums=True)
        r = self.backward_pass(fwd, outs, state_threshold)
        th = r["threshold_sums"]
        with self._span("extract"):
            if w0 is not None:
                th = seg.mask_window(th, w0, w1)
            rc = seg.count_runs(th, s0, s1, prob_threshold)
            counts = to_host(rc.counts)
            event = None
            if rc.counts.device.type == "cuda":
                event = torch.cuda.Event()
                event.record()
        post = r["posterior"][:, :age_threshold] if need_ages else None
        return Counted(th, int(s1), rc, post, counts, event)

    @staticmethod
    def read_counts(c: "Counted") -> list:
        """``[(n_raw, n_kept)]`` of a counted batch, once its event has
        fired (the host waits for it here)."""
        if c.event is not None:
            c.event.synchronize()
        return [tuple(c.counts.tolist())]

    def extract_counted(self, c: "Counted", cap: int, kcap: int,
                        age_threshold: int):
        """The sized compaction (``segments.compact_runs``) of a counted
        batch at caps no smaller than its counts (``segments.sized_caps``),
        and the per-run ages, queued: ``(packed [3*kcap+2] int32, ages
        [2, kcap] f32 (posterior mean, MAP) or None)``."""
        with self._span("extract"):
            packed, pps = seg.compact_runs(c.th, c.s1, c.runs, cap, kcap,
                                           c.posterior)
            if pps is None:
                return packed, None
            t = self.tables
            return packed, seg.run_ages(pps, t.exp_times[:self.K],
                                        t.isp[:self.K], age_threshold)


class Forward(NamedTuple):
    """A batch after :meth:`GpuDecoder.forward_pass`: the backward's inputs
    and alpha."""
    obs: torch.Tensor
    em: torch.Tensor
    ops_b: torch.Tensor
    mask: torch.Tensor
    seq_b: Optional[Seq]
    alpha: torch.Tensor


class Counted(NamedTuple):
    """A batch between its count and its sized extraction
    (:meth:`GpuDecoder.count_pass`)."""
    th: torch.Tensor                    # threshold sums [T, P], masked
    s1: int
    runs: seg.RunCount                  # levels, flags, counts on the device
    posterior: Optional[torch.Tensor]   # [T, age_threshold, P] or None
    counts: torch.Tensor                # int32 [2] on the host
    event: Optional[torch.cuda.Event]   # after the counts' copy (CUDA)


def to_host(x: torch.Tensor) -> torch.Tensor:
    """``x`` on the host: for a CUDA tensor a pinned buffer with the copy
    queued (read it after an event recorded later has fired); a CPU tensor
    as it is."""
    if x.device.type != "cuda":
        return x
    h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    h.copy_(x, non_blocking=True)
    return h


def stage(x, device: torch.device, dtype=np.int32):
    """``(tensor, source)``: host array ``x`` as a tensor on ``device``.
    For a CUDA device it is copied from a pinned tensor with
    ``non_blocking=True``, so the host does not wait; ``source`` is that
    pinned tensor, which must stay alive until an event recorded after the
    copy has fired. For the CPU, ``source`` is None."""
    h = torch.from_numpy(np.ascontiguousarray(x, dtype=dtype))
    if device.type != "cuda":
        return h, None
    pinned = h.pin_memory()
    return pinned.to(device, non_blocking=True), pinned
