"""Forward and backward+combine decode: CUDA kernels and their plain versions.

Counterpart of ``fastsmc_tpu/engine/kernels.py`` (``PallasDecoder``), array
mode, exact profile. Each kernel has a plain PyTorch version in this module:

  * :func:`forward` launches ``csrc/hmm_forward.cu`` (replaces the Pallas
    ``_make_fwd_kernel``); :func:`forward_reference` is its plain version.
  * :func:`backward_combine` launches ``csrc/hmm_backward.cu`` (replaces
    ``_make_bwd_kernel``) for all six :class:`BwdOutputs`, and for the two
    sums over pairs ``csrc/hmm_reduce.cu`` (:func:`block_reduce`), which
    adds the backward kernel's per-block partials;
    :func:`backward_combine_reference` and :func:`block_reduce_reference`
    are their plain versions.

A wrapper runs the plain version only for tensors on the CPU. For a CUDA
tensor it launches its kernel or raises; ``LAUNCHES`` counts the launches.
"""

from __future__ import annotations

import collections
from typing import NamedTuple, Optional

import numpy as np
import torch

from fastsmc_tpu.engine.oracle import DecodeContext

from . import segments as seg
from ._build import load_library
from .tables import DecodeTables

# launches per kernel since the last clear(): the wrapper adds one exactly
# where it launches its kernel
LAUNCHES: collections.Counter = collections.Counter()


class BwdOutputs(NamedTuple):
    posterior: bool = True
    posterior_sums: bool = False
    per_pair_mean: bool = False
    per_pair_map: bool = False           # argmax_k posterior (state index)
    threshold_sums: bool = False         # sum_{k < state_threshold} posterior
    major_minor_sums: bool = False       # 00/01/11-partitioned pair sums


# outputs the backward kernel produces
KERNEL_OUTPUTS = BwdOutputs._fields
# pairs a backward-kernel block owns (kPairs in csrc/hmm_common.cuh): the
# over-pairs sums leave one partial per block
PAIRS_PER_BLOCK = 32


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


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def forward_reference(Mf, em, obs, isp, ops, mask) -> torch.Tensor:
    """alpha ``[T, KP, P]``: the forward recursion of kernels.py:96-165
    (array branch, per-site normalisation)."""
    T = obs.shape[0]
    M = Mf.index_select(0, ops)                       # [T, KP, KP]
    alpha = torch.empty((T, Mf.shape[-1], obs.shape[2]),
                        dtype=torch.float32, device=obs.device)
    c = isp[:, None] * _emission(em[0], obs[0])
    c = c / c.sum(dim=0, keepdim=True)
    alpha[0] = c
    for t in range(1, T):
        c = (M[t] @ c) * _emission(em[t], obs[t])
        s = c.sum(dim=0, keepdim=True)
        c = c * torch.where(mask[t] != 0, 1.0 / s, 1.0)
        alpha[t] = c
    return alpha


def backward_combine_reference(Mb, em, obs, alpha, ops, mask, K: int,
                               state_threshold: int, outs: BwdOutputs,
                               exp_times=None) -> dict:
    """Backward recursion + posterior combine of kernels.py:185-293 (array
    branch). Returns the requested outputs at the kernel's padded shapes:
    posterior [T, KP, P], posterior_sums [T, KP], per_pair_mean,
    per_pair_map, threshold_sums [T, P], major_minor_sums [T, 3, KP]."""
    T, KP, P = alpha.shape
    dev = alpha.device
    M = Mb.index_select(0, ops)
    f32 = dict(dtype=torch.float32, device=dev)
    shapes = dict(posterior=(T, KP, P), posterior_sums=(T, KP),
                  per_pair_mean=(T, P), per_pair_map=(T, P),
                  threshold_sums=(T, P), major_minor_sums=(T, 3, KP))
    out = {name: torch.empty(shapes[name], **f32)
           for name in BwdOutputs._fields if getattr(outs, name)}
    beta = torch.where(torch.arange(KP, device=dev) < K, 1.0 / K, 0.0)
    beta = beta.to(torch.float32)[:, None].expand(KP, P)
    for pos in range(T - 1, -1, -1):
        if pos < T - 1:
            c = M[pos] @ (beta * _emission(em[pos + 1], obs[pos + 1]))
            s = c.sum(dim=0, keepdim=True)
            beta = c * torch.where(mask[pos] != 0, 1.0 / s, 1.0)
        post = alpha[pos] * beta
        post = post / post.sum(dim=0, keepdim=True)
        if outs.posterior:
            out["posterior"][pos] = post
        if outs.posterior_sums:
            out["posterior_sums"][pos] = post.sum(dim=1)
        if outs.per_pair_mean:
            out["per_pair_mean"][pos] = (post * exp_times[:, None]).sum(dim=0)
        if outs.per_pair_map:
            out["per_pair_map"][pos] = post.argmax(dim=0).float()
        if outs.threshold_sums:
            out["threshold_sums"][pos] = post[:state_threshold].sum(dim=0)
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


def _check_inputs(M, em, obs, ops, mask):
    if obs.device.type != "cuda":
        raise ValueError(f"no kernel for tensors on {obs.device}")
    T, _, P = obs.shape
    G, KP, _ = M.shape
    _check("operators", M, torch.float32, (G, KP, KP))
    _check("em", em, torch.float32, (T, 3, KP))
    _check("obs", obs, torch.float32, (T, 2, P))
    _check("ops", ops, torch.int32, (T,))
    _check("mask", mask, torch.int32, (T,))
    if any(x.device != obs.device for x in (M, em, ops, mask)):
        raise ValueError("kernel inputs lie on different devices")
    return T, P, G, KP


def _raise_on(rc: int, kernel: str):
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError {rc}")


def forward(Mf, em, obs, isp, ops, mask) -> torch.Tensor:
    """alpha ``[T, KP, P]`` f32: the CUDA forward kernel for CUDA tensors,
    :func:`forward_reference` for CPU tensors."""
    if obs.device.type == "cpu":
        return forward_reference(Mf, em, obs, isp, ops, mask)
    T, P, G, KP = _check_inputs(Mf, em, obs, ops, mask)
    _check("isp", isp, torch.float32, (KP,))
    alpha = torch.empty((T, KP, P), dtype=torch.float32, device=obs.device)
    rc = load_library().fastsmc_hmm_forward(
        Mf.data_ptr(), G, em.data_ptr(), obs.data_ptr(), isp.data_ptr(),
        ops.data_ptr(), mask.data_ptr(), alpha.data_ptr(), T, P, KP,
        obs.device.index or 0,
        torch.cuda.current_stream(obs.device).cuda_stream)
    _raise_on(rc, "hmm_forward")
    LAUNCHES["hmm_forward"] += 1
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
                     exp_times=None) -> dict:
    """Requested :class:`BwdOutputs` at padded shapes (see
    :func:`backward_combine_reference`): the CUDA backward+combine kernel,
    and the block reduction for the sums over pairs, for CUDA tensors; the
    plain version for CPU tensors. ``exp_times`` ``[KP]`` is needed for
    ``per_pair_mean``."""
    if obs.device.type == "cpu":
        return backward_combine_reference(Mb, em, obs, alpha, ops, mask, K,
                                          state_threshold, outs, exp_times)
    T, P, G, KP = _check_inputs(Mb, em, obs, ops, mask)
    _check("alpha", alpha, torch.float32, (T, KP, P))
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

    rc = load_library().fastsmc_hmm_backward(
        Mb.data_ptr(), G, em.data_ptr(), obs.data_ptr(), alpha.data_ptr(),
        ops.data_ptr(), mask.data_ptr(),
        exp_times.data_ptr() if outs.per_pair_mean else None,
        ptr("posterior"), ptr("threshold_sums"), ptr("per_pair_mean"),
        ptr("per_pair_map"), ptr("posterior_sums"), ptr("major_minor_sums"),
        T, P, K, KP, state_threshold, obs.device.index or 0,
        torch.cuda.current_stream(obs.device).cuda_stream)
    _raise_on(rc, "hmm_backward")
    LAUNCHES["hmm_backward"] += 1
    for name in ("posterior_sums", "major_minor_sums"):
        if name in buf:
            buf[name] = block_reduce(buf[name])
    return buf


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------

class GpuDecoder:
    """Device tables + the two kernels, with the ``PallasDecoder`` interface
    the FastSMC pipeline uses (array mode, exact profile)."""

    supports_fused_extract = True
    alpha_dtype = torch.float32

    def __init__(self, ctx: DecodeContext, device):
        self.device = resolve_device(device)
        self.tables = DecodeTables.from_context(ctx, self.device)
        self.K = self.tables.K
        self.L = self.tables.L

    def prologue(self, hap_a, hap_b, t0: int, T: int):
        """Kernel inputs for the window [t0, t0+T) (kernels.py:467-531):
        obs [T, 2, P] (oz=1, oh=0 past the panel), em [T, 3, KP] (identity
        rows past ``real``), ops_f/ops_b [T] (identity outside the window's
        real gaps) and the scaling mask [T], all on the tables' device."""
        t = self.tables
        L, dev = self.L, t.device
        real = min(T, L - t0)
        steps = torch.arange(T, device=dev)
        site = t0 + steps
        valid = steps < real
        site_c = site.clamp(max=L - 1)
        ha = torch.as_tensor(np.asarray(hap_a), dtype=torch.int64, device=dev)
        hb = torch.as_tensor(np.asarray(hap_b), dtype=torch.int64, device=dev)
        a = t.hap_bits[ha[:, None], site_c[None, :]]           # [P, T]
        b = t.hap_bits[hb[:, None], site_c[None, :]]
        xor = torch.where(valid, (a ^ b).float(), 0.0)
        hom = torch.where(valid, (a & b).float(), 0.0)
        obs = torch.stack([1.0 - xor.T, hom.T], dim=1).contiguous()
        ident_em = torch.zeros((3, t.KP), device=dev)
        ident_em[0] = 1.0
        em = torch.where(valid[:, None, None], t.em[site_c],
                         ident_em).contiguous()
        ident = torch.tensor(t.identity_op, device=dev)
        gap_f = (site - 1).clamp(0, L - 2)
        ops_f = torch.where((steps >= 1) & valid, t.gap_op[gap_f], ident)
        gap_b = site.clamp(0, L - 2)
        ops_b = torch.where(steps < real - 1, t.gap_op[gap_b], ident)
        mask = (site % t.scaling_skip) == 0
        return (obs, em, ops_f.to(torch.int32), ops_b.to(torch.int32),
                mask.to(torch.int32))

    def _decode_body(self, hap_a, hap_b, t0: int, T: int, outs: BwdOutputs,
                     state_threshold: int) -> dict:
        t = self.tables
        obs, em, ops_f, ops_b, mask = self.prologue(hap_a, hap_b, t0, T)
        alpha = forward(t.Mf, em, obs, t.isp, ops_f, mask)
        return backward_combine(t.Mb, em, obs, alpha, ops_b, mask, self.K,
                                state_threshold, outs, t.exp_times)

    def decode_pairs(self, hap_a, hap_b, t0: int = 0,
                     t_len: Optional[int] = None,
                     outputs: BwdOutputs = BwdOutputs(),
                     state_threshold: int = 0) -> dict:
        """Decode hap pairs over [t0, t0+t_len); the requested outputs at
        ``PallasDecoder.decode_pairs``'s shapes: posterior [T, K, P],
        posterior_sums [T, K], per_pair_mean / per_pair_map /
        threshold_sums [T, P], major_minor_sums [T, 3, K]."""
        T = self.L - t0 if t_len is None else int(t_len)
        r = self._decode_body(hap_a, hap_b, int(t0), T, outputs,
                              int(state_threshold))
        if "posterior" in r:
            r["posterior"] = r["posterior"][:, :self.K]
        for name in ("posterior_sums", "major_minor_sums"):
            if name in r:
                r[name] = r[name][..., :self.K]
        return r

    def decode_extract(self, hap_a, hap_b, t0: int, t_len: int,
                       state_threshold: int, s0: int, s1: int,
                       prob_threshold: float, age_threshold: int,
                       initial_state_prob, need_ages: bool = True,
                       w0=None, w1=None):
        """Decode + kept-run extraction (+ per-run ages), the counterpart of
        ``PallasDecoder._decode_extract_jit`` (kernels.py:731-763) without
        its static caps: returns exactly the kept runs as device tensors
        ``(pair, a, b, score_sum, ages)``, pair-major; ``ages`` is [2,
        n_kept] (posterior mean, MAP) or None."""
        outs = BwdOutputs(posterior=need_ages, threshold_sums=True)
        r = self._decode_body(hap_a, hap_b, int(t0), int(t_len), outs,
                              int(state_threshold))
        th = r["threshold_sums"]
        if w0 is not None:
            th = seg.mask_window(th, w0, w1)
        pair, a, b, score = seg.extract_kept_runs(th, s0, s1, prob_threshold)
        ages = None
        if need_ages:
            t = self.tables
            pps = seg.run_pps(r["posterior"][:, :self.K], pair, a, b)
            isp = torch.as_tensor(np.asarray(initial_state_prob, np.float32),
                                  device=t.device)
            ages = seg.run_ages(pps, t.exp_times[:self.K], isp, age_threshold)
        return pair, a, b, score, ages
