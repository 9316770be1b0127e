"""Reference (non-batched) forward-backward decoder in numpy.

This is the in-repo mathematical specification of the ASMC HMM kernel,
mirroring the reference's own pedagogical path (``HMM::decode`` /
``getNextAlpha`` / ``getPreviousBeta``, reference HMM.cpp:1464-1721); the
port's copy of ``fastsmc_tpu/engine/oracle.py``. ``DecodeContext`` holds
the per-panel tables the decode tables are built from.

All arithmetic is float32, like the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from ..config import DecodingParams
from ..io.decoding_quantities import DecodingQuantities, round_morgans, round_physical
from ..io.haps import Data
from .emissions import EmissionTables, prepare_emissions


@dataclasses.dataclass
class DecodeContext:
    """Everything the kernel needs, precomputed once per panel."""
    params: DecodingParams
    data: Data
    dq: DecodingQuantities
    emissions: EmissionTables
    # per-gap transition row indices: gap g covers positions (g, g+1)
    gap_idx: np.ndarray            # int32 [L-1] index into dq.D rows
    rate_idx: np.ndarray           # int32 [L] index for recRateAtMarker (sequence mode)
    homoz_idx: Optional[np.ndarray]  # int32 [L-1] (sequence mode only)
    seq_gap_idx: Optional[np.ndarray]      # int32 [L-1] fwd roundMorgans(dist - rate[g+1])
    seq_gap_idx_bwd: Optional[np.ndarray]  # int32 [L-1] bwd roundMorgans(dist - rate[g])
    scaling_skip: int = 1

    @classmethod
    def build(cls, params: DecodingParams, data: Data, dq: DecodingQuantities,
              scaling_skip: int = 1) -> "DecodeContext":
        emissions = prepare_emissions(data, dq, params)
        # float32 subtraction like the reference (HMM.cpp:755: float minus float)
        g32 = data.genetic_positions.astype(np.float32)
        dist = round_morgans(g32[1:] - g32[:-1])
        gap_idx = dq.gen_dist_index(dist).astype(np.int32)
        rates = round_morgans(data.rec_rate_at_marker.astype(np.float32))
        # rate rows are only looked up in sequence mode (HMM.cpp:756 computes
        # them unconditionally but only dereferences under decodingSequence)
        rate_idx = dq.gen_dist_index(rates).astype(np.int32) \
            if params.decoding_sequence else np.zeros(data.sites, np.int32)
        homoz_idx = None
        seq_gap_idx = None
        seq_gap_idx_bwd = None
        if params.decoding_sequence:
            phys_minus1 = round_physical(np.diff(data.physical_positions) - 1)
            homoz_idx = dq.phys_dist_index(phys_minus1).astype(np.int32)
            # forward: gap (pos-1, pos) uses rate at pos (HMM.cpp:763-764)
            seq_gap_idx = dq.gen_dist_index(
                round_morgans(dist - rates[1:])).astype(np.int32)
            # backward: gap (pos, pos+1) uses rate at pos (HMM.cpp:917-918)
            seq_gap_idx_bwd = dq.gen_dist_index(
                round_morgans(dist - rates[:-1])).astype(np.int32)
        return cls(params=params, data=data, dq=dq, emissions=emissions,
                   gap_idx=gap_idx, rate_idx=rate_idx, homoz_idx=homoz_idx,
                   seq_gap_idx=seq_gap_idx, seq_gap_idx_bwd=seq_gap_idx_bwd,
                   scaling_skip=scaling_skip)

    # ------------------------------------------------------------------
    def pair_observations(self, hap_i: int, hap_j: int,
                          from_pos: int = 0, to_pos: Optional[int] = None
                          ) -> Tuple[np.ndarray, np.ndarray]:
        """(obs, hom_minor) boolean arrays over [from, to) for a hap pair
        (mirror of HMM::makeBits, HMM.cpp:147-157)."""
        to_pos = self.data.sites if to_pos is None else to_pos
        a = self.data.hap_bits[hap_i, from_pos:to_pos]
        b = self.data.hap_bits[hap_j, from_pos:to_pos]
        return (a ^ b).astype(bool), (a & b).astype(bool)


def _emission_at(ctx: DecodeContext, pos: int, obs_is_zero: float,
                 obs_is_hom: float) -> np.ndarray:
    e = ctx.emissions
    return (e.em1[pos] + e.em0minus1[pos] * np.float32(obs_is_zero)
            + e.em2minus0[pos] * np.float32(obs_is_hom)).astype(np.float32)


def _next_alpha(dq: DecodingQuantities, row: int, prev: np.ndarray,
                emission: np.ndarray) -> np.ndarray:
    """Scalar O(K) alpha recursion (HMM.cpp:1611-1633)."""
    K = dq.states
    D = dq.D[row]
    B = dq.B[row]
    U = dq.U[row]
    CR = dq.column_ratios
    alpha_c = np.empty(K + 1, dtype=np.float32)
    alpha_c[K] = 0.0
    alpha_c[K - 1] = prev[K - 1]
    for k in range(K - 2, -1, -1):
        alpha_c[k] = alpha_c[k + 1] + prev[k]
    out = np.empty(K, dtype=np.float32)
    au = np.float32(0.0)
    for k in range(K):
        if k:
            au = np.float32(U[k - 1] * prev[k - 1] + CR[k - 1] * au)
        term = au + np.float32(D[k] * prev[k])
        if k < K - 1:
            term = np.float32(term + B[k] * alpha_c[k + 1])
        out[k] = np.float32(emission[k] * term)
    return out


def _previous_beta(dq: DecodingQuantities, row: int, last: np.ndarray,
                   emission_next: np.ndarray) -> np.ndarray:
    """Scalar O(K) beta recursion (HMM.cpp:1692-1721)."""
    K = dq.states
    D = dq.D[row]
    B = dq.B[row]
    U = dq.U[row]
    RR = dq.RR[row]
    vec = (last * emission_next).astype(np.float32)
    BL = np.zeros(K, dtype=np.float32)
    s = np.float32(0.0)
    for k in range(1, K):
        s = np.float32(s + B[k - 1] * vec[k - 1])
        BL[k] = s
    BU = np.zeros(K, dtype=np.float32)
    for k in range(K - 2, -1, -1):
        BU[k] = np.float32(vec[k + 1] * U[k] + RR[k] * BU[k + 1])
    return (BL + vec * D + BU).astype(np.float32)


def decode_pair(ctx: DecodeContext, hap_i: int, hap_j: int,
                from_pos: int = 0, to_pos: Optional[int] = None) -> np.ndarray:
    """Full posterior [K, T] for one hap pair over window [from, to).

    Mirror of HMM::decode (HMM.cpp:1469-1495): forward, backward, elementwise
    multiply, per-position normalisation.
    """
    data, dq, params = ctx.data, ctx.dq, ctx.params
    to_pos = data.sites if to_pos is None else to_pos
    obs, hom = ctx.pair_observations(hap_i, hap_j, from_pos, to_pos)
    T = to_pos - from_pos
    K = dq.states

    alpha = np.empty((T, K), dtype=np.float32)
    beta = np.empty((T, K), dtype=np.float32)

    # ---- forward (HMM.cpp:1541-1608)
    em = _emission_at(ctx, from_pos, 0.0 if obs[0] else 1.0,
                      1.0 if hom[0] else 0.0)
    cur = (dq.initial_state_prob * em).astype(np.float32)
    cur = cur * np.float32(1.0 / cur.sum())
    alpha[0] = cur
    for t in range(1, T):
        pos = from_pos + t
        obs_zero = 0.0 if obs[t] else 1.0
        obs_hom = 1.0 if hom[t] else 0.0
        if params.decoding_sequence:
            hrow = ctx.homoz_idx[pos - 1]
            hemission = ctx.dq.homozygous_emissions[hrow].astype(np.float32)
            cur = _next_alpha(dq, ctx.seq_gap_idx[pos - 1], cur, hemission)
            em = _emission_at(ctx, pos, obs_zero, obs_hom)
            cur = _next_alpha(dq, ctx.rate_idx[pos], cur, em)
        else:
            em = _emission_at(ctx, pos, obs_zero, obs_hom)
            cur = _next_alpha(dq, ctx.gap_idx[pos - 1], cur, em)
        if pos % ctx.scaling_skip == 0:
            cur = cur * np.float32(1.0 / cur.sum())
        alpha[t] = cur

    # ---- backward (HMM.cpp:1636-1690)
    cur = np.full(K, np.float32(1.0))
    cur = cur * np.float32(1.0 / cur.sum())
    beta[T - 1] = cur
    for t in range(T - 2, -1, -1):
        pos = from_pos + t
        obs_zero = 0.0 if obs[t + 1] else 1.0
        obs_hom = 1.0 if hom[t + 1] else 0.0
        em_next = _emission_at(ctx, pos + 1, obs_zero, obs_hom)
        if params.decoding_sequence:
            hrow = ctx.homoz_idx[pos]
            hemission = ctx.dq.homozygous_emissions[hrow].astype(np.float32)
            cur = _previous_beta(dq, ctx.seq_gap_idx_bwd[pos], cur, hemission)
            cur = _previous_beta(dq, ctx.rate_idx[pos], cur, em_next)
        else:
            cur = _previous_beta(dq, ctx.gap_idx[pos], cur, em_next)
        if pos % ctx.scaling_skip == 0:
            cur = cur * np.float32(1.0 / cur.sum())
        beta[t] = cur

    post = alpha * beta
    post /= post.sum(axis=1, keepdims=True)
    return post.T.astype(np.float32)  # [K, T] like the reference


class OracleDecoder:
    """Non-batched scalar decoder with the BatchedDecoder interface.

    Mirror of the reference's ``noBatches`` debug path (HMM.cpp:1464-1721,
    selected by DecodingParams::noBatches): each pair is decoded by the
    scalar float32 oracle. Orders of magnitude slower than the batched
    engines — for debugging/verification only.
    """

    def __init__(self, ctx: "DecodeContext"):
        self.ctx = ctx

    def decode_pairs(self, hap_a, hap_b, t0: int = 0, t_len=None):
        import numpy as _np
        L = self.ctx.data.sites
        K = self.ctx.dq.states
        t_len = L - t0 if t_len is None else t_len
        end = min(t0 + t_len, L)
        P = len(hap_a)
        out = _np.zeros((t_len, K, P), _np.float32)
        for i, (a, b) in enumerate(zip(hap_a, hap_b)):
            post = decode_pair(self.ctx, int(a), int(b), t0, end)  # [K, T]
            out[: end - t0, :, i] = post.T
        return out
