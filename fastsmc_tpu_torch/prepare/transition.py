"""Coalescent transition quantities (offline model preparation).

The port's copy of ``fastsmc_tpu/prepare/transition.py`` (host numpy/scipy;
its outputs equal the JAX package's bit for bit).

From-scratch reimplementation of the reference Java tool
``TOOLS/PREPARE_DECODING/src/ASMCprepareDecoding/Transition.java`` with the
per-genetic-distance omega chains vectorised over the *entire* distance grid
(the Java code loops distances one at a time; here every 4x4 matrix
exponential is batched with scipy's stacked ``expm``).

Math preserved exactly (all float64):
  * CSC transition generator (Transition.java:258-272):
        A = [[-rho, rho,           0,     0],
             [eta, -(2*eta+rho/2), rho/2, eta],
             [0,    4*eta,        -5*eta, eta],
             [0,    0,             0,     0]],  rho = 2*r*t, eta = t/N
  * omega chains snapshotted at interval expected times and boundaries
    (Transition.java:430-451)
  * D/B/U/RR extraction (Transition.java:152-209)
  * coalescent helper integrals (Transition.java:292-428)
  * column ratios (Transition.java:453-481)
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
from scipy.linalg import expm as _expm

INF = float("inf")

_ROW_INF = np.array([0.0, 0.0, 0.0, 1.0])


def read_demography(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Demography file: ``time  size`` per line; appends (inf, last size)
    like the reference CLI (ASMCprepareDecoding.java:162-176)."""
    times, sizes = [], []
    with open(path) as f:
        for line in f:
            fields = line.split()
            if not fields:
                continue
            times.append(float(fields[0]))
            sizes.append(float(fields[1]))
    times.append(INF)
    sizes.append(sizes[-1])
    return np.asarray(times), np.asarray(sizes)


def read_discretization(path: str) -> np.ndarray:
    """Discretization file: one boundary per line; appends inf
    (ASMCprepareDecoding.java:184-194)."""
    vals = []
    with open(path) as f:
        for line in f:
            fields = line.split()
            if not fields:
                continue
            vals.append(float(fields[0]))
    vals.append(INF)
    return np.asarray(vals)


@dataclasses.dataclass
class Transition:
    time_vector: np.ndarray        # [M+1] demography boundaries, last = inf
    size_vector: np.ndarray        # [M+1] sizes
    discretization: np.ndarray     # [K+1] boundaries, last = inf

    def __post_init__(self):
        self.states = len(self.discretization) - 1
        self.expected_times = self.expected_interval_times_piecewise()
        self._compute_coalescent_vectors()

    # -- piecewise coalescent helpers (Transition.java:292-428) -------------
    def find_interval(self, t: float) -> int:
        if t == INF:
            return len(self.size_vector) - 1
        idx = int(np.searchsorted(self.time_vector, t, side="right")) - 1
        return idx

    def expected_time_from_s_to_t(self, time_s: float, time_t: float) -> float:
        """Transition.java:292-316 (expectedTimeFromStoT)."""
        tv_inf = np.append(self.time_vector, INF)
        index_from = self.find_interval(time_s)
        index_to = self.find_interval(time_t)
        expected = 0.0
        rate = 0.0
        for i in range(index_from, index_to + 1):
            t0 = max(time_s, tv_inf[i])
            t1 = min(time_t, tv_inf[i + 1])
            n = self.size_vector[i]
            if t0 == t1:
                continue
            if t1 == INF:
                piece = math.exp((time_s - t0) / n) * (n - time_s + t0)
            else:
                piece = math.exp(time_s / n) * (
                    (n - time_s + t0) / math.exp(t0 / n)
                    - (n - time_s + t1) / math.exp(t1 / n))
            rate -= (t1 - t0) / n
            expected += piece
        norm = 1 - math.exp(rate)
        return expected / norm + time_s

    def expected_interval_times_piecewise(self) -> np.ndarray:
        d = self.discretization
        return np.array([self.expected_time_from_s_to_t(d[i], d[i + 1])
                         for i in range(self.states)])

    def not_coalesce_from_s_to_t(self, time_s: float, time_t: float) -> float:
        if time_t == INF:
            return 0.0
        i0, i1 = self.find_interval(time_s), self.find_interval(time_t)
        rate = 0.0
        for i in range(i0, i1 + 1):
            rate += (max(time_s, self.time_vector[i])
                     - min(time_t, self.time_vector[i + 1])) / self.size_vector[i]
        return math.exp(rate)

    def coalesce_from_s_to_t(self, time_s: float, time_t: float) -> float:
        if time_t == INF:
            return 0.0
        i0, i1 = self.find_interval(time_s), self.find_interval(time_t)
        rate = 0.0
        for i in range(i0, i1 + 1):
            rate += (max(time_s, self.time_vector[i])
                     - min(time_t, self.time_vector[i + 1])) / self.size_vector[i]
        nt = self.size_vector[self.find_interval(time_t)]
        return math.exp(rate) / nt

    def cumulative_coalesce_from_s_to_t(self, time_s: float, time_t: float) -> float:
        nt = self.size_vector[self.find_interval(time_t)]
        return 1 - nt * self.coalesce_from_s_to_t(time_s, time_t)

    def cumulative_coalesce_from_s_to_t_smart(self, time_s, time_t) -> float:
        return 1 - self.not_coalesce_from_s_to_t(time_s, time_t)

    def _compute_coalescent_vectors(self):
        K = self.states
        et, d = self.expected_times, self.discretization
        self.prob_not_coalesce_between_expected_times = np.array(
            [self.not_coalesce_from_s_to_t(et[i], et[i + 1]) for i in range(K - 1)])
        self.prob_not_coalesce_between_time_intervals = np.array(
            [self.not_coalesce_from_s_to_t(d[i], d[i + 1]) for i in range(K)])
        self.prob_coalesce_between_expected_times_and_upper_limit = np.array(
            [self.cumulative_coalesce_from_s_to_t_smart(et[i], d[i + 1])
             for i in range(K)])
        cr = np.zeros(K - 1)
        pn = self.prob_not_coalesce_between_time_intervals
        for i in range(1, K - 1):
            v = pn[i] * (1 - pn[i + 1]) / (1 - pn[i])
            cr[i] = 1.0 if math.isnan(v) else v
        self.column_ratios = cr

    def initial_state_prob(self) -> np.ndarray:
        K = self.states
        out = np.zeros(K)
        last = 0.0
        for i in range(K):
            c = self.cumulative_coalesce_from_s_to_t(0.0, self.discretization[i + 1])
            out[i] = c - last
            last = c
        return out

    def get_coal_dist(self) -> np.ndarray:
        """Transition.java:483-494."""
        K = self.states
        out = np.zeros(K)
        last = 0.0
        for i in range(1, K + 1):
            c = self.cumulative_coalesce_from_s_to_t(0.0, self.discretization[i])
            out[i - 1] = c - last
            last = c
        return out

    # -- vectorised omega chains --------------------------------------------
    def _segment_plan(self):
        """Cut [0, last finite breakpoint] at every demography boundary,
        discretization boundary, and interval expected time, in order.

        Returns (segments, exp_snapshot_after, bound_snapshot_after) where
        segments is a list of (N, dt); snapshot lists map segment index ->
        interval index whose expected-time / boundary omega is recorded
        *after* multiplying that segment's matrix.

        Mirrors getOmegas (Transition.java:430-451): for each interval i,
        multiply pieces start->expTime (snapshot expected), then
        expTime->end (snapshot boundary); the final infinite interval end
        uses the absorbing matrix.
        """
        segments = []
        exp_snap = {}
        bound_snap = {}
        for i in range(self.states):
            start = self.discretization[i]
            mid = self.expected_times[i]
            end = self.discretization[i + 1]
            # start -> expected time
            i0, i1 = self.find_interval(start), self.find_interval(mid)
            for j in range(i0, i1 + 1):
                t0 = max(start, self.time_vector[j])
                t1 = min(mid, self.time_vector[j + 1])
                segments.append((self.size_vector[j], t1 - t0))
            exp_snap[len(segments) - 1] = i
            # expected time -> boundary
            if end == INF:
                segments.append((None, None))
            else:
                i0, i1 = self.find_interval(mid), self.find_interval(end)
                for j in range(i0, i1 + 1):
                    t0 = max(mid, self.time_vector[j])
                    t1 = min(end, self.time_vector[j + 1])
                    segments.append((self.size_vector[j], t1 - t0))
            bound_snap[len(segments) - 1] = i
        return segments, exp_snap, bound_snap

    def omegas_batch(self, r_values: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """All omega row-vectors for every genetic distance in ``r_values``.

        Returns (omegas_at_boundaries [R, K+1, 4],
                 omegas_at_expected_times [R, K, 4]).
        """
        r = np.asarray(r_values, dtype=np.float64)
        R = len(r)
        K = self.states
        segments, exp_snap, bound_snap = self._segment_plan()

        bound = np.zeros((R, K + 1, 4))
        expd = np.zeros((R, K, 4))
        omega = np.zeros((R, 4))
        omega[:, 0] = 1.0  # identity row 0
        bound[:, 0, :] = omega

        for s_idx, (N, dt) in enumerate(segments):
            if N is None:
                # absorbing infinite-time matrix: every row -> [0,0,0,1]
                total = omega.sum(axis=1)
                omega = np.zeros_like(omega)
                omega[:, 3] = total
            else:
                rho = 2.0 * r * dt                        # [R]
                eta = dt / N                              # scalar
                A = np.zeros((R, 4, 4))
                A[:, 0, 0] = -rho
                A[:, 0, 1] = rho
                A[:, 1, 0] = eta
                A[:, 1, 1] = -(2 * eta + rho / 2)
                A[:, 1, 2] = rho / 2
                A[:, 1, 3] = eta
                A[:, 2, 1] = 4 * eta
                A[:, 2, 2] = -5 * eta
                A[:, 2, 3] = eta
                M = _expm(A)
                omega = np.einsum("rj,rjk->rk", omega, M)
            if s_idx in exp_snap:
                expd[:, exp_snap[s_idx], :] = omega
            if s_idx in bound_snap:
                bound[:, bound_snap[s_idx] + 1, :] = omega
        return bound, expd

    def decoding_quantities_batch(self, r_values: np.ndarray):
        """D/B/U/RR for every distance (vectorised Transition.java:152-209).

        Returns (D [R,K], B [R,K-1], U [R,K-1], RR [R,K-1]).
        """
        r = np.asarray(r_values, dtype=np.float64)
        R, K = len(r), self.states
        bound, expd = self.omegas_batch(r)
        pC = self.prob_coalesce_between_expected_times_and_upper_limit
        pNii = self.prob_not_coalesce_between_time_intervals
        pNee = self.prob_not_coalesce_between_expected_times

        D = (expd[:, :, 0] + pC[None, :] * (expd[:, :, 1] + expd[:, :, 2])
             + expd[:, :, 3] - bound[:, :K, 3])
        B = bound[:, 1:K, 3] - bound[:, :K - 1, 3]
        omega_s = expd[:, :, 1] + expd[:, :, 2]          # [R, K]
        U = np.zeros((R, K - 1))
        U[:, :] = omega_s[:, :K - 1] * (1 - pC[None, :K - 1]) * (1 - pNii[None, 1:K])
        RR = np.zeros((R, K - 1))
        with np.errstate(divide="ignore", invalid="ignore"):
            RR[:, :K - 2] = (omega_s[:, :K - 2] * pNee[None, :K - 2]
                             / omega_s[:, 1:K - 1])
        RR[r == 0.0, :K - 2] = 1.0
        return D, B, U, RR
