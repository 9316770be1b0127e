"""Conditioned SFS (CSFS) from a piecewise-constant demography.

The port's copy of ``fastsmc_tpu/prepare/conditioned_sfs.py`` (host
numpy/scipy).

The reference computes the CSFS by shelling out to smcpp's ``_smcpp.raw_sfs``
(TOOLS/PREPARE_DECODING/get_csfs.py:28-52); this module computes the same
quantity from first principles so decoding quantities can be prepared
without smcpp.  Validated against the shipped golden
``FILES/DECODING_QUANTITIES/30-100-2000.csfs`` (CEU demography, n=300).

Definition.  Sample n haplotypes: 2 *distinguished* + (n-2) undistinguished.
CSFS[a, b] for a TMRCA interval I = [t0, t1) is the expected number of
mutations (per site, mutation rate mu per generation) whose carriers are
exactly ``a`` of the distinguished and ``b`` of the undistinguished
haplotypes, conditioned on the distinguished pair's coalescence time
tau in I.  Entry [0, 0] stores 1 - sum(rest) (no mutation), matching
get_csfs.py:39.

Method.  A mutation at time s subtends class (a, b) iff it falls on an
ancestral lineage with ``a`` distinguished + ``b`` undistinguished
descendants, so

    CSFS[a,b] = mu * E[ integral_s  N_{a,b}(s) ds | tau in I ]

with N_{a,b}(s) the number of such lineages at time s.  Two exact pieces:

1. *Marked ancestral chain.*  (K(s), M(s)) with K = number of ancestral
   lineages of the whole sample and M in {2, 1} = number of lineages
   carrying the two marks (M: 2 -> 1 exactly at tau).  This is a Markov
   death chain: from (k, 2), rate C(k,2)-1 to (k-1, 2) and rate 1 (the
   marked pair) to (k-1, 1); from (k, 1), rate C(k,2) to (k-1, 1); all
   rates scaled by 1/size(s) per generation (the demography's size
   column is coalescent-scaled: a pair coalesces at rate 1/size, the
   same convention as Transition.java:292-428).  Interval conditioning and
   per-state occupancies integral P(K=k, M=m at s, tau in I) ds come from
   exact ``expm`` propagation over epochs (demography times + interval
   boundaries), Gauss-Legendre accumulation between boundaries, and
   closed-form tails (fundamental matrices) in the final infinite epoch.
   Survival vectors for ALL interval boundaries are swept together
   (sigma_i(s) = P(tau > B_i | state at s) satisfies one shared backward
   recursion), as are the post-tau occupancy densities (one forward sweep
   with cumulative-boundary source columns).

2. *Block contents.*  Given (K=k, M=m), the sample partition is the
   Kingman partition conditioned on the mark pattern: ordered block sizes
   uniform over compositions, contents uniform given sizes.  With
   s_k(i) = C(n-i-1, k-2)/C(n-1, k-1) (P[a given block has size i]) and
   q(n', k') = 1 - (k'-1)(n'+1)/((k'+1)(n'-1)) (P[two marks share a block
   at level k' of n' leaves]; telescoping product over pair-merge levels):

     E[N_{1,b} | k, 2] = k s_k(b+1) 2 C(n-2,b)/C(n,b+1) / (1 - q(n,k))
     E[N_{0,b} | k, 2] = k s_k(b) C(n-2,b)/C(n,b) (1-q(n-b,k-1))/(1-q(n,k))
     E[N_{2,b} | k, 1] = k s_k(b+2) C(n-2,b)/C(n,b+2) / q(n,k)
     E[N_{0,b} | k, 1] = k s_k(b) C(n-2,b)/C(n,b) q(n-b,k-1) / q(n,k)

   (nested-partition consistency supplies the q(n-b, k-1) factors for the
   marks landing outside an all-undistinguished block).

All float64, generation time units throughout (occupancy in generations
times mu = expected mutations; equals smcpp's 2*N0-scaled output times
theta = 2*mu*N0).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
from scipy.linalg import expm
from scipy.special import gammaln


# ---------------------------------------------------------------------------
# combinatorial weights
# ---------------------------------------------------------------------------

def _log_c(a, b):
    a = np.asarray(a, float)
    b = np.asarray(b, float)
    out = gammaln(a + 1) - gammaln(b + 1) - gammaln(a - b + 1)
    return np.where((b < 0) | (b > a), -np.inf, out)


def _q_same(nprime, kprime):
    """P[two specific leaves share a block at level k' of an n'-leaf
    Kingman partition] = 1 - (k'-1)(n'+1)/((k'+1)(n'-1))."""
    nprime = np.asarray(nprime, float)
    kprime = np.asarray(kprime, float)
    with np.errstate(divide="ignore", invalid="ignore"):
        sep = (kprime - 1) * (nprime + 1) / ((kprime + 1) * (nprime - 1))
    q = 1.0 - sep
    q = np.where(kprime <= 1, 1.0, q)
    q = np.where(kprime >= nprime, 0.0, q)
    return q


def block_weights(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Expected lineage counts per (a, b) class.

    Returns (V2, V1):
      V2[k-2, a, b] = E[N_{a,b} | K=k, M=2]  for k = 2..n   (a in {0,1})
      V1[j-2, a, b] = E[N_{a,b} | K=j, M=1]  for j = 2..n-1 (a in {0,2})
    with b = 0..n-2; impossible classes are zero.
    """
    ks = np.arange(2, n + 1)                    # [K2]
    bs = np.arange(0, n - 1)                    # [B]
    # log s_k(i) = C(n-i-1, k-2) / C(n-1, k-1), for i >= 1
    def log_s(i):                               # i: [B] -> [K2, B]
        return (_log_c(n - i[None, :] - 1, ks[:, None] - 2)
                - _log_c(n - 1, ks - 1)[:, None])

    log_cn2b = _log_c(n - 2, bs)                # [B]

    q_nk = _q_same(n, ks)                       # [K2]
    # q(n - b, k - 1): [K2, B]
    q_nb_k1 = _q_same((n - bs)[None, :], (ks - 1)[:, None])

    V2 = np.zeros((len(ks), 3, len(bs)))
    V1full = np.zeros((len(ks), 3, len(bs)))

    with np.errstate(divide="ignore", invalid="ignore"):
        # m = 2 ----------------------------------------------------------
        denom2 = 1.0 - q_nk                     # [K2]; zero only at k=n? no
        # a = 1, size i = b+1
        t = (np.log(ks)[:, None] + log_s(bs + 1) + np.log(2.0)
             + log_cn2b[None, :] - _log_c(n, bs + 1)[None, :])
        V2[:, 1, :] = np.exp(t) / denom2[:, None]
        # a = 0, size i = b, b >= 1
        bpos = bs >= 1
        t0 = (np.log(ks)[:, None] + log_s(bs) + log_cn2b[None, :]
              - _log_c(n, bs)[None, :])
        V2[:, 0, :] = np.where(bpos[None, :],
                               np.exp(t0) * (1.0 - q_nb_k1)
                               / denom2[:, None], 0.0)

        # m = 1 ----------------------------------------------------------
        denom1 = q_nk                           # [K2]; zero at k = n
        # a = 2, size i = b+2
        t2 = (np.log(ks)[:, None] + log_s(bs + 2) + log_cn2b[None, :]
              - _log_c(n, bs + 2)[None, :])
        V1full[:, 2, :] = np.exp(t2) / denom1[:, None]
        # a = 0, size i = b, b >= 1
        V1full[:, 0, :] = np.where(bpos[None, :],
                                   np.exp(t0) * q_nb_k1
                                   / denom1[:, None], 0.0)

    V2 = np.nan_to_num(V2, nan=0.0, posinf=0.0, neginf=0.0)
    V1full = np.nan_to_num(V1full, nan=0.0, posinf=0.0, neginf=0.0)
    # M=1 states only exist for j <= n-1
    V1 = V1full[: n - 2]
    return V2, V1



# ---------------------------------------------------------------------------
# content-augmented chains (exact post-tau combinatorics)
# ---------------------------------------------------------------------------
#
# The static composition-uniform law is exact for the pre-tau (M=2) classes
# (tau > s adds no path information), but NOT for post-tau classes: the
# merged marked block's content depends on when the marks merged, which the
# interval conditioning constrains.  Exactness requires tracking
# w = number of unmarked leaves in *unmarked* blocks:
#
#   pre-tau  state (k, w):  k total blocks, two marked blocks holding
#            u = n-2-w unmarked leaves between them;
#   post-tau state (c, w):  c unmarked blocks (j = c+1 total), the merged
#            block holding v = n-2-w unmarked leaves.
#
# Deleting/absorbing a uniformly-chosen block from a composition-uniform
# partition of w' leaves into c' blocks leaves the remainder composition-
# uniform with total w distributed as C(w-1, c'-2)/C(w'-1, c'-1) — a
# rank-1-triangular kernel, so one generator application costs O(n^2) via
# suffix sums.  Given (c, w) the unmarked blocks are composition-uniform
# (uniform block removals and Kingman merges both preserve the family),
# and the merged block's content is deterministic: v = n-2-w.


def _binom_table(n: int) -> np.ndarray:
    B = np.zeros((n + 1, n + 1))
    B[:, 0] = 1.0
    for i in range(1, n + 1):
        B[i, 1:i + 1] = B[i - 1, :i] + B[i - 1, 1:i + 1]
    return B


class _ContentChains:
    """Vectorized generator applications for the (k, w) / (c, w) chains.

    Layout: [row, ..., w] with w on the LAST (contiguous) axis so the
    suffix-cumsums of the rank-1-triangular absorb kernels stream well.
    Reciprocal tables are precomputed (zeros at invalid states), so one
    generator application is a handful of whole-array multiplies + one
    cumsum over the active row band.
    """

    def __init__(self, n: int):
        self.n = n
        self.B = _binom_table(n)
        ks = np.arange(0, n + 2)
        self.cks = ks * (ks - 1) / 2.0          # C(k, 2)
        W = n - 1
        ws = np.arange(W)
        wm = np.maximum(ws - 1, 0)
        wpos = (ws >= 1).astype(float)
        # pre-chain absorb kernel (source row r = k+1, c' = r-2): shared
        # table pre_tab[r] = B[w-1, r-3] (r >= 3): denominator at the
        # source row, multiplier at the target row
        self.pre_tab = np.zeros((n + 1, W))
        self.pre_inv = np.zeros((n + 1, W))
        for r in range(3, n + 1):
            t = self.B[wm, r - 3] * wpos
            self.pre_tab[r] = t
            np.divide(1.0, t, out=self.pre_inv[r], where=t > 0)
        # post-chain (target row c): denom B[w-1, c] (applied at source
        # c+1), mult B[w-1, c-1]
        self.post_inv = np.zeros((n - 1, W))
        self.post_mul = np.zeros((n - 1, W))
        for c in range(1, n - 1):
            d = self.B[wm, c] * wpos
            np.divide(1.0, d, out=self.post_inv[c], where=d > 0)
            self.post_mul[c] = self.B[wm, c - 1] * wpos

    @staticmethod
    def _mid(v, X):
        """Insert middle axes so v[row, w] broadcasts over X[row, ..., w]."""
        return v.reshape(v.shape[:1] + (1,) * (X.ndim - 2) + v.shape[1:])

    @staticmethod
    def _bc(v, X):
        return v.reshape(v.shape + (1,) * (X.ndim - 1))

    @staticmethod
    def _suffix_w(z):
        """S[..., w] = sum_{w' > w} z[..., w'] (along the last axis)."""
        S = z[..., ::-1].cumsum(axis=-1)[..., ::-1]
        out = np.zeros_like(S)
        out[..., :-1] = S[..., 1:]
        return out

    def pre_gdot(self, X, khi):
        """Generator action on X[k, ..., w], rows 2..khi active."""
        G = np.zeros_like(X)
        lo, hi = 2, khi
        rows = slice(lo, hi + 1)
        G[rows] = -self._bc(self.cks[lo:hi + 1], X) * X[rows]
        if hi >= lo + 1:
            up = slice(lo + 1, hi + 1)          # source rows k+1
            tgt = slice(lo, hi)                 # target rows k
            cmerge = self.cks[np.arange(lo, hi) - 1].copy()
            G[tgt] += self._bc(cmerge, X) * X[up]
            z = X[up] * self._mid(self.pre_inv[up], X)
            S = self._suffix_w(z)
            cp = np.arange(lo, hi) - 1          # c' per target row
            G[tgt] += (self._bc(2.0 * cp, X)
                       * self._mid(self.pre_tab[tgt], X) * S)
            if lo <= 2 <= hi - 1:               # c' = 1: -> (2, 0)
                G[2, ..., 0] += 2.0 * X[3].sum(axis=-1)
        return G

    def post_gdot(self, Y, clo, chi):
        """Generator action on Y[c, ..., w], rows clo..chi active."""
        G = np.zeros_like(Y)
        lo = max(clo, 1)
        hi = chi
        if hi < lo:
            return G
        rows = slice(lo, hi + 1)
        G[rows] = -self._bc(self.cks[lo + 1:hi + 2], Y) * Y[rows]
        if hi >= lo + 1:
            up = slice(lo + 1, hi + 1)
            tgt = slice(lo, hi)
            cmerge = self.cks[np.arange(lo, hi) + 1]
            G[tgt] += self._bc(cmerge, Y) * Y[up]
            z = Y[up] * self._mid(self.post_inv[tgt], Y)
            S = self._suffix_w(z)
            cabs = np.arange(lo, hi) + 1.0
            G[tgt] += (self._bc(cabs, Y)
                       * self._mid(self.post_mul[tgt], Y) * S)
        return G


def _unif_window(gdot_fn, lam, dR, X, max_a=200.0, tol=1e-18):
    """Uniformized expm action for the content chains (X any array whose
    gdot_fn implements the generator; lam >= max exit rate on the active
    window)."""
    total = lam * dR
    if total <= 0.0:
        return X
    nsub = int(np.ceil(total / max_a))
    a = total / nsub
    jmax = int(a + 10.0 * np.sqrt(a) + 30)
    for _ in range(nsub):
        term = X
        wgt = np.exp(-a)
        Y = wgt * term
        for j in range(1, jmax + 1):
            term = term + gdot_fn(term) / lam
            wgt = wgt * a / j
            Y = Y + wgt * term
            if wgt < tol and j > a:
                break
        X = Y
    return X


def _unif_joint(cc, khi, chi, active, dR, X, F, max_a=200.0, tol=1e-14):
    """Propagate the joint (pre (k,w)) + (post (c,w) columns) system over an
    R-clock interval dR and return (X', F', occF) with occF the EXACT
    occupancy integral of F over the step (R units).

    Uniformization with value and integral weights: with A = I + G/lam,
      e^{G d} v       = sum_j pois(j; a) A^j v
      int_0^d e^{G t} v dt = (1/lam) sum_j P(N_a > j) A^j v
    The coupling (mark-merge flux (k,2)->(k-2 unmarked, w), rate 1 in the
    R-clock, gated per column by ``active``) is part of the joint
    generator, so source timing within the step is exact (no trapezoid).
    """
    n = cc.n
    lam = float(max(cc.cks[khi], cc.cks[chi + 1], 1.0))
    total = lam * dR
    occF = np.zeros_like(F)
    if total <= 0.0:
        return X, F, occF
    nsub = int(np.ceil(total / max_a))
    a = total / nsub

    act = active[None, :, None]

    def gdot(tX, tF):
        gX = cc.pre_gdot(tX, khi)
        gF = cc.post_gdot(tF, 1, chi)
        gF[1:n - 1] += tX[3:n + 1][:, None, :] * act
        return gX, gF

    for _ in range(nsub):
        tX, tF = X, F
        pois = np.exp(-a)
        tail = 1.0 - pois
        vX = pois * tX
        vF = pois * tF
        oF = tail * tF
        j = 0
        while tail > tol:
            j += 1
            gX, gF = gdot(tX, tF)
            tX = tX + gX / lam
            tF = tF + gF / lam
            pois = pois * a / j
            tail = tail - pois
            vX += pois * tX
            vF += pois * tF
            oF += tail * tF
        X, F = vX, vF
        occF += oF / lam
    return X, F, occF



# ---------------------------------------------------------------------------
# marked ancestral chain
# ---------------------------------------------------------------------------

def _generators(n: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Rate-1 (coalescent R-clock) generators.

    G2: S2 states k=2..n (index k-2); exit rate C(k,2) of which
        C(k,2)-1 -> (k-1,2) and 1 -> tau (leaves S2).
    G1: S1 states j=2..n-1 (index j-2); j=2 exits to the (untracked) root.
    Gc: combined block [[G2, S], [0, G1]] with the tau coupling S
        ((k,2) -> (k-1,1) at rate 1, k >= 3).
    """
    m2 = n - 1
    G2 = np.zeros((m2, m2))
    for k in range(2, n + 1):
        i = k - 2
        c = k * (k - 1) / 2.0
        G2[i, i] = -c
        if k > 2:
            G2[i, i - 1] = c - 1.0
    m1 = n - 2
    G1 = np.zeros((m1, m1))
    for j in range(2, n):
        i = j - 2
        c = j * (j - 1) / 2.0
        G1[i, i] = -c
        if j > 2:
            G1[i, i - 1] = c
    S = np.zeros((m2, m1))
    for k in range(3, n + 1):
        S[k - 2, k - 3] = 1.0            # (k,2) -> (k-1,1)
    Gc = np.block([[G2, S], [np.zeros((m1, m2)), G1]])
    return G2, G1, Gc



def _bidiag(G):
    """(diag, subdiag) vectors of a lower-bidiagonal generator; subdiag[r]
    = G[r, r-1] (0 for r = 0)."""
    d = np.diag(G).copy()
    s = np.zeros_like(d)
    s[1:] = np.diag(G, -1)
    return d, s


def _unif_apply(d, s, dR, X, side, max_a=200.0, tol=1e-18):
    """X @ expm(G dR) (side="row", last axis = state) or expm(G dR) @ X
    (side="left", first axis = state) for a lower-bidiagonal generator G
    given by (d, s), via uniformization: expm(G dR) = e^{-lam dR}
    sum_j (lam dR)^j/j! (I + G/lam)^j.  Positive series -> stable; lam dR
    split into sub-steps of at most max_a to avoid weight underflow."""
    lam = float(-d.min())
    total = lam * dR
    if total <= 0.0:
        return X
    nsub = int(np.ceil(total / max_a))
    a = total / nsub

    if side == "row":
        def gdot(T):
            Y = T * d
            Y[..., :-1] += T[..., 1:] * s[1:]
            return Y
    else:
        def gdot(T):
            Y = T * d.reshape((-1,) + (1,) * (T.ndim - 1))
            Y[1:] += T[:-1] * s[1:].reshape((-1,) + (1,) * (T.ndim - 1))
            return Y

    jmax = int(a + 10.0 * np.sqrt(a) + 30)
    for _ in range(nsub):
        term = X
        w = np.exp(-a)
        Y = w * term
        for j in range(1, jmax + 1):
            term = term + gdot(term) / lam
            w = w * a / j
            Y = Y + w * term
            if w < tol and j > a:
                break
        X = Y
    return X


def _gl_nodes(a: float, b: float, nsub: int, order: int = 6):
    """Composite Gauss-Legendre nodes+weights on [a, b]."""
    x, w = np.polynomial.legendre.leggauss(order)
    edges = np.linspace(a, b, nsub + 1)
    nodes, weights = [], []
    for lo, hi in zip(edges[:-1], edges[1:]):
        h = 0.5 * (hi - lo)
        nodes.append(lo + h * (x + 1.0))
        weights.append(w * h)
    return np.concatenate(nodes), np.concatenate(weights)


class ConditionedSFS:
    """Exact CSFS for a piecewise-constant demography.

    times/sizes: demography change points (generations) and diploid sizes
    (TOOLS/PREPARE_DECODING CEU.demo format); disc: TMRCA interval
    boundaries in generations (finite; infinity appended); n: total
    haplotypes (distinguished + undistinguished).
    """

    def __init__(self, times, sizes, disc, n: int, mu: float = 1.65e-8,
                 order: int = 6, max_efolds: float = 2.0):
        self.times = np.asarray(times, float)
        self.sizes = np.asarray(sizes, float)
        self.disc = np.asarray(disc, float)
        self.n = int(n)
        self.mu = float(mu)
        self.order = order
        self.max_efolds = max_efolds
        if self.times[0] != 0.0:
            raise ValueError("demography must start at generation 0")
        self.G2, self.G1, self.Gc = _generators(self.n)

    # -- demography lookup ------------------------------------------------
    def _size_at(self, t: float) -> float:
        i = int(np.searchsorted(self.times, t, side="right")) - 1
        return float(self.sizes[max(i, 0)])

    def compute(self) -> List[np.ndarray]:
        """Returns one [3, n-1] conditioned matrix per disc interval
        (len(disc) intervals; the last is [disc[-1], infinity))."""
        n = self.n
        m2, m1 = n - 1, n - 2
        disc = self.disc
        nb = len(disc)                          # boundaries B_0=0..B_{nb-1}
        if disc[0] != 0.0:
            raise ValueError("discretization must start at 0")

        # --- event grid: cuts (zero weight) + GL nodes per segment -------
        G_end = float(max(self.times[-1], disc[-1]))
        cuts = np.unique(np.concatenate([self.times, disc, [G_end]]))
        cuts = cuts[cuts <= G_end]

        ev_t = [0.0]
        ev_w = [0.0]
        ev_ne = [self._size_at(0.0)]            # Ne of the step ENDING here
        # provisional forward pass for adaptive subdivision
        cur = np.zeros(m2)
        cur[-1] = 1.0
        for lo, hi in zip(cuts[:-1], cuts[1:]):
            Ne = self._size_at(lo)
            occ = np.nonzero(cur > 1e-16)[0]
            kmax = (occ.max() + 2) if len(occ) else 2
            lam = kmax * (kmax - 1) / 2.0 / Ne
            nsub = int(np.clip(np.ceil(lam * (hi - lo) / self.max_efolds),
                               1, 64))
            nodes, wts = _gl_nodes(lo, hi, nsub, self.order)
            ev_t.extend(nodes.tolist())
            ev_w.extend(wts.tolist())
            ev_ne.extend([Ne] * len(nodes))
            ev_t.append(float(hi))
            ev_w.append(0.0)
            ev_ne.append(Ne)
            cur = cur @ expm(self.G2 * ((hi - lo) / Ne))
        ev_t = np.asarray(ev_t)
        ev_w = np.asarray(ev_w)
        ev_ne = np.asarray(ev_ne)
        nev = len(ev_t)

        # --- forward sweep: exact p2 at every event ----------------------
        d2, s2 = _bidiag(self.G2)
        d1, s1 = _bidiag(self.G1)
        p2_ev = np.empty((nev, m2))
        cur = np.zeros(m2)
        cur[-1] = 1.0
        p2_ev[0] = cur
        for idx in range(1, nev):
            dR = (ev_t[idx] - ev_t[idx - 1]) / ev_ne[idx]
            cur = _unif_apply(d2, s2, dR, cur, "row")
            p2_ev[idx] = cur

        # p2 at the disc boundaries (all boundaries are events)
        bidx = np.searchsorted(ev_t, disc)
        assert np.allclose(ev_t[bidx], disc), "boundaries must be events"
        surv = p2_ev[bidx].sum(axis=1)
        Ptau = np.empty(nb)
        Ptau[:-1] = surv[:-1] - surv[1:]
        Ptau[-1] = surv[-1]

        # --- backward sweep: sigma_i(s) = P(tau > B_i | alive at s) ------
        # (identically 1 for s >= B_i); accumulate
        # A2[:, i] = integral p2(s) * sigma_i(s) ds over the finite grid
        sig = np.ones((m2, nb))
        A2 = np.zeros((m2, nb))
        for idx in range(nev - 1, -1, -1):
            if idx < nev - 1:
                dR = (ev_t[idx + 1] - ev_t[idx]) / ev_ne[idx + 1]
                sig = _unif_apply(d2, s2, dR, sig, "left")
            sig[:, disc <= ev_t[idx]] = 1.0
            if ev_w[idx]:
                A2 += ev_w[idx] * (p2_ev[idx][:, None] * sig)

        O2 = np.empty((m2, nb))
        O2[:, :-1] = A2[:, :-1] - A2[:, 1:]
        O2[:, -1] = A2[:, -1]
        # last-interval tail beyond G_end (h = 1 there)
        Ne_last = self._size_at(G_end)
        N2inv = np.linalg.inv(-self.G2)
        O2[:, -1] += (p2_ev[-1] @ N2inv) * Ne_last

        # --- content chains: exact post-tau occupancies ------------------
        # F[c, w, col]: occupancy density of the post-tau (c, w) chain for
        # paths with tau <= min(s, B_col) (col nb: tau <= s); sources are
        # the pre-tau (k, w) chain's mark-merge flux (rate 1/Ne per gen).
        cc = _ContentChains(n)
        W = n - 1
        X = np.zeros((n + 1, W))
        X[n, n - 2] = 1.0
        ncol = nb + 1
        F = np.zeros((n - 1, ncol, W))
        A1c = np.zeros((n - 1, ncol, W))
        thresh = 1e-20

        khi = n
        chi = 1
        # coarse step grid: segment cuts only — within a segment Ne and the
        # column-activity gates are constant, and _unif_joint integrates
        # occupancy exactly, so no quadrature nodes are needed here
        for lo, hi in zip(cuts[:-1], cuts[1:]):
            Ne = self._size_at(lo)
            dR = (hi - lo) / Ne
            chi = min(max(chi, khi - 2), n - 2)
            active = np.concatenate(
                [(disc >= hi), [True]]).astype(float)
            X, F, occF = _unif_joint(cc, khi, chi, active, dR, X, F)
            A1c[: chi + 1] += occF[: chi + 1] * Ne
            rs = X.sum(axis=1)
            tot = rs.sum()
            while khi > 2 and rs[khi] <= thresh * tot:
                X[khi] = 0.0
                khi -= 1
            fs = F.sum(axis=(1, 2))
            ftot = fs.sum()
            while chi > 1 and fs[chi] <= thresh * max(ftot, 1e-300):
                F[chi] = 0.0
                chi -= 1

        # --- tails beyond G_end (homogeneous; back-substitution) ---------
        def post_occupancy(Fe, hi_c):
            """Solve O (-G_post) = Fe (R-clock fundamental matrix action);
            flow is strictly downward in c, so solve top-down. Fe layout
            [c, ..., w] (w last)."""
            O = np.zeros_like(Fe)
            for c in range(hi_c, 0, -1):
                inflow = 0.0
                if c + 1 <= hi_c:
                    z = O[c + 1] * cc.post_inv[c]
                    S = z[..., ::-1].cumsum(axis=-1)[..., ::-1]
                    Ssh = np.zeros_like(S)
                    Ssh[..., :-1] = S[..., 1:]
                    inflow = (cc.cks[c + 1] * O[c + 1]
                              + (c + 1.0) * cc.post_mul[c] * Ssh)
                O[c] = (Fe[c] + inflow) / cc.cks[c + 1]
            return O

        def pre_occupancy(Xe):
            O = np.zeros((n + 1, W))
            for k in range(khi, 1, -1):
                inflow = np.zeros(W)
                if k + 1 <= khi:
                    if k >= 3:
                        inflow += cc.cks[k - 1] * O[k + 1]
                        z = O[k + 1] * cc.pre_inv[k + 1]
                        S = np.flip(np.cumsum(np.flip(z)))
                        Ssh = np.zeros_like(S)
                        Ssh[:-1] = S[1:]
                        inflow += 2.0 * (k - 1) * cc.pre_tab[k] * Ssh
                    else:       # k == 2: only the c'=1 absorb feeds (2, 0)
                        inflow[0] = 2.0 * O[3].sum()
                O[k] = (Xe[k] + inflow) / cc.cks[k]
            return O

        chi_full = n - 2
        A1c += post_occupancy(F, chi_full) * Ne_last
        # future mark-merges beyond G_end feed only the tau<=s column
        OP = pre_occupancy(X)
        tau_src = np.zeros((n - 1, W))
        tau_src[1:n - 1] = OP[3:n + 1]
        A1c[:, nb, :] += post_occupancy(tau_src, chi_full) * Ne_last

        O1c = np.empty((n - 1, nb, W))
        O1c[:, :-1, :] = A1c[:, 1:nb, :] - A1c[:, : nb - 1, :]
        O1c[:, -1, :] = A1c[:, nb, :] - A1c[:, nb - 1, :]

        self._debug = dict(O2=O2, Ptau=Ptau, A2=A2, surv=surv, O1c=O1c,
                           A1c=A1c)

        # --- combine: pre-tau (static law, exact) + post-tau (c, w) ------
        V2, _ = block_weights(n)
        B = cc.B
        ws_idx = np.arange(W)
        out = []
        for i in range(nb):
            M = np.einsum("k,kab->ab", O2[:, i], V2)
            Oi = O1c[:, i, :]
            # merged marked block: deterministic content v = n-2-w -> a=2
            M[2] += Oi.sum(axis=0)[::-1]
            # unmarked blocks: composition-uniform given (c, w) -> a=0
            M[0] += Oi[1]                       # c = 1: one block of size w
            for c in range(2, n - 1):
                row = Oi[c]
                if not row.any():
                    continue
                den = B[np.maximum(ws_idx - 1, 0), c - 1] * (ws_idx >= 1)
                z = np.divide(row, den, out=np.zeros(W), where=den > 0)
                g = np.zeros(W)
                gm = ws_idx - 1 >= c - 2
                g[gm] = B[ws_idx[gm] - 1, c - 2]
                conv = np.convolve(z, g[::-1])
                M[0] += c * conv[W - 1:2 * W - 1]
            M[0, 0] = 0.0    # (0,0) never holds a real class
            M = M * self.mu / Ptau[i]
            M[0, 0] = 1.0 - M.sum()
            out.append(M)
        return out


# ---------------------------------------------------------------------------
# .csfs file interface (get_csfs.py output format)
# ---------------------------------------------------------------------------

def write_csfs(path: str, times, sizes, mu: float, samples: int,
               disc, mats) -> None:
    """Write interval matrices in the reference .csfs text format
    (get_csfs.py:39-51: repeated Time/Size/Mu/Samples/Interval headers,
    then the 3 x (samples-1) matrix)."""
    times = np.asarray(times, float)
    sizes = np.asarray(sizes, float)
    disc = np.asarray(disc, float)
    bounds = np.append(disc, np.inf)
    with open(path, "w") as f:
        for i, M in enumerate(mats):
            f.write("Time:\t" + " ".join(map(str, times)) + "\n")
            f.write("Size:\t" + " ".join(map(str, sizes)) + "\n")
            f.write("Mu:\t" + str(mu) + "\n")
            f.write("Samples:\t" + str(samples) + "\n")
            t1 = bounds[i + 1]
            t1s = "Infinity" if np.isinf(t1) else str(t1)
            f.write(f"Interval:\t{bounds[i]}\t{t1s}\n")
            f.write("\n".join(" ".join(str(c) for c in row)
                               for row in np.asarray(M)) + "\n")


def compute_csfs_file(demography_file: str, discretization_file: str,
                      samples: int, out_path: str,
                      mu: float = 1.65e-8) -> None:
    """Drop-in replacement for the reference's smcpp-based get_csfs.py:
    compute the CSFS from the demography and write a .csfs file."""
    demo = np.loadtxt(demography_file)
    disc = np.loadtxt(discretization_file)
    c = ConditionedSFS(demo[:, 0], demo[:, 1], disc, samples, mu=mu)
    mats = c.compute()
    write_csfs(out_path, demo[:, 0], demo[:, 1], mu, samples, disc, mats)
