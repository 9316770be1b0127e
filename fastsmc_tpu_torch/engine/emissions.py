"""Per-site emission precompute.

Mirror of ``HMM::prepareEmissions`` (reference HMM.cpp:159-256): produces the
three per-site emission component tables used by the decoder's linear
combination

    em(pos, k) = em1[pos,k] + em0minus1[pos,k]*obsIsZero
                            + em2minus0[pos,k]*obsIsHomMinor

which reproduces the reference's ``getEmission`` lookup for every
(distinguished, undistinguished) case. The port's copy of
``fastsmc_tpu/engine/emissions.py``, with one departure on purpose: no
emission is negative (:func:`prepare_emissions` says where and why).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..config import DecodingParams
from ..io.decoding_quantities import DecodingQuantities
from ..io.haps import Data


@dataclasses.dataclass
class EmissionTables:
    em1: np.ndarray           # float32 [L, K]
    em0minus1: np.ndarray     # float32 [L, K]
    em2minus0: np.ndarray     # float32 [L, K]
    use_csfs_at: np.ndarray   # bool [L]
    undistinguished: np.ndarray  # int32 [L, 3]


def csfs_positions(genetic_positions: np.ndarray, skip_csfs_distance: float
                   ) -> np.ndarray:
    """Which positions use the CSFS emission (HMM.cpp:163-173)."""
    L = len(genetic_positions)
    use = np.zeros(L, dtype=bool)
    if skip_csfs_distance == float("inf"):
        return use
    use[0] = True
    last = 0.0
    for pos in range(1, L):
        if genetic_positions[pos] - last >= skip_csfs_distance:
            use[pos] = True
            last = genetic_positions[pos]
    return use


def nonnegative(x: np.ndarray) -> np.ndarray:
    """float32 ``x`` with every negative entry set to +0.0."""
    return np.where(x < 0, np.float32(0.0), x)


def raise_negative_sums(em1: np.ndarray, em0minus1: np.ndarray,
                        em2minus0: np.ndarray):
    """The guard's second step: where a class's float32 sum is below 0,
    both major ``em1 + em0minus1`` first, then both minor ``(em1 +
    em0minus1) + em2minus0`` on top of it, that class's last difference
    becomes minus the rest of the sum, so the sum is +0.0 exactly (x + -x
    rounds to +0.0). Returns the new ``(em0minus1, em2minus0)``."""
    major = em1 + em0minus1
    em0minus1 = np.where(major < 0, -em1, em0minus1)
    major = em1 + em0minus1
    em2minus0 = np.where(major + em2minus0 < 0, -major, em2minus0)
    return em0minus1, em2minus0


def prepare_emissions(data: Data, dq: DecodingQuantities,
                      params: DecodingParams) -> EmissionTables:
    """The three component tables of every site, guarded.

    One departure from ASMC, which uses its tables unguarded
    (HMM.cpp:179-207), and from the JAX package, which copies it: no
    emission is negative. The negative entries of the CSFS table the mode
    reads are set to +0.0 before any lookup, and where a class's float32
    sum of the components (differ ``em1``, both major ``em1 +
    em0minus1``, both minor ``(em1 + em0minus1) + em2minus0``, added in
    the order the kernels and the oracle add them) still falls below 0,
    that class's last difference is raised so that the sum is +0.0
    exactly. A probability model has no negatives, and with them a pair
    gets negative emissions where its mass lies and its posterior leaves
    [0, 1]: the shipped CSFS tables hold rounding negatives (down to
    -3.35e-15 in the n300 quantities), which a pair with a recent common
    ancestor that differs at a common site reads; and where a site's
    drawn [u2][0] lies far below [u0][0] at old states, the both-minor
    sum is the rounding of [u0][0], down to -9.3e-10. On a
    16,384-haplotype panel either sends posterior sums out of [0, 1]. The
    classic tables hold no negatives and are used as they are. The
    loader stays a faithful reader of the files; the guard acts here,
    however the quantities were obtained."""
    L, K = data.sites, dq.states
    und = data.calculate_undistinguished_counts(dq.csfs_samples)
    use = csfs_positions(data.genetic_positions, params.skip_csfs_distance)

    em1 = np.zeros((L, K), dtype=np.float32)
    em0m1 = np.zeros((L, K), dtype=np.float32)
    em2m0 = np.zeros((L, K), dtype=np.float32)

    seq = params.decoding_sequence
    if params.fold_data:
        table = dq.folded_csfs if seq else dq.folded_ascertained_csfs
    else:
        table = dq.csfs if seq else dq.ascertained_csfs
    table = nonnegative(table)
    classic = dq.classic_emission if seq else dq.compressed_emission

    u0 = und[:, 0]
    u1 = und[:, 1]
    u2 = und[:, 2]

    csfs_mask = use
    non = ~use
    # non-CSFS positions (HMM.cpp:242-254)
    em1[non] = classic[1]
    em0m1[non] = classic[0] - classic[1]
    # em2minus0 stays 0 (emission2 == emission0)

    idx = np.flatnonzero(csfs_mask)
    if params.fold_data:
        # folded branch (HMM.cpp:179-207)
        e1 = np.where((u1[idx] >= 0)[:, None], table[np.maximum(u1[idx], 0), 1], 0.0)
        em1[idx] = e1
        em0m1[idx] = table[u0[idx], 0] - e1
        e2 = np.where((u2[idx] >= 0)[:, None], table[np.maximum(u2[idx], 0), 0],
                      0.0)
        em2m0[idx] = e2 - table[u0[idx], 0]
    else:
        # unfolded branch (HMM.cpp:208-240)
        e1 = np.where((u1[idx] >= 0)[:, None], table[np.maximum(u1[idx], 0), 1], 0.0)
        em1[idx] = e1
        e0 = np.where((u0[idx] >= 0)[:, None], table[np.maximum(u0[idx], 0), 0], 0.0)
        em0m1[idx] = e0 - e1
        # for monomorphic derived, fold dist 2 to CSFS[0][0]
        u2i = u2[idx]
        mono = u2i == dq.csfs_samples - 2
        dist2_u = np.where(mono, 0, np.maximum(u2i, 0))
        dist2_d = np.where(mono, 0, 2)
        e2 = table[dist2_u, dist2_d]
        em2m0[idx] = np.where((u2i >= 0)[:, None], e2 - e0, -e0)

    em0m1[idx], em2m0[idx] = raise_negative_sums(em1[idx], em0m1[idx],
                                                 em2m0[idx])

    # fail fast on out-of-support CSFS lookups (e.g. unfolded data sent
    # into the folded table): those rows are all-zero, and an all-zero
    # emission for an observable class NaN-poisons every decode window
    # containing the site (0/0 in the per-site normalization propagates
    # through the whole recursion), silently deleting segments. The
    # reference never validates this (HMM.cpp:159-256) because its loader
    # guarantees folding; we construct Data objects programmatically too,
    # so a loud error beats NaN output.
    if len(idx):
        for obs, p_obs, u in ((0, em1[idx] + em0m1[idx], u0[idx]),
                              (1, em1[idx], u1[idx]),
                              (2, em1[idx] + em0m1[idx] + em2m0[idx],
                               u2[idx])):
            bad = (u >= 0) & (p_obs.sum(axis=1) <= 0.0)
            if bad.any():
                s = idx[np.flatnonzero(bad)[0]]
                raise ValueError(
                    f"all-zero emission for observation {obs} at site {s} "
                    f"(undistinguished counts {und[s]}): CSFS lookup out "
                    "of support — is the panel folded to minor alleles "
                    "consistently with params.fold_data?")
    return EmissionTables(em1=em1, em0minus1=em0m1, em2minus0=em2m0,
                          use_csfs_at=use, undistinguished=und)
