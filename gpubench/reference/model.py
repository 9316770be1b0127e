"""The pair HMM's tables, worked out again from the decoding quantities and
the panel, in plain NumPy and PyTorch.

This is the benchmark's own statement of the model that ASMC and FastSMC
decode (ASMC's HMM.cpp: the emissions of ``prepareEmissions``, the
transition factorisation D/B/U/RR/CR, the undistinguished-allele counts of
Data.cpp). It reads the decoding-quantities file itself and takes the
panel's bits from the benchmark, never a table the program built. The
pieces that must equal the program's bit for bit (the genetic-distance
rounding and the seeded hypergeometric draws that pick each site's CSFS
row) are written from the same published algorithms; the test
``test_gpubench_reference.py`` holds them to the program's on the CPU.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

U32 = 0xFFFFFFFF


def round_morgans(value, precision: int = 2, min_genetic: float = 1e-10):
    """float32 asmc::roundMorgans (HmmUtils.cpp:65-79): two significant
    digits, at least ``min_genetic``."""
    v = np.asarray(value, dtype=np.float32)
    correction = np.float32(10.0 - precision)
    with np.errstate(invalid="ignore", divide="ignore"):
        l10 = np.maximum(np.float32(0.0),
                         np.floor(np.log10(np.maximum(v, np.float32(1e-37))))
                         + correction)
        factor = np.power(np.float32(10.0),
                          np.float32(10.0) - l10).astype(np.float32)
        rounded = (np.round(v * factor) / factor).astype(np.float32)
        out = np.where(v <= np.float32(min_genetic), np.float32(min_genetic),
                       rounded)
        out = np.where(np.isfinite(out), out, np.float32(min_genetic))
    return out


def gen_dist_rows(gen_dists: np.ndarray, dists: np.ndarray) -> np.ndarray:
    """Row of each rounded distance in the quantities' sorted distances;
    a distance that is not there raises (the reference's ``map::at``)."""
    d = np.asarray(dists, np.float32)
    idx = np.clip(np.searchsorted(gen_dists, d), 0, len(gen_dists) - 1)
    left = gen_dists[np.maximum(idx - 1, 0)] == d
    idx = np.where(left & (gen_dists[idx] != d), idx - 1, idx)
    if not np.all(gen_dists[idx] == d):
        raise KeyError(f"distances missing from the quantities: "
                       f"{d[gen_dists[idx] != d][:5]}")
    return idx


# ---------------------------------------------------------------------------
# the undistinguished counts: glibc rand() seeds one std::mt19937 per draw,
# std::shuffle (libstdc++, Lemire's bounded draw, two swaps per draw) deals
# a 0/1 vector of the population, and the count is the ones among the
# first csfs_samples - 2 (Data.cpp:144-160, 567-599)
# ---------------------------------------------------------------------------

class GlibcRand:
    """glibc ``rand()``, TYPE_3 additive feedback (degree 31, separation 3)."""

    def __init__(self, seed: int):
        seed &= U32
        r = [seed or 1]
        for i in range(1, 31):
            hi, lo = divmod(r[i - 1], 127773)
            word = 16807 * lo - 2836 * hi
            r.append(word + 0x7FFFFFFF if word < 0 else word)
        r += r[:3]
        for i in range(34, 344):
            r.append((r[i - 31] + r[i - 3]) & U32)
        self._r = r

    def rand(self) -> int:
        r = self._r
        r.append((r[-31] + r[-3]) & U32)
        if len(r) > 4096:
            del r[:-34]
        return r[-1] >> 1


def _mt_init(seeds: torch.Tensor) -> torch.Tensor:
    """std::mt19937 states [S, 624] (int64 holding uint32) of ``seeds``."""
    mt = torch.empty((len(seeds), 624), dtype=torch.int64,
                     device=seeds.device)
    mt[:, 0] = seeds & U32
    for i in range(1, 624):
        prev = mt[:, i - 1]
        mt[:, i] = (1812433253 * (prev ^ (prev >> 30)) + i) & U32
    return mt


def _mt_twist(mt: torch.Tensor) -> torch.Tensor:
    """The next 624 words of every state in ``mt`` [S, 624]."""
    upper, lower, a = 0x80000000, 0x7FFFFFFF, 0x9908B0DF
    new = torch.empty_like(mt)
    y = (mt[:, :227] & upper) | (mt[:, 1:228] & lower)
    new[:, :227] = mt[:, 397:] ^ (y >> 1) ^ ((y & 1) * a)
    # entry i >= 227 reads the new word i - 227: words 227..453 read the
    # first part, words 454..622 read words 227..395 of this one
    for lo, hi in ((227, 454), (454, 623)):
        y = (mt[:, lo:hi] & upper) | (mt[:, lo + 1:hi + 1] & lower)
        new[:, lo:hi] = new[:, lo - 227:hi - 227] ^ (y >> 1) \
            ^ ((y & 1) * a)
    y = (mt[:, 623] & upper) | (new[:, 0] & lower)
    new[:, 623] = new[:, 396] ^ (y >> 1) ^ ((y & 1) * a)
    return new


def _mt_temper(y: torch.Tensor) -> torch.Tensor:
    y = y ^ (y >> 11)
    y = y ^ ((y << 7) & 0x9D2C5680)
    y = y ^ ((y << 15) & 0xEFC60000)
    return y ^ (y >> 18)


def _shuffled_counts(seeds: torch.Tensor, population: int,
                     successes: torch.Tensor, sample: int) -> torch.Tensor:
    """Ones among the first ``sample`` entries after libstdc++'s
    ``std::shuffle`` of ``successes`` ones and ``population - successes``
    zeros with ``std::mt19937(seed)``, for every seed at once."""
    dev = seeds.device
    S, n = len(seeds), population
    if U32 // n < n:
        raise NotImplementedError("std::shuffle takes one draw a swap for "
                                  f"{n} entries; only two a draw is written")
    # the draws: for even n one over [0, 1], then one over [0,
    # (i+1)(i+2) - 1] for i = 2, 4, ... (odd n: i = 1, 3, ...), each a
    # Lemire draw that rejects a low word under (2^32 - range) % range
    first = [2] if n % 2 == 0 else []
    i0 = 2 if n % 2 == 0 else 1
    ranges = first + [(i + 1) * (i + 2) for i in range(i0, n - 1, 2)]
    words, state = [], _mt_init(seeds)
    have, need = 0, len(ranges) + 64
    while have < need:
        state = _mt_twist(state)
        words.append(_mt_temper(state))
        have += 624
    words = torch.cat(words, dim=1)
    arr = (torch.arange(n, device=dev)[None, :]
           < successes[:, None]).to(torch.int8)
    rows = torch.arange(S, device=dev)
    ptr = torch.zeros(S, dtype=torch.int64, device=dev)

    def swap(i, p):
        a = arr[:, i].clone()
        arr[:, i] = arr[rows, p]
        arr[rows, p] = a

    for step, r in enumerate(ranges):
        thr = (2 ** 32 - r) % r
        while True:
            if int(ptr.max()) >= words.shape[1]:
                state = _mt_twist(state)
                words = torch.cat([words, _mt_temper(state)], dim=1)
            prod = words[rows, ptr] * r
            bad = (prod & U32) < thr
            if not bool(bad.any()):
                break
            ptr += bad.to(torch.int64)
        ptr += 1
        x = prod >> 32
        if step == 0 and first:
            swap(1, x)
            continue
        i = i0 + 2 * (step - len(first))
        swap(i, x // (i + 2))
        swap(i + 1, x % (i + 2))
    return arr[:, :sample].sum(dim=1, dtype=torch.int64)


def undistinguished_counts(dac: np.ndarray, total: np.ndarray,
                           csfs_samples: int, fold: bool, seed: int,
                           device="cpu", chunk: int = 8192) -> np.ndarray:
    """int32 [sites, 3]: per site and distinguished count d, the draw for
    ``total - 2`` haplotypes of which ``dac - d`` carry the allele, folded
    as the reference folds it; -1 where ``dac - d`` is out of range (no
    draw is made then)."""
    L = len(dac)
    out = np.full((L, 3), -1, np.int64)
    rand = GlibcRand(seed)
    jobs = []                                   # (site, d, seed, n, k)
    for i in range(L):
        for d in range(3):
            k, n = int(dac[i]) - d, int(total[i]) - 2
            if 0 <= k <= n:
                jobs.append((i, d, rand.rand(), n, k))
    jobs = np.asarray(jobs, np.int64).reshape(-1, 5)
    for n in np.unique(jobs[:, 3]):
        sel = jobs[jobs[:, 3] == n]
        for c0 in range(0, len(sel), chunk):
            part = sel[c0:c0 + chunk]
            cnt = _shuffled_counts(
                torch.as_tensor(part[:, 2], device=device), int(n),
                torch.as_tensor(part[:, 4], device=device), csfs_samples - 2)
            out[part[:, 0], part[:, 1]] = cnt.cpu().numpy()
    if fold:
        d = np.arange(3)[None, :]
        out = np.where(out + d > csfs_samples // 2,
                       csfs_samples - 2 - out, out)
    return out.astype(np.int32)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def dense_operators(D, B, U, RR, CR):
    """Forward and backward K x K operators [G, K, K] of the D/B/U/RR/CR
    factorisation (HMM.cpp:787-879, 943-1041), float64:
    next[k] = sum_j Tf[k, j] prev[j] and prev[k] = sum_j Tb[k, j] vec[j]."""
    D, B, U, RR, CR = (np.asarray(x, np.float64) for x in (D, B, U, RR, CR))
    G, K = D.shape
    k = np.arange(K)
    Tf = np.zeros((G, K, K))
    Tb = np.zeros((G, K, K))
    for row in range(K):
        Tf[:, row, row + 1:] = B[:, row:row + 1]
        Tb[:, row, :row] = B[:, :row]
        # AU: U[j] times CR[j+1] ... CR[row-1]
        for j in range(row):
            Tf[:, row, j] = U[:, j] * np.prod(CR[j + 1:row])
        # BU: U[j-1] times RR[row] ... RR[j-2]
        for j in range(row + 1, K):
            Tb[:, row, j] = U[:, j - 1] * np.prod(RR[:, row:j - 1], axis=1)
    Tf[:, k, k] = D
    Tb[:, k, k] = D
    return Tf, Tb


@dataclasses.dataclass
class Model:
    """What a decode needs, as float64 NumPy arrays."""
    K: int
    Tf: np.ndarray            # [G, K, K]
    Tb: np.ndarray            # [G, K, K]
    gap: np.ndarray           # int64 [L-1]: operator of gap (t, t+1)
    emission: np.ndarray      # [L, 3, K]: P(obs class | state) per site;
    #                           classes 0 = differ, 1 = both major,
    #                           2 = both minor
    isp: np.ndarray           # [K] initial state probabilities
    expected_times: np.ndarray  # [K]
    discretization: np.ndarray  # [K + 1]


def build_model(dq_path: str, genetic_positions: np.ndarray,
                dac: np.ndarray, total: np.ndarray, seed: int = 1234,
                device="cpu") -> Model:
    """The array-mode model of a folded panel decoded with the CSFS at
    every site (skipCSFSdistance 0), the undistinguished counts drawn with
    ``seed`` (useKnownSeed: 1234)."""
    q = np.load(dq_path)
    K = int(q["states"])
    g32 = np.asarray(genetic_positions, np.float32)
    rows = gen_dist_rows(q["gen_dists"], round_morgans(g32[1:] - g32[:-1]))
    used, gap = np.unique(rows, return_inverse=True)
    Tf, Tb = dense_operators(q["D"][used], q["B"][used], q["U"][used],
                             q["RR"][used], q["column_ratios"])
    und = undistinguished_counts(dac, total, int(q["csfs_samples"]), True,
                                 seed, device)
    table = np.asarray(q["folded_ascertained_csfs"], np.float32)  # [n-1, 2, K]

    def row(u, dist):
        return np.where((u >= 0)[:, None], table[np.maximum(u, 0), dist],
                        np.float32(0.0))

    # HMM.cpp:179-207 (folded): differ reads [u1][1], both major [u0][0],
    # both minor [u2][0]. The algorithm keeps float32 tables of the first
    # and of the differences (emission1, emission0minus1, emission2minus0)
    # and adds them per observation, so a class's emission is those float32
    # sums: where [u0][0] is far below [u1][1], as at a singleton for old
    # states, the sum keeps only the bits the difference held.
    e1, e0, e2 = row(und[:, 1], 1), row(und[:, 0], 0), row(und[:, 2], 0)
    both_major = e1 + (e0 - e1)
    em = np.stack([e1, both_major, both_major + (e2 - e0)],
                  axis=1).astype(np.float64)
    return Model(K=K, Tf=Tf, Tb=Tb, gap=gap.astype(np.int64), emission=em,
                 isp=q["initial_state_prob"].astype(np.float64),
                 expected_times=q["expected_times"].astype(np.float64),
                 discretization=q["discretization"].astype(np.float64))
