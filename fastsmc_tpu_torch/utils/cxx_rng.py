"""Bit-compatible reimplementations of the C++/glibc RNG stack.

The reference engine draws undistinguished-allele counts with
``std::shuffle(vec.begin(), vec.end(), std::mt19937(std::rand()))`` after
``std::srand(1234)`` when ``useKnownSeed`` is set (reference Data.cpp:55-60 and
Data.cpp:144-160).  Reproducing the reference's golden outputs therefore
requires reproducing, bit for bit:

  * glibc's ``rand()`` (TYPE_3 additive-feedback generator),
  * ``std::mt19937`` (standardised; seeding + tempering),
  * libstdc++'s ``std::uniform_int_distribution`` rejection algorithm,
  * libstdc++'s ``std::shuffle`` including the two-swaps-per-draw
    optimisation (``__gen_two_uniform_ints``).

These are public, stable algorithms; the implementations below are written
from their specifications.
"""

from __future__ import annotations

import numpy as np

_U32 = 0xFFFFFFFF
_U31 = 0x7FFFFFFF


class GlibcRand:
    """glibc ``rand()``: additive feedback generator (TYPE_3, degree 31, sep 3)."""

    def __init__(self, seed: int = 1):
        seed = seed & _U32
        if seed == 0:
            seed = 1
        r = [0] * 344
        r[0] = seed if seed < 2**31 else seed - 2**32
        for i in range(1, 31):
            # r[i] = (16807 * r[i-1]) % 2147483647 via Schrage to avoid overflow,
            # matching glibc's signed arithmetic
            hi, lo = divmod(r[i - 1], 127773)
            word = 16807 * lo - 2836 * hi
            if word < 0:
                word += _U31
            r[i] = word
        for i in range(31, 34):
            r[i] = r[i - 31]
        for i in range(34, 344):
            r[i] = (r[i - 31] + r[i - 3]) & _U32
        self._r = r
        self._i = 344

    def rand(self) -> int:
        r = self._r
        i = self._i
        val = (r[i - 31] + r[i - 3]) & _U32
        r.append(val)
        self._i = i + 1
        # keep the list from growing without bound
        if self._i > 100000:
            self._r = r[-34:]
            self._i = 34
        return val >> 1


class MT19937:
    """std::mt19937 with block (numpy-vectorised) generation."""

    N, M = 624, 397
    MATRIX_A = 0x9908B0DF
    UPPER = 0x80000000
    LOWER = 0x7FFFFFFF

    def __init__(self, seed: int = 5489):
        mt = np.empty(self.N, dtype=np.uint64)
        mt[0] = seed & _U32
        for i in range(1, self.N):
            mt[i] = (1812433253 * (mt[i - 1] ^ (mt[i - 1] >> np.uint64(30))) + i) & _U32
        self._mt = mt.astype(np.uint32)
        self._buf = None
        self._pos = self.N  # trigger regeneration

    def _generate(self):
        mt = self._mt.astype(np.uint32)
        N, M = self.N, self.M
        y = (mt & np.uint32(self.UPPER)) | (np.roll(mt, -1) & np.uint32(self.LOWER))
        mag = np.where(y & np.uint32(1), np.uint32(self.MATRIX_A), np.uint32(0))
        # twist must be applied sequentially in two halves because entries
        # 0..N-M-1 read already-twisted values at i+M only when i+M >= N.
        # Standard trick: first N-M entries use original mt[i+M]; the rest use
        # new values which are exactly mt_new[i+M-N] computed in the first part.
        new = np.empty(N, dtype=np.uint32)
        new[: N - M] = mt[M:] ^ (y[: N - M] >> np.uint32(1)) ^ mag[: N - M]
        # second chunk: i in [N-M, N-1], i+M-N in [0, M-1]
        # for i in [N-M, N-2], y uses mt[i], mt[i+1]; for i = N-1, uses mt[N-1], new[0]
        y2 = (mt[N - M:N - 1] & np.uint32(self.UPPER)) | (mt[N - M + 1:] & np.uint32(self.LOWER))
        mag2 = np.where(y2 & np.uint32(1), np.uint32(self.MATRIX_A), np.uint32(0))
        new[N - M:N - 1] = new[: M - 1] ^ (y2 >> np.uint32(1)) ^ mag2
        ylast = (mt[N - 1] & np.uint32(self.UPPER)) | (new[0] & np.uint32(self.LOWER))
        maglast = np.uint32(self.MATRIX_A) if ylast & np.uint32(1) else np.uint32(0)
        new[N - 1] = new[M - 1] ^ (ylast >> np.uint32(1)) ^ maglast
        self._mt = new
        # temper
        t = new.copy()
        t ^= t >> np.uint32(11)
        t ^= (t << np.uint32(7)) & np.uint32(0x9D2C5680)
        t ^= (t << np.uint32(15)) & np.uint32(0xEFC60000)
        t ^= t >> np.uint32(18)
        self._buf = t
        self._pos = 0

    def __call__(self) -> int:
        if self._pos >= self.N:
            self._generate()
        v = int(self._buf[self._pos])
        self._pos += 1
        return v


def uniform_int(g, a: int, b: int) -> int:
    """libstdc++ ``std::uniform_int_distribution<T>{a, b}(g)`` for a 32-bit
    full-range generator (mt19937).

    libstdc++ >= 9 downscales with Lemire's algorithm (`_S_nd`, "Fast Random
    Integer Generation in an Interval", bits/uniform_int_dist.h in GCC 12)
    because mt19937's range is exactly UINT32_MAX.
    """
    urange = b - a
    urngrange = _U32  # g.max() - g.min() for mt19937
    if urngrange > urange:
        uerange = (urange + 1) & _U32  # as uint32
        # Lemire: product = u64(g()) * u64(range); keep high 32 bits,
        # rejecting low < (-range mod range)
        product = g() * uerange
        low = product & _U32
        if low < uerange:
            threshold = (2**32 - uerange) % uerange
            while low < threshold:
                product = g() * uerange
                low = product & _U32
        return a + (product >> 32)
    elif urngrange == urange:
        return a + g()
    else:  # pragma: no cover - not reachable with mt19937 + small ranges
        raise NotImplementedError("upscaling branch not needed")


def _gen_two_uniform_ints(b0: int, b1: int, g) -> tuple[int, int]:
    x = uniform_int(g, 0, b0 * b1 - 1)
    return x // b1, x % b1


def cxx_shuffle(arr: np.ndarray, g) -> None:
    """In-place libstdc++ ``std::shuffle`` (bits/stl_algo.h), including the
    paired-swap optimisation taken when urngrange / urange >= urange."""
    n = len(arr)
    if n == 0:
        return
    urngrange = _U32
    urange = n
    if urngrange // urange >= urange:
        i = 1
        if n % 2 == 0:
            j = uniform_int(g, 0, 1)
            arr[i], arr[j] = arr[j], arr[i]
            i += 1
        while i < n:
            swap_range = i + 1
            p0, p1 = _gen_two_uniform_ints(swap_range, swap_range + 1, g)
            arr[i], arr[p0] = arr[p0], arr[i]
            i += 1
            arr[i], arr[p1] = arr[p1], arr[i]
            i += 1
        return
    for i in range(1, n):  # pragma: no cover - generic fallback
        j = uniform_int(g, 0, i)
        arr[i], arr[j] = arr[j], arr[i]


def sample_hypergeometric(rand: GlibcRand, population_size: int,
                          number_of_successes: int, sample_size: int) -> int:
    """Bit-exact mirror of reference Data.cpp:144-160 (``sampleHypergeometric``).

    Draws nothing from ``rand`` when the parameters are out of range (the
    reference returns -1 before constructing the mt19937).
    """
    if number_of_successes < 0 or number_of_successes > population_size:
        return -1
    vec = np.zeros(population_size, dtype=np.int64)
    vec[:number_of_successes] = 1
    g = MT19937(rand.rand())
    cxx_shuffle(vec, g)
    return int(vec[:sample_size].sum())
