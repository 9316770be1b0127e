"""CSFS loading, folding, array ascertainment, compression.

The port's copy of ``fastsmc_tpu/prepare/csfs.py`` (host numpy/scipy); the
panel's allele frequencies are read through the port's own ``io/haps.py``.

Reimplementation of reference TOOLS/PREPARE_DECODING:
  * ``CSFS.java`` (load/verify/fold/fixAscertainment/compress)
  * ``ArraySpectrum.java`` (hypergeometric subsampled array spectrum)
  * ``Data.java`` (allele frequencies from haps or .frq file)

All math float64; the CSFS text format is the smcpp-derived file shipped as
``FILES/DECODING_QUANTITIES/30-100-2000.csfs``.
"""

from __future__ import annotations

import dataclasses
import gzip
from typing import Dict, List, Optional, Tuple

import numpy as np
from scipy.stats import hypergeom


def _open_maybe_gz(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path, "rt")


@dataclasses.dataclass
class CSFSEntry:
    time_vector: np.ndarray
    size_vector: np.ndarray
    mu: float
    from_t: float
    to_t: float
    samples: int
    csfs: np.ndarray  # [3, samples-1] (unfolded) or [2, samples/2+1] (folded)


@dataclasses.dataclass
class CSFS:
    entries: Dict[float, CSFSEntry]          # keyed by interval start, sorted
    samples: int = 0
    folded: Optional[Dict[float, CSFSEntry]] = None
    ascertained: Optional[Dict[float, CSFSEntry]] = None
    folded_ascertained: Optional[Dict[float, CSFSEntry]] = None
    compressed_ascertained_emission: Optional[np.ndarray] = None  # [2, n_intervals]
    array_spectrum: Optional["ArraySpectrum"] = None
    array_sampling_factors: Optional[np.ndarray] = None

    def keys(self) -> List[float]:
        return sorted(self.entries.keys())

    @classmethod
    def load(cls, path: str) -> "CSFS":
        entries: Dict[float, CSFSEntry] = {}
        with _open_maybe_gz(path) as f:
            lines = iter(f)
            for line in lines:
                fields = line.split()
                if not fields:
                    continue
                if fields[0].lower() != "time:":
                    raise ValueError(f"Badly formatted CSFS file at: {line!r}")
                time_vec = np.array([float(x) for x in fields[1:]])
                fields = next(lines).split()
                assert fields[0].lower() == "size:"
                size_vec = np.array([float(x) for x in fields[1:]])
                fields = next(lines).split()
                assert fields[0].lower() == "mu:"
                mu = float(fields[1])
                fields = next(lines).split()
                assert fields[0].lower() == "samples:"
                samples = int(fields[1])
                fields = next(lines).split()
                assert fields[0].lower() == "interval:"
                from_t, to_t = float(fields[1]), float(fields[2])
                csfs = np.empty((3, samples - 1))
                for d in range(3):
                    row = next(lines).split()
                    csfs[d, :len(row)] = [float(x) for x in row]
                entries[from_t] = CSFSEntry(time_vec, size_vec, mu, from_t,
                                            to_t, samples, csfs)
        out = cls(entries=entries)
        out.samples = next(iter(entries.values())).samples if entries else 0
        return out

    # -- verification (CSFS.java:113-156) -----------------------------------
    def verify(self, time_vector, size_vector, mu, samples, discretization) -> bool:
        tv = np.asarray(time_vector)[:-1]
        sv = np.asarray(size_vector)[:-1]
        disc = np.asarray(discretization)[:-1]
        for from_t in disc:
            if from_t not in self.entries:
                return False
            e = self.entries[from_t]
            if e.mu != mu:
                return False
            if len(e.time_vector) != len(tv) or not np.array_equal(e.time_vector, tv):
                return False
            if not np.array_equal(e.size_vector, sv):
                return False
            if e.samples != samples:
                return False
        return True

    # -- folding (CSFS.java:297-339) ----------------------------------------
    @staticmethod
    def _fold_entry(csfs: np.ndarray, samples: int) -> np.ndarray:
        if samples % 2 != 0:
            raise ValueError("ConditionalSFS called with odd number of samples.")
        half = samples // 2
        undistinguished = samples - 2
        folded = np.zeros((2, half + 1))
        for row in range(3):
            for col in range(undistinguished + 1):
                dist, undist = row, col
                if undist + dist > half:
                    undist = samples - 2 - undist
                if dist == 2:
                    dist = 0
                folded[dist, undist] += csfs[row, col]
        return folded

    def fold(self, source: Dict[float, CSFSEntry]) -> Dict[float, CSFSEntry]:
        out = {}
        for k, e in source.items():
            out[k] = CSFSEntry(e.time_vector, e.size_vector, e.mu, e.from_t,
                               e.to_t, e.samples,
                               self._fold_entry(e.csfs, e.samples))
        return out

    # -- ascertainment (CSFS.java:179-295) ----------------------------------
    def fix_ascertainment(self, freqs: "AlleleFrequencies", samples: int,
                          transition) -> None:
        self.samples = samples
        self._compute_array_sampling_factors(freqs, samples, transition)
        self.ascertained = {k: CSFSEntry(e.time_vector, e.size_vector, e.mu,
                                         e.from_t, e.to_t, e.samples,
                                         e.csfs.copy())
                            for k, e in self.entries.items()}
        self._apply_factors()
        self.folded_ascertained = self.fold(self.ascertained)
        self.compressed_ascertained_emission = self.compress(self.folded_ascertained)
        self.folded = self.fold(self.entries)

    def _compute_array_sampling_factors(self, freqs, samples, transition):
        coal_dist = transition.get_coal_dist()
        afs = np.zeros(samples)
        for counter, k in enumerate(self.keys()):
            p = coal_dist[counter]
            csfs = self.entries[k].csfs
            for row in range(3):
                for col in range(samples - 1):
                    pos = row + col
                    if pos > samples // 2:
                        pos = samples - pos
                    afs[pos] += p * csfs[row, col]
        afs[0] = 0.0
        afs /= afs.sum()
        half = samples // 2
        for i in range(half + 1, samples):
            afs[samples - i] += afs[i]
            afs[i] = 0.0
        afs /= afs.sum()
        folded_afs = afs[:half + 1].copy()

        self.array_spectrum = ArraySpectrum.from_frequencies(freqs, samples)
        folded_afs_array = self.array_spectrum.spectrum
        factors = np.zeros(half + 1)
        with np.errstate(divide="ignore", invalid="ignore"):
            factors[1:len(folded_afs_array)] = (
                folded_afs_array[1:] / folded_afs[1:len(folded_afs_array)])
        self.array_sampling_factors = factors

    def _apply_factors(self):
        samples = self.samples
        factors = self.array_sampling_factors
        mono = self.array_spectrum.monomorphic
        half = samples // 2
        for k, e in self.ascertained.items():
            c = e.csfs
            c[0, 0] = 0.0
            rows, cols = np.meshgrid(np.arange(3), np.arange(samples - 1),
                                     indexing="ij")
            pos = rows + cols
            pos = np.where(pos > half, samples - pos, pos)
            c *= factors[pos]
            norm = c.sum() / (1 - mono)
            c /= norm
            c[0, 0] = mono

    # -- compression (CSFS.java:341-353) ------------------------------------
    def compress(self, source: Dict[float, CSFSEntry]) -> np.ndarray:
        ks = sorted(source.keys())
        out = np.zeros((2, len(ks)))
        for i, k in enumerate(ks):
            out[0, i] = source[k].csfs[0].sum()
            out[1, i] = source[k].csfs[1].sum()
        return out


def compute_classic_emission(expected_times: np.ndarray, mu: float) -> np.ndarray:
    """CSFS.java:190-197: [2, K] homozygous/heterozygous emission."""
    e0 = np.exp(-2.0 * expected_times * mu)
    return np.stack([e0, 1 - e0])


# ---------------------------------------------------------------------------
@dataclasses.dataclass
class AlleleFrequencies:
    """Per-SNP minor allele data (reference TOOLS Data.java)."""
    freqs: np.ndarray          # float64 [n]
    minor_alleles: np.ndarray  # int [n]
    allele_counts: np.ndarray  # int [n]
    haploid_sample_size: int

    @classmethod
    def from_haps(cls, haps_root: str) -> "AlleleFrequencies":
        """Compute folded minor-allele counts from a haps file
        (TOOLS Data.java:80-125)."""
        from ..io.haps import find_haps_file, _open_maybe_gz as _omg
        freqs, minors, counts = [], [], []
        hss = 0
        with _omg(find_haps_file(haps_root)) as f:
            for line in f:
                fields = line.split()
                alleles = fields[5:]
                samples = len(alleles)
                hss = max(hss, samples)
                if samples % 2 != 0:
                    raise ValueError("odd haploid sample size")
                dac = sum(1 for a in alleles if a == "1")
                if dac > samples // 2:
                    dac = samples - dac
                da_freq = dac / samples
                freqs.append(min(da_freq, 1 - da_freq))
                minors.append(dac)
                counts.append(samples)
        return cls(np.asarray(freqs), np.asarray(minors, dtype=np.int64),
                   np.asarray(counts, dtype=np.int64), hss)

    @classmethod
    def from_frq_file(cls, path: str) -> "AlleleFrequencies":
        """Plink .frq reader (TOOLS Data.java:57-77)."""
        freqs, minors, counts = [], [], []
        hss = 0
        with _open_maybe_gz(path) as f:
            next(f)  # header
            for line in f:
                fields = line.split()
                freq = float(fields[5])
                pop = int(float(fields[6]))
                hss = max(hss, pop)
                freqs.append(freq)
                minors.append(int(pop * freq))
                counts.append(pop)
        return cls(np.asarray(freqs), np.asarray(minors, dtype=np.int64),
                   np.asarray(counts, dtype=np.int64), hss)


@dataclasses.dataclass
class ArraySpectrum:
    """Folded array AFS from hypergeometric subsampling
    (reference ArraySpectrum.java:37-94)."""
    spectrum: np.ndarray
    monomorphic: float

    @classmethod
    def from_frequencies(cls, data: AlleleFrequencies, samples: int
                         ) -> "ArraySpectrum":
        # group SNPs by frequency; one hypergeometric per distinct frequency
        mono = 0
        dist_counts: Dict[float, int] = {}
        dist_params: Dict[float, Tuple[int, int]] = {}
        for pop, minor, freq in zip(data.allele_counts, data.minor_alleles,
                                    data.freqs):
            if minor == 0:
                mono += 1
                continue
            f = float(freq)
            if f not in dist_counts:
                dist_counts[f] = 1
                dist_params[f] = (int(pop), int(minor))
            else:
                dist_counts[f] += 1
        spectrum = np.zeros(samples + 1)
        i = np.arange(samples + 1)
        for f, c in dist_counts.items():
            pop, minor = dist_params[f]
            spectrum += hypergeom(pop, minor, samples).pmf(i) * c
        spectrum[0] += mono
        spectrum /= spectrum.sum()
        monomorphic = spectrum[0] + spectrum[samples]
        spectrum[0] = 0.0
        spectrum[samples] = 0.0
        spectrum /= spectrum.sum()
        half = samples // 2
        folded = np.zeros(half + 1)
        folded[:half] = spectrum[:half] + spectrum[samples:samples - half:-1]
        folded[half] = spectrum[half]
        return cls(folded, float(monomorphic))
