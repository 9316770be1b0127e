"""Haplotype panel loading: haps/samples/map readers.

The port's copy of ``fastsmc_tpu/io/haps.py``, a redesign of the reference
data layer (ASMC_SRC/SRC/Data.{hpp,cpp}). Instead of per-individual
``vector<bool>`` genotypes (Individual.hpp:23-38), haplotypes live in a
dense uint8 matrix ``[n_haps, n_sites]``, ready to feed device kernels.

Semantics preserved from the reference:
  * minor-allele folding: flip a site when derived count > 50%
    (Data.cpp:365-366, 472-473)
  * genetic map handling: ASMC 4-column map (Data.cpp:162-210) and the
    FastSMC 3-column map with linear interpolation of cM at hap positions
    (Data.cpp:98-141, 523-547)
  * triangular job-window sample subsetting (Data.cpp:62-80, 251-262)
  * undistinguished-allele counts via bit-compatible hypergeometric sampling
    (Data.cpp:144-160, 567-599)
"""

from __future__ import annotations

import dataclasses
import gzip
import math
import os
from typing import List, Optional, Tuple

import numpy as np

from ..config import DecodingParams
from ..utils.cxx_rng import GlibcRand, sample_hypergeometric


def _open_maybe_gz(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path, "rt")


def _find_existing(root: str, exts) -> str:
    for ext in exts:
        p = root + ext
        if os.path.exists(p):
            return p
    raise FileNotFoundError(f"Could not find any of {root}{{{','.join(exts)}}}")


def find_haps_file(root: str) -> str:
    return _find_existing(root, [".hap.gz", ".hap", ".haps.gz", ".haps"])


def find_samples_file(root: str) -> str:
    return _find_existing(root, [".samples", ".sample"])


def find_map_file(root: str) -> str:
    return _find_existing(root, [".map.gz", ".map"])


def _is_samples_header(fields: List[str]) -> bool:
    # reference Data.cpp:233-236
    return (fields[:3] == ["ID_1", "ID_2", "missing"]
            or fields[:3] == ["0", "0", "0"])


@dataclasses.dataclass
class JobWindows:
    """Triangular tiling of the sample axis across jobs (Data.cpp:62-80)."""
    jobs: int
    job_ind: int
    window_size: int
    w_i: int
    w_j: int
    is_j_above_diag: bool

    @classmethod
    def compute(cls, sample_size: int, jobs: int, job_ind: int) -> "JobWindows":
        n = float(sample_size)
        window_size = int(math.ceil(math.sqrt((2.0 * n * n - n) * 2.0 / jobs)))
        if window_size % 2 != 0:
            window_size += 1
        w_i = 1
        cpt_job = 1
        cpt_tot_job = 1
        while cpt_tot_job < job_ind:
            w_i += 1
            cpt_job += 2
            cpt_tot_job += cpt_job
        w_j = int(math.ceil((cpt_job - (cpt_tot_job - job_ind)) / 2.0))
        is_j_above_diag = (cpt_job - (cpt_tot_job - job_ind)) % 2 == 1
        return cls(jobs, job_ind, window_size, w_i, w_j, is_j_above_diag)

    def sample_in_job(self, d: int) -> bool:
        """Whether diploid sample index ``d`` participates in this job
        (Data.cpp:251-262, FastSMC.cpp:62-66)."""
        ws, w_i, w_j = self.window_size, self.w_i, self.w_j
        return ((d >= (w_i - 1) * ws // 2 and d < w_i * ws // 2)
                or (d >= (w_j - 1) * ws // 2 and d < w_j * ws // 2)
                or (self.jobs == self.job_ind and d >= (w_j - 1) * ws // 2))


@dataclasses.dataclass
class Data:
    """Loaded haplotype panel for one job."""
    sites: int
    sample_size: int                       # total diploid samples in the file
    fam_id_list: List[str]                 # per job-subset sample
    iid_list: List[str]
    hap_bits: np.ndarray                   # uint8 [n_haps_in_job, sites] (after folding)
    genetic_positions: np.ndarray          # float64 Morgans [sites]
    physical_positions: np.ndarray         # int64 [sites]
    rec_rate_at_marker: np.ndarray         # float64 [sites]
    snp_ids: List[str]
    derived_allele_counts: np.ndarray      # int32 [sites] (folded if fold)
    total_samples_count: np.ndarray        # int32 [sites]
    site_was_flipped: np.ndarray           # bool [sites]
    chr_number: int
    windows: Optional[JobWindows]
    fold_to_minor: bool
    decoding_uses_csfs: bool
    use_known_seed: bool
    _undistinguished_cache: Optional[np.ndarray] = None

    @property
    def n_ind(self) -> int:
        return len(self.fam_id_list)

    @property
    def n_haps(self) -> int:
        return self.hap_bits.shape[0]

    # ------------------------------------------------------------------
    def calculate_undistinguished_counts(self, num_csfs_samples: int) -> np.ndarray:
        """Per-site [sites, 3] undistinguished counts, bit-compatible with
        reference Data.cpp:567-599 (RNG stream included, for useKnownSeed).

        The result is cached: the reference computes this once in the HMM ctor.
        """
        if self._undistinguished_cache is not None:
            return self._undistinguished_cache
        seed = 1234 if self.use_known_seed else \
            int.from_bytes(os.urandom(4), "little") or 1
        if self.fold_to_minor and (self.derived_allele_counts
                                   > self.total_samples_count
                                   - self.derived_allele_counts).any():
            raise ValueError("Minor allele has frequency > 50%. "
                             "Data is supposed to be folded.")
        if self.decoding_uses_csfs and num_csfs_samples > \
                int(self.total_samples_count.min(initial=num_csfs_samples)):
            raise ValueError("a SNP has fewer non-missing individuals than "
                             f"the CSFS requires ({num_csfs_samples})")
        from .. import native
        nat = native.undistinguished_counts(
            self.derived_allele_counts, self.total_samples_count,
            num_csfs_samples, self.fold_to_minor, seed)
        if nat is not None:
            self._undistinguished_cache = nat
            return nat
        rand = GlibcRand(seed)
        sites = self.sites
        out = np.empty((sites, 3), dtype=np.int32)
        dac = self.derived_allele_counts
        tot = self.total_samples_count
        for i in range(sites):
            derived = int(dac[i])
            total = int(tot[i])
            if self.decoding_uses_csfs and num_csfs_samples > total:
                raise ValueError(
                    f"SNP {i} has {total} non-missing individuals, but the "
                    f"CSFS requires {num_csfs_samples}")
            ancestral = total - derived
            if self.fold_to_minor and derived > ancestral:
                raise ValueError("Minor allele has frequency > 50%. "
                                 "Data is supposed to be folded.")
            for distinguished in range(3):
                s = sample_hypergeometric(rand, total - 2,
                                          derived - distinguished,
                                          num_csfs_samples - 2)
                if self.fold_to_minor and (s + distinguished > num_csfs_samples // 2):
                    s = num_csfs_samples - 2 - s
                out[i, distinguished] = s
        self._undistinguished_cache = out
        return out


# ---------------------------------------------------------------------------
# readers
# ---------------------------------------------------------------------------

def count_hap_lines(root: str) -> int:
    with _open_maybe_gz(find_haps_file(root)) as f:
        return sum(1 for _ in f)


def count_samples_lines(root: str) -> int:
    n = 0
    with _open_maybe_gz(find_samples_file(root)) as f:
        for line in f:
            fields = line.split()
            if not fields or _is_samples_header(fields):
                continue
            n += 1
    return n


def read_samples_list(root: str, windows: Optional[JobWindows]
                      ) -> Tuple[List[str], List[str]]:
    fam, iid = [], []
    idx = 0
    with _open_maybe_gz(find_samples_file(root)) as f:
        for line in f:
            fields = line.split()
            if not fields or _is_samples_header(fields):
                continue
            if windows is None or windows.sample_in_job(idx):
                fam.append(fields[0])
                iid.append(fields[1])
            idx += 1
    return fam, iid


def read_fastsmc_map(root: str) -> Tuple[np.ndarray, np.ndarray]:
    """3-column FastSMC genetic map: physical position, rate, cM
    (reference Data.cpp:98-141). Returns (bp[int64], cm[float64])."""
    bps, cms = [], []
    with _open_maybe_gz(find_map_file(root)) as f:
        for line in f:
            fields = line.split()
            if not fields or not fields[0]:
                continue
            try:
                int(fields[0])
            except ValueError:
                continue  # header row
            bps.append(int(fields[0]))
            cms.append(float(fields[2]))
    return np.asarray(bps, dtype=np.int64), np.asarray(cms, dtype=np.float64)


def _interp_genetic_positions(hap_bp: np.ndarray, map_bp: np.ndarray,
                              map_cm: np.ndarray) -> np.ndarray:
    """cM at hap positions via the reference's interpolation walk
    (Data.cpp:523-547): exact-match/past-end -> map value; before first map
    entry -> first value; otherwise linear interpolation. Returns Morgans."""
    out = np.empty(len(hap_bp), dtype=np.float64)
    cur = 0
    nmap = len(map_bp)
    for i, bp in enumerate(hap_bp):
        while bp > map_bp[cur] and cur < nmap - 1:
            cur += 1
        if bp >= map_bp[cur]:
            cm = map_cm[cur]
        elif cur == 0:
            cm = map_cm[cur]
        else:
            cm = map_cm[cur - 1] + (bp - map_bp[cur - 1]) * (
                map_cm[cur] - map_cm[cur - 1]) / (map_bp[cur] - map_bp[cur - 1])
        out[i] = cm / 100.0
    return out


def _rec_rates(genetic_positions: np.ndarray, physical_positions: np.ndarray
               ) -> np.ndarray:
    """Per-marker recombination rate (Data.cpp:191-201, 555-565): rate to the
    previous marker; marker 0 copies marker 1's rate."""
    n = len(genetic_positions)
    rates = np.zeros(n, dtype=np.float64)
    if n > 1:
        dg = np.diff(genetic_positions)
        dp = np.diff(physical_positions).astype(np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            rates[1:] = dg / dp
        rates[0] = rates[1]
    return rates


def _parse_chr_number(chr_field: str) -> int:
    # reference Data.cpp:449-462
    token = chr_field.split(":")[0]
    try:
        n = int(token)
    except ValueError:
        return 0
    if n <= 0 or n > 1260:
        return 0
    return n


def load_data(params: DecodingParams) -> Data:
    """Load a panel for one job (mirror of reference Data::Data, Data.cpp:36-95).

    Jobbing is active when jobs/jobInd are set (reference treats (-1,-1) as
    no jobbing; our config always has them >= 1 and we treat jobs == 1 &&
    jobInd == 1 with no windows as the trivial full window).
    """
    root = params.in_file_root
    sites = count_hap_lines(root)
    sample_size = count_samples_lines(root)

    jobbing = params.jobs >= 1 and params.job_ind >= 1
    windows = JobWindows.compute(sample_size, params.jobs, params.job_ind) \
        if jobbing else None

    fam, iid = read_samples_list(root, windows)
    n_ind = len(fam)
    in_job = np.array([windows.sample_in_job(d) for d in range(sample_size)]) \
        if windows is not None else np.ones(sample_size, dtype=bool)
    assert int(in_job.sum()) == n_ind

    hap_bits = np.zeros((2 * n_ind, sites), dtype=np.uint8)
    derived_counts = np.zeros(sites, dtype=np.int32)
    total_counts = np.zeros(sites, dtype=np.int32)
    flipped = np.zeros(sites, dtype=bool)
    phys = np.zeros(sites, dtype=np.int64)
    snp_ids: List[str] = []
    chr_number = 0

    # column indices (within all haps) of the haplotypes owned by this job
    job_hap_cols = np.flatnonzero(np.repeat(in_job, 2))

    with _open_maybe_gz(find_haps_file(root)) as f:
        pos = 0
        last_bp = -1
        for line in f:
            fields = line.split(maxsplit=5)
            if len(fields) < 6:
                raise ValueError(f"Malformed haps line {pos}")
            chrom, snp_id, bp_s, _a0, _a1, payload = fields
            bp = int(bp_s)
            if params.fastsmc:
                if bp <= last_bp:
                    raise ValueError(
                        "rows in haps data file must be ordered by increasing "
                        f"physical position ({last_bp} then {bp})")
            last_bp = bp
            if pos == 0:
                chr_number = _parse_chr_number(chrom)
            # payload: space-separated 0/1 per hap
            alleles = np.frombuffer(
                payload.replace(" ", "").rstrip("\n").encode(), dtype=np.uint8
            ) - ord("0")
            if len(alleles) != 2 * sample_size:
                raise ValueError(
                    f"haps line {pos} has {len(alleles)} alleles, expected "
                    f"{2 * sample_size}")
            if alleles.max(initial=0) > 1:
                raise ValueError("hap is not '0' or '1'")
            da_count = int(alleles.sum())
            total = 2 * sample_size
            minor_is_one = (not params.fold_data) or (da_count <= total - da_count)
            flipped[pos] = not minor_is_one
            row = alleles[job_hap_cols]
            hap_bits[:, pos] = row if minor_is_one else 1 - row
            derived_counts[pos] = min(da_count, total - da_count) \
                if params.fold_data else da_count
            total_counts[pos] = total
            phys[pos] = bp
            snp_ids.append(snp_id)
            pos += 1
    if pos != sites:
        raise ValueError(f"read {pos} hap lines, expected {sites}")

    # genetic map
    if params.fastsmc:
        map_bp, map_cm = read_fastsmc_map(root)
        gen = _interp_genetic_positions(phys, map_bp, map_cm)
    else:
        gen = np.empty(sites, dtype=np.float64)
        ids: List[str] = []
        p2 = np.empty(sites, dtype=np.int64)
        i = 0
        with _open_maybe_gz(find_map_file(root)) as f:
            for line in f:
                fields = line.split()
                if not fields:
                    continue
                ids.append(fields[1])
                gen[i] = float(fields[2]) / 100.0
                p2[i] = int(fields[3])
                i += 1
        if i != sites:
            raise ValueError(f"read {i} map lines, expected {sites}")
        snp_ids = ids
        phys = p2

    rates = _rec_rates(gen, phys)

    return Data(
        sites=sites, sample_size=sample_size,
        fam_id_list=fam, iid_list=iid,
        hap_bits=hap_bits,
        genetic_positions=gen, physical_positions=phys,
        rec_rate_at_marker=rates, snp_ids=snp_ids,
        derived_allele_counts=derived_counts,
        total_samples_count=total_counts,
        site_was_flipped=flipped, chr_number=chr_number,
        windows=windows,
        fold_to_minor=params.fold_data,
        decoding_uses_csfs=params.using_csfs,
        use_known_seed=params.use_known_seed,
    )

