"""End-to-end decoding-quantities generation (PREPARE_DECODING equivalent).

The port's copy of ``fastsmc_tpu/prepare/make_dq.py``. Reimplements the
reference pipeline ``TOOLS/PREPARE_DECODING/src/ASMCprepareDecoding/
{ASMCprepareDecoding,DecodingQuantities}.java`` on top of
:mod:`.transition` and :mod:`.csfs`:

  demography + discretization + precomputed CSFS + array allele frequencies
      -> transition quantities D/B/U/RR per quantised genetic distance
         (grid startGen=1e-10 .. 0.3 Morgans, DecodingQuantities.java:62-98)
      -> homozygous emissions per quantised physical distance (1bp .. 100Mb)
      -> initial state probs, classic/compressed emissions, (folded/
         ascertained) CSFS tables

A precomputed (smcpp) ``.csfs`` file may be given; without one the
conditioned SFS is computed from the demography (:mod:`.conditioned_sfs`).
"""

from __future__ import annotations

import gzip
import math
import os
import tempfile
from typing import Optional

import numpy as np

from ..io.decoding_quantities import DecodingQuantities
from .csfs import (CSFS, AlleleFrequencies, compute_classic_emission)
from .transition import Transition, read_demography, read_discretization

PRECISION = 2
MIN_GENETIC = 1e-10
START_GEN = 1e-10
MAX_GEN = 0.3
START_PHYS = 1
MAX_PHYS = 100_000_000


def next_gen(gen: float) -> float:
    """DecodingQuantities.java:159-165."""
    g10 = gen * 1e10
    l10 = int(max(0, math.floor(math.log10(g10)) - PRECISION))
    factor = 10.0 ** l10
    return (round(g10 / factor) + 1) * factor / 1e10


def next_phys(phys: int) -> int:
    """DecodingQuantities.java:139-147:
    ``Math.round(phys / (float) factor + 1) * factor`` (half-up rounding)."""
    l10 = int(max(0, math.floor(math.log10(phys)) - PRECISION))
    factor = 10 ** l10
    v = float(np.float32(phys) / np.float32(factor)) + 1.0
    return int(math.floor(v + 0.5)) * factor


def genetic_distance_grid() -> np.ndarray:
    grid = [0.0]
    g = START_GEN
    while g < MAX_GEN:
        grid.append(g)
        g = next_gen(g)
    return np.asarray(grid)


def physical_distance_grid() -> np.ndarray:
    grid = []
    p = START_PHYS
    while p < MAX_PHYS:
        grid.append(p)
        p = next_phys(p)
    return np.asarray(grid, dtype=np.int64)


def build_decoding_quantities(
        csfs: CSFS,
        transition: Transition,
        mu: float,
        *,
        verbose: bool = True) -> DecodingQuantities:
    """Assemble the full artifact (DecodingQuantities.java:68-137).

    ``csfs`` must already be ascertainment-fixed (``fix_ascertainment``).
    """
    K = transition.states
    gen_grid = genetic_distance_grid()
    if verbose:
        print(f"[prepare] {len(gen_grid)} genetic distances, K={K}")
    D, B, U, RR = transition.decoding_quantities_batch(gen_grid)

    # homozygous emissions: only row 0 (no-mutation probability) is stored
    # (DecodingQuantities.java:108 writes getRow(0) at :296)
    phys_grid = physical_distance_grid()
    homoz = np.exp(-2.0 * np.outer(phys_grid * mu, transition.expected_times))

    isp = transition.initial_state_prob()

    classic = compute_classic_emission(transition.expected_times, mu)

    # stack CSFS tables into [n_undist, dist, K] arrays
    keys = csfs.keys()
    samples = csfs.samples
    n_und = samples - 1

    def stack_maps(source, rows):
        width = next(iter(source.values())).csfs.shape[1]
        out = np.zeros((n_und, rows, K), dtype=np.float64)
        for ik, k in enumerate(keys):
            mat = source[k].csfs  # [rows, width]
            out[:width, :, ik] = mat.T[:, :rows]
        return out

    csfs_t = stack_maps(csfs.entries, 3)
    folded_t = stack_maps(csfs.folded, 2)
    asc_t = stack_maps(csfs.ascertained, 3)
    fold_asc_t = stack_maps(csfs.folded_ascertained, 2)

    padK = lambda m: np.pad(m.astype(np.float32), ((0, 0), (0, K - m.shape[1])))
    cr = np.zeros(K, dtype=np.float32)
    cr[:K - 1] = transition.column_ratios.astype(np.float32)

    return DecodingQuantities(
        states=K,
        csfs_samples=samples,
        time_vector=transition.time_vector.astype(np.float32),
        size_vector=transition.size_vector,
        discretization=transition.discretization.astype(np.float32),
        expected_times=transition.expected_times.astype(np.float32),
        initial_state_prob=isp.astype(np.float32),
        column_ratios=cr,
        classic_emission=classic.astype(np.float32),
        compressed_emission=csfs.compressed_ascertained_emission.astype(np.float32),
        csfs=csfs_t.astype(np.float32),
        folded_csfs=folded_t.astype(np.float32),
        ascertained_csfs=asc_t.astype(np.float32),
        folded_ascertained_csfs=fold_asc_t.astype(np.float32),
        gen_dists=gen_grid.astype(np.float32),
        D=padK(D), B=padK(B), U=padK(U), RR=padK(RR),
        phys_dists=phys_grid,
        homozygous_emissions=homoz.astype(np.float32),
    )


def prepare_decoding(
        *,
        demography_file: str,
        discretization_file: str,
        csfs_file: Optional[str] = None,
        file_root: Optional[str] = None,
        freq_file: Optional[str] = None,
        samples: int = 300,
        mu: float = 1.65e-8,
        verbose: bool = True) -> DecodingQuantities:
    """Full PREPARE_DECODING pipeline (ASMCprepareDecoding.java:40-346)."""
    tv, sv = read_demography(demography_file)
    disc = read_discretization(discretization_file)
    if freq_file:
        freqs = AlleleFrequencies.from_frq_file(freq_file)
    else:
        assert file_root, "need file_root or freq_file for array frequencies"
        freqs = AlleleFrequencies.from_haps(file_root)
    samples = min(samples, freqs.haploid_sample_size)
    transition = Transition(tv, sv, disc)
    if not csfs_file:
        # no smcpp artifact: compute the conditioned SFS directly
        # (prepare/conditioned_sfs.py replaces get_csfs.py's _smcpp.raw_sfs)
        from .conditioned_sfs import compute_csfs_file
        if verbose:
            print(f"[prepare] computing CSFS (n={samples}) from "
                  f"{demography_file} ...")
        with tempfile.TemporaryDirectory() as tmp:
            csfs_file = os.path.join(tmp, "computed.csfs")
            compute_csfs_file(demography_file, discretization_file, samples,
                              csfs_file, mu=mu)
            csfs = CSFS.load(csfs_file)
    else:
        csfs = CSFS.load(csfs_file)
    if not csfs.verify(tv, sv, mu, samples, disc):
        raise ValueError(
            f"CSFS file {csfs_file} does not match the demography/"
            f"discretization/mu/samples requested; regenerate it with smcpp.")
    csfs.fix_ascertainment(freqs, samples, transition)
    return build_decoding_quantities(csfs, transition, mu, verbose=verbose)


# ---------------------------------------------------------------------------
# reference text format writer (DecodingQuantities.java:190-299)
# ---------------------------------------------------------------------------

def _fmt(x: float) -> str:
    """Shortest round-trip decimal for a double (close to Java toString)."""
    return repr(float(x))


def _row(vals) -> str:
    return "\t".join(_fmt(v) for v in vals) + "\t\n"


def write_reference_text(dq: DecodingQuantities, path: str) -> None:
    """Write the reference gzipped text format so the artifact interoperates
    with the original C++ engine."""
    opener = gzip.open if path.endswith(".gz") else open
    K = dq.states
    with opener(path, "wt") as f:
        f.write("TransitionType\nCSC\n\n")
        f.write(f"States\n{K}\n\n")
        f.write(f"CSFSSamples\n{dq.csfs_samples}\n\n")
        f.write("TimeVector\n" + _row(dq.time_vector) + "\n")
        f.write("SizeVector\n" + _row(dq.size_vector if dq.size_vector is not None
                                      else np.zeros(0)) + "\n")
        f.write("Discretization\n" + _row(dq.discretization) + "\n")
        f.write("ExpectedTimes\n" + _row(dq.expected_times))
        f.write("\n")
        n_unfolded = dq.csfs_samples - 1      # Java: CSFS[0].length columns
        n_folded = dq.csfs_samples // 2 + 1   # folded table column count
        for und in range(n_unfolded):
            f.write(f"CSFS\t{und}\n")
            for dist in range(3):
                f.write(_row(dq.csfs[und, dist]))
        f.write("\n")
        for und in range(n_folded):
            f.write(f"FoldedCSFS\t{und}\n")
            for dist in range(2):
                f.write(_row(dq.folded_csfs[und, dist]))
        f.write("\n")
        f.write("ClassicEmission\n")
        for r in range(2):
            f.write(_row(dq.classic_emission[r]))
        f.write("\n")
        for und in range(n_unfolded):
            f.write(f"AscertainedCSFS\t{und}\n")
            for dist in range(3):
                f.write(_row(dq.ascertained_csfs[und, dist]))
        f.write("\n")
        for und in range(n_folded):
            f.write(f"FoldedAscertainedCSFS\t{und}\n")
            for dist in range(2):
                f.write(_row(dq.folded_ascertained_csfs[und, dist]))
        f.write("\n")
        f.write("CompressedAscertainedEmission\n")
        for r in range(2):
            f.write(_row(dq.compressed_emission[r]))
        f.write("\n")
        f.write("initialStateProb\n" + _row(dq.initial_state_prob))
        f.write("\n")
        f.write("ColumnRatios\n" + _row(dq.column_ratios[:K - 1]))
        f.write("\n")
        f.write("RowRatios\n")
        for i, g in enumerate(dq.gen_dists):
            f.write(_fmt(g) + "\t" + _row(dq.RR[i, :K - 1]))
        f.write("\n")
        f.write("Uvectors\n")
        for i, g in enumerate(dq.gen_dists):
            f.write(_fmt(g) + "\t" + _row(dq.U[i, :K - 1]))
        f.write("\n")
        f.write("Bvectors\n")
        for i, g in enumerate(dq.gen_dists):
            f.write(_fmt(g) + "\t" + _row(dq.B[i, :K - 1]))
        f.write("\n")
        f.write("Dvectors\n")
        for i, g in enumerate(dq.gen_dists):
            f.write(_fmt(g) + "\t" + _row(dq.D[i, :K]))
        f.write("\n")
        f.write("HomozygousEmissions\n")
        for i, p in enumerate(dq.phys_dists):
            f.write(str(int(p)) + "\t" + _row(dq.homozygous_emissions[i]))


def write_intervals_info(dq: DecodingQuantities, path: str) -> None:
    """``.intervalsInfo`` writer (ASMCprepareDecoding.java:339-343)."""
    with open(path, "wt") as f:
        for i in range(dq.states):
            f.write(f"{_fmt(dq.discretization[i])}\t"
                    f"{_fmt(dq.expected_times[i])}\t"
                    f"{_fmt(dq.discretization[i + 1])}\n")
