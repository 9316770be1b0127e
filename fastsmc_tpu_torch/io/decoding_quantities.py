"""Decoding quantities: canonical dense-array model artifact.

The reference stores transition quantities in float-keyed hash maps parsed
from gzipped text (ASMC_SRC/SRC/DecodingQuantities.{hpp,cpp}). The decoders
want dense device-ready arrays with an integer index per genome gap, so
this module (the port's copy of ``fastsmc_tpu/io/decoding_quantities.py``)
provides:

  * :class:`DecodingQuantities` — dense float32 arrays
    (D/B/U/RR stacked ``[n_dists, states]``, emission tables, CSFS tables)
  * a parser for the reference gzipped-text format (DecodingQuantities.cpp:60-347)
  * ``.npz`` serialisation, the JAX package's artifact format
  * float32 ``round_morgans`` / ``round_physical`` quantisation
    (HmmUtils.cpp:65-94) and index lookup replacing the float-keyed maps
"""

from __future__ import annotations

import dataclasses
import gzip
import math
from typing import Dict, List, Optional

import numpy as np


def round_morgans(value, precision: int = 2, min_genetic: float = 1e-10):
    """float32 mirror of asmc::roundMorgans (HmmUtils.cpp:65-79).

    Accepts scalar or ndarray; returns float32.
    """
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
        # zero-bp gaps give NaN/inf recombination rates; the reference would
        # throw on the map lookup (Data.cpp:194 + map::at) — clamp to the
        # minimum distance instead so such panels remain decodable
        out = np.where(np.isfinite(out), out, np.float32(min_genetic))
    return out if out.ndim else np.float32(out)


def round_physical(value, precision: int = 2):
    """Mirror of asmc::roundPhysical (HmmUtils.cpp:81-94)."""
    v = np.asarray(value)
    v_safe = np.maximum(v, 1)
    l10 = np.maximum(0, np.floor(np.log10(v_safe)).astype(np.int64) - precision)
    factor = np.power(10, l10)
    rounded = np.round(v / factor).astype(np.int64) * factor
    out = np.where(v <= 1, 1, rounded)
    return out if out.ndim else int(out)


@dataclasses.dataclass
class DecodingQuantities:
    states: int
    csfs_samples: int
    time_vector: np.ndarray            # float32 [n_demo]
    size_vector: Optional[np.ndarray]  # float64 or None (ignored by decoder)
    discretization: np.ndarray         # float32 [states+1] (last may be inf)
    expected_times: np.ndarray         # float32 [states]
    initial_state_prob: np.ndarray     # float32 [states]
    column_ratios: np.ndarray          # float32 [states] (last entry 0)
    classic_emission: np.ndarray       # float32 [2, states]
    compressed_emission: np.ndarray    # float32 [2, states]
    # CSFS tables: indexed [undistinguished, distinguished, state]
    csfs: np.ndarray                   # float32 [csfs_samples-1, 3, states]
    folded_csfs: np.ndarray            # float32 [csfs_samples-1, 2, states]
    ascertained_csfs: np.ndarray       # float32 [csfs_samples-1, 3, states]
    folded_ascertained_csfs: np.ndarray  # float32 [csfs_samples-1, 2, states]
    # genetic-distance-indexed transition quantities
    gen_dists: np.ndarray              # float32 [R] sorted (includes 0.0)
    D: np.ndarray                      # float32 [R, states]
    B: np.ndarray                      # float32 [R, states]  (last col 0)
    U: np.ndarray                      # float32 [R, states]  (last col 0)
    RR: np.ndarray                     # float32 [R, states]  (last col 0)
    # physical-distance-indexed homozygous emissions
    phys_dists: np.ndarray             # int64 [P] sorted
    homozygous_emissions: np.ndarray   # float32 [P, states]

    # ------------------------------------------------------------------
    def gen_dist_index(self, dists) -> np.ndarray:
        """Map (already rounded, float32) genetic distances to row indices in
        ``gen_dists``; raises if a distance is missing (mirrors ``map::at``)."""
        d = np.atleast_1d(np.asarray(dists, dtype=np.float32))
        idx = np.searchsorted(self.gen_dists, d)
        idx = np.clip(idx, 0, len(self.gen_dists) - 1)
        # the key may sit at idx or idx-1 after float rounding
        left_ok = self.gen_dists[np.maximum(idx - 1, 0)] == d
        idx = np.where(left_ok & (self.gen_dists[idx] != d), idx - 1, idx)
        found = self.gen_dists[idx] == d
        if not np.all(found):
            bad = d[~found][:5]
            raise KeyError(f"genetic distances not in decoding quantities: {bad}")
        return idx if np.ndim(dists) else int(idx[0])

    def phys_dist_index(self, dists) -> np.ndarray:
        d = np.atleast_1d(np.asarray(dists, dtype=np.int64))
        idx = np.searchsorted(self.phys_dists, d)
        idx = np.clip(idx, 0, len(self.phys_dists) - 1)
        found = self.phys_dists[idx] == d
        if not np.all(found):
            raise KeyError(f"physical distances not in decoding quantities: "
                           f"{d[~found][:5]}")
        return idx if np.ndim(dists) else int(idx[0])

    # ------------------------------------------------------------------
    @classmethod
    def load_npz(cls, path: str) -> "DecodingQuantities":
        z = np.load(path)
        sv = z["size_vector"]
        return cls(
            states=int(z["states"]), csfs_samples=int(z["csfs_samples"]),
            time_vector=z["time_vector"],
            size_vector=sv if sv.size else None,
            discretization=z["discretization"],
            expected_times=z["expected_times"],
            initial_state_prob=z["initial_state_prob"],
            column_ratios=z["column_ratios"],
            classic_emission=z["classic_emission"],
            compressed_emission=z["compressed_emission"],
            csfs=z["csfs"], folded_csfs=z["folded_csfs"],
            ascertained_csfs=z["ascertained_csfs"],
            folded_ascertained_csfs=z["folded_ascertained_csfs"],
            gen_dists=z["gen_dists"], D=z["D"], B=z["B"], U=z["U"], RR=z["RR"],
            phys_dists=z["phys_dists"],
            homozygous_emissions=z["homozygous_emissions"],
        )

    def save_npz(self, path: str) -> None:
        """Write the ``.npz`` artifact :meth:`load_npz` reads back field for
        field (a ``size_vector`` of None is stored empty)."""
        np.savez_compressed(
            path,
            states=self.states, csfs_samples=self.csfs_samples,
            time_vector=self.time_vector,
            size_vector=(self.size_vector if self.size_vector is not None
                         else np.zeros(0)),
            discretization=self.discretization,
            expected_times=self.expected_times,
            initial_state_prob=self.initial_state_prob,
            column_ratios=self.column_ratios,
            classic_emission=self.classic_emission,
            compressed_emission=self.compressed_emission,
            csfs=self.csfs, folded_csfs=self.folded_csfs,
            ascertained_csfs=self.ascertained_csfs,
            folded_ascertained_csfs=self.folded_ascertained_csfs,
            gen_dists=self.gen_dists, D=self.D, B=self.B, U=self.U,
            RR=self.RR, phys_dists=self.phys_dists,
            homozygous_emissions=self.homozygous_emissions,
        )

    # ------------------------------------------------------------------
    @classmethod
    def load(cls, path: str) -> "DecodingQuantities":
        """Load either our .npz or the reference gzipped-text format."""
        if path.endswith(".npz"):
            return cls.load_npz(path)
        return parse_reference_text(path)


# ---------------------------------------------------------------------------
# reference text format parser (DecodingQuantities.cpp:60-347)
# ---------------------------------------------------------------------------

def _f32(tokens) -> np.ndarray:
    return np.array([np.float32(float(t)) for t in tokens], dtype=np.float32)


def parse_reference_text(path: str) -> DecodingQuantities:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        first = f.readline().strip()
        if first != "TransitionType":
            raise ValueError(
                f"Decoding quantities file {path} does not seem to contain the "
                f'correct information. Expected file to begin with '
                f'"TransitionType", but instead found "{first}"')
        f.seek(0)
        lines = f.read().splitlines()

    states = 0
    csfs_samples = 0
    time_vector = np.zeros(0, np.float32)
    size_vector = None
    discretization = np.zeros(0, np.float32)
    expected_times = np.zeros(0, np.float32)
    initial_state_prob = np.zeros(0, np.float32)
    column_ratios = np.zeros(0, np.float32)
    classic = np.zeros((2, 0), np.float32)
    compressed = np.zeros((2, 0), np.float32)
    csfs_map: Dict[int, np.ndarray] = {}
    folded_map: Dict[int, np.ndarray] = {}
    asc_map: Dict[int, np.ndarray] = {}
    fold_asc_map: Dict[int, np.ndarray] = {}
    gen_keys: List[np.float32] = []
    dvec: Dict[np.float32, np.ndarray] = {}
    bvec: Dict[np.float32, np.ndarray] = {}
    uvec: Dict[np.float32, np.ndarray] = {}
    rrvec: Dict[np.float32, np.ndarray] = {}
    phys_keys: List[int] = []
    homoz: Dict[int, np.ndarray] = {}

    i = 0
    section = None
    n = len(lines)
    while i < n:
        tokens = lines[i].split()
        i += 1
        if not tokens:
            continue
        head = tokens[0].lower()
        if head == "transitiontype":
            i += 1
        elif head == "states":
            states = int(lines[i]); i += 1
        elif head == "csfssamples":
            csfs_samples = int(lines[i]); i += 1
        elif head == "timevector":
            time_vector = _f32(lines[i].split()); i += 1
        elif head == "sizevector":
            size_vector = np.array([float(x) for x in lines[i].split()]); i += 1
        elif head == "expectedtimes":
            expected_times = _f32(lines[i].split()); i += 1
        elif head == "discretization":
            discretization = _f32(lines[i].split()); i += 1
        elif head == "classicemission":
            classic = np.stack([_f32(lines[i].split()), _f32(lines[i + 1].split())])
            i += 2
        elif head == "compressedascertainedemission":
            compressed = np.stack([_f32(lines[i].split()),
                                   _f32(lines[i + 1].split())])
            i += 2
        elif head in ("csfs", "ascertainedcsfs"):
            target = csfs_map if head == "csfs" else asc_map
            undist = int(tokens[1])
            target[undist] = np.stack([_f32(lines[i + k].split())
                                       for k in range(3)])
            i += 3
        elif head in ("foldedcsfs", "foldedascertainedcsfs"):
            target = folded_map if head == "foldedcsfs" else fold_asc_map
            undist = int(tokens[1])
            target[undist] = np.stack([_f32(lines[i + k].split())
                                       for k in range(2)])
            i += 2
        elif head == "initialstateprob":
            section = "isp"
        elif head == "columnratios":
            section = "cr"
        elif head == "rowratios":
            section = "rr"
        elif head == "uvectors":
            section = "u"
        elif head == "bvectors":
            section = "b"
        elif head == "dvectors":
            section = "d"
        elif head == "homozygousemissions":
            section = "homoz"
        else:
            if section == "isp":
                initial_state_prob = _f32(tokens)
            elif section == "cr":
                column_ratios = _f32(tokens)
            elif section in ("rr", "u", "b", "d"):
                key = np.float32(float(tokens[0]))
                vals = _f32(tokens[1:])
                if section == "rr":
                    rrvec[key] = vals
                elif section == "u":
                    uvec[key] = vals
                elif section == "b":
                    bvec[key] = vals
                else:
                    if key not in dvec:
                        gen_keys.append(key)
                    dvec[key] = vals
            elif section == "homoz":
                k = int(tokens[0])
                phys_keys.append(k)
                homoz[k] = _f32(tokens[1:])

    K = states
    gen_dists = np.sort(np.array(sorted(set(dvec.keys())), dtype=np.float32))
    R = len(gen_dists)

    def stack(vmap, width):
        out = np.zeros((R, K), dtype=np.float32)
        for r, key in enumerate(gen_dists):
            row = vmap[np.float32(key)]
            out[r, :len(row)] = row[:K]
        return out

    D = stack(dvec, K)
    B = stack(bvec, K)
    U = stack(uvec, K)
    RRm = stack(rrvec, K)

    phys_dists = np.sort(np.array(sorted(set(phys_keys)), dtype=np.int64))
    hz = np.zeros((len(phys_dists), K), dtype=np.float32)
    for r, key in enumerate(phys_dists):
        row = homoz[int(key)]
        hz[r, :len(row)] = row[:K]

    n_und = max(csfs_samples - 1, 0)

    def stack_csfs(m, rows):
        out = np.zeros((n_und, rows, K), dtype=np.float32)
        for u, mat in m.items():
            out[u, :, :mat.shape[1]] = mat[:, :K]
        return out

    cr = np.zeros(K, dtype=np.float32)
    cr[:len(column_ratios)] = column_ratios[:K]

    return DecodingQuantities(
        states=K, csfs_samples=csfs_samples,
        time_vector=time_vector, size_vector=size_vector,
        discretization=discretization, expected_times=expected_times,
        initial_state_prob=initial_state_prob, column_ratios=cr,
        classic_emission=classic, compressed_emission=compressed,
        csfs=stack_csfs(csfs_map, 3), folded_csfs=stack_csfs(folded_map, 2),
        ascertained_csfs=stack_csfs(asc_map, 3),
        folded_ascertained_csfs=stack_csfs(fold_asc_map, 2),
        gen_dists=gen_dists, D=D, B=B, U=U, RR=RRm,
        phys_dists=phys_dists, homozygous_emissions=hz,
    )
