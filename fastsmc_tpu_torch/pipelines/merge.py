"""Merge per-job posterior-sum matrices (MERGE_POSTERIORS equivalent).

A copy of ``fastsmc_tpu/pipelines/merge.py`` (numpy only): the ASMC half of
a multi-job run's merge, as ``parallel.multihost.merge_ibd_outputs`` is the
FastSMC half. It reimplements the reference's
``TOOLS/MERGE_POSTERIORS/src/asmcmergeposteriorsums/PosteriorMerger.java``:

  * merge by job indices (``<root>.<job>-<jobs>.{00,01,11}.sumOverPairs.gz``,
    PosteriorMerger.java:182-236) or by a file list with genetic-map
    intersection (PosteriorMerger.java:43-118);
  * optional row normalisation;
  * expected coalescent time per site from an ``.intervalsInfo`` file
    (PosteriorMerger.java:207-232).
"""

from __future__ import annotations

import gzip
from typing import Dict, List, Optional, Tuple

import numpy as np


def _read_matrix(path: str) -> np.ndarray:
    with gzip.open(path, "rt") as f:
        return np.array([[float(x) for x in line.split()]
                         for line in f if line.strip()], dtype=np.float32)


def _write_matrix(path: str, m: np.ndarray) -> None:
    with gzip.open(path, "wt") as f:
        for row in m:
            f.write("\t".join(repr(float(v)) for v in row) + "\n")


def _normalize_rows(m: np.ndarray) -> np.ndarray:
    s = m.sum(axis=1, keepdims=True)
    with np.errstate(divide="ignore", invalid="ignore"):
        out = np.where(s > 0, m / s, m)
    return out


def _read_map_keys(path: str) -> List[str]:
    keys = []
    with gzip.open(path, "rt") as f:
        for line in f:
            sl = line.split()
            keys.append(f"{sl[0]}\t{sl[1]}\t{sl[3]}")
    return keys


class PosteriorMerger:
    def __init__(self):
        self.sum00 = self.sum01 = self.sum11 = self.sum_all = None
        self.exp_times: Dict[str, np.ndarray] = {}
        self.map_keys: Optional[List[str]] = None
        self.map_lines: Dict[str, str] = {}

    # -- by job indices (PosteriorMerger.java:173-200, 236-250) ----------
    @classmethod
    def from_job_indices(cls, file_root: str, jobs: int,
                         normalize: bool = False) -> "PosteriorMerger":
        self = cls()
        mats = {}
        for tag in ("00", "01", "11"):
            acc = None
            for job in range(1, jobs + 1):
                m = _read_matrix(f"{file_root}.{job}-{jobs}.{tag}"
                                 f".sumOverPairs.gz")
                acc = m if acc is None else acc + m
            mats[tag] = acc
        self._finish(mats, normalize)
        return self

    # -- by file list with map intersection (PosteriorMerger.java:43-152) -
    @classmethod
    def from_file_list(cls, roots: List[str], normalize: bool = False
                       ) -> "PosteriorMerger":
        self = cls()
        counts: Dict[str, int] = {}
        order: List[str] = []
        lines: Dict[str, str] = {}
        per_root_keys = {}
        for root in roots:
            keys = _read_map_keys(root + ".map.gz")
            per_root_keys[root] = keys
            with gzip.open(root + ".map.gz", "rt") as f:
                for key, line in zip(keys, f):
                    lines[key] = line.rstrip("\n")
            for k in keys:
                if k not in counts:
                    order.append(k)
                counts[k] = counts.get(k, 0) + 1
        common = {k for k, c in counts.items() if c == len(roots)}
        self.map_keys = [k for k in order if k in common]
        self.map_lines = lines

        mats = {}
        for tag in ("00", "01", "11"):
            acc = None
            for root in roots:
                m = _read_matrix(f"{root}.{tag}.sumOverPairs.gz")
                keep = np.array([k in common for k in per_root_keys[root]])
                m = m[keep]
                acc = m if acc is None else acc + m
            mats[tag] = acc
        self._finish(mats, normalize)
        return self

    def _finish(self, mats, normalize):
        self.sum00, self.sum01, self.sum11 = (mats["00"], mats["01"],
                                              mats["11"])
        self.sum_all = self.sum00 + self.sum01 + self.sum11
        if normalize:
            self.sum00 = _normalize_rows(self.sum00)
            self.sum01 = _normalize_rows(self.sum01)
            self.sum11 = _normalize_rows(self.sum11)
            self.sum_all = _normalize_rows(self.sum_all)

    # -- expected coalescent times (PosteriorMerger.java:207-232) --------
    def compute_coalescent_times(self, intervals_info: str) -> None:
        means = np.loadtxt(intervals_info)[:, 1].astype(np.float32)
        if len(means) != self.sum00.shape[1]:
            raise ValueError(f"wrong number of rows in info: {len(means)}")
        for tag, m in (("00", self.sum00), ("01", self.sum01),
                       ("11", self.sum11), ("all", self.sum_all)):
            self.exp_times[tag] = m @ means

    # -- writers (PosteriorMerger.java:252-323) --------------------------
    def write(self, out_root: str) -> None:
        _write_matrix(out_root + ".merged.00.sumOverPairs.gz", self.sum00)
        _write_matrix(out_root + ".merged.01.sumOverPairs.gz", self.sum01)
        _write_matrix(out_root + ".merged.11.sumOverPairs.gz", self.sum11)
        _write_matrix(out_root + ".merged.sumOverPairs.gz", self.sum_all)
        if self.exp_times:
            for tag, suffix in (("00", ".merged.00.expCoalTime.gz"),
                                ("01", ".merged.01.expCoalTime.gz"),
                                ("11", ".merged.11.expCoalTime.gz"),
                                ("all", ".merged.expCoalTime.gz")):
                with gzip.open(out_root + suffix, "wt") as f:
                    for v in self.exp_times[tag]:
                        f.write(f"{float(v)}\n")
        if self.map_keys:
            with gzip.open(out_root + ".merged.map.gz", "wt") as f:
                for k in self.map_keys:
                    f.write(self.map_lines[k] + "\n")
