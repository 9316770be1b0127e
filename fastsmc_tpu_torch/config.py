"""Decoding parameters of FastSMC and ASMC runs.

The port's copy of ``fastsmc_tpu/config.py``: the same ``DecodingParams``
dataclass, defaults and validation (reference DecodingParams.{hpp,cpp}),
with its three constructor profiles:

  * ``DecodingParams.asmc(...)``                 -- the ASMC CLI defaults
    (reference DecodingParams.cpp:75-162)
  * ``DecodingParams.fastsmc_defaults(...)``     -- the FastSMC library ctor
    (reference DecodingParams.cpp:56-73: min_m=1.5, time=50, batchSize=32,
    noConditionalAgeEstimates=True, perPair outputs on)
  * ``DecodingParams.fastsmc_cli_defaults(...)`` -- the FastSMC CLI
    (reference DecodingParams.cpp:164-276: min_m=1.0, time=100,
    batchSize=32)

Validation mirrors ``validateParamsFastSMC`` (reference
DecodingParams.cpp:278-464), including the triangular jobs-count check and
the compress <-> skipCSFSdistance coupling.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional


class ConfigError(ValueError):
    pass


TRIANGULAR_JOB_COUNTS_LIMIT = 200


def valid_job_counts(limit: int = TRIANGULAR_JOB_COUNTS_LIMIT):
    """Valid ``jobs`` values: cumulative sums of odd numbers (1, 4, 9, 16, ...).

    Mirrors the loop in reference DecodingParams.cpp:376-395.
    """
    vals = []
    x = 1
    u = 1
    for _ in range(limit):
        vals.append(u)
        x += 2
        u += x
    return vals


@dataclasses.dataclass
class DecodingParams:
    # --- I/O roots ----------------------------------------------------------
    in_file_root: str = ""
    decoding_quant_file: str = ""
    out_file_root: str = ""

    # --- jobbing ------------------------------------------------------------
    jobs: int = 1
    job_ind: int = 1

    # --- decoding mode ------------------------------------------------------
    decoding_mode: str = "array"          # "array" | "sequence"
    decoding_sequence: bool = False       # derived
    fold_data: bool = True                # derived: folded unless use_ancestral
    using_csfs: bool = True
    compress: bool = False
    use_ancestral: bool = False
    skip_csfs_distance: float = 0.0       # NaN => default (0 unless compress)

    # --- batching -----------------------------------------------------------
    no_batches: bool = False
    batch_size: int = 64

    # --- FastSMC / IBD ------------------------------------------------------
    fastsmc: bool = False
    hashing: bool = False
    bin_out: bool = False
    recall_threshold: int = 3
    time: int = 100                       # IBD time threshold in generations
    no_conditional_age_estimates: bool = False
    output_ibd_segment_length: bool = False
    use_known_seed: bool = False

    # --- hashing (GERMLINE2) options ---------------------------------------
    min_m: float = 1.0                    # minimum match length in cM
    skip: float = 0.0                     # low-complexity word skip ratio
    min_maf: float = 0.0
    gap: int = 1
    max_seeds: int = 0
    hashing_word_size: int = 64
    const_read_ahead: int = 10
    haploid: bool = True
    # Segment-scan window semantics for hashing-mode validation. The
    # reference scans every batch member over the BATCH-UNION window
    # ("permissive" override, HMM.cpp:1199-1204) — flagged in the
    # reference source itself with "remove these 2 lines if you want the
    # preprocessing step to be less permissive / TODO: add a flag for
    # this option". That compromise was sized for batchSize=32, where the
    # union stays candidate-local; at batch sizes of thousands the union
    # can span the chromosome, which both over-emits segments (~5x
    # measured at batch 2048 on a dense panel) and makes output depend on
    # batch composition. Default False = the reference's own flagged
    # less-permissive option: each candidate is scanned over ITS padded
    # window, making output invariant to batch size, candidate order and
    # grouping. True reproduces reference batch-union semantics (use
    # with batch_size=32 for byte-level comparisons against reference
    # goldens).
    permissive_window: bool = False

    # --- outputs ------------------------------------------------------------
    do_posterior_sums: bool = False
    do_per_pair_posterior_mean: bool = False
    do_per_pair_map: bool = False
    do_major_minor_posterior_sums: bool = False
    expected_coal_times_file: str = ""
    within_only: bool = False

    # ------------------------------------------------------------------------
    @classmethod
    def asmc(cls, in_file_root: str, decoding_quant_file: str = "",
             out_file_root: str = "", **kw) -> "DecodingParams":
        """ASMC profile (reference DecodingParams.cpp:31-37 + processOptions)."""
        p = cls(in_file_root=in_file_root,
                decoding_quant_file=decoding_quant_file,
                out_file_root=out_file_root,
                jobs=kw.pop("jobs", 1), job_ind=kw.pop("job_ind", 1),
                using_csfs=True)
        return p._set(kw)

    @classmethod
    def fastsmc_defaults(cls, in_file_root: str, decoding_quant_file: str = "",
                         out_file_root: str = "", **kw) -> "DecodingParams":
        """FastSMC library profile (reference DecodingParams.cpp:56-73)."""
        p = cls(in_file_root=in_file_root,
                decoding_quant_file=decoding_quant_file,
                out_file_root=out_file_root,
                fastsmc=True, hashing=True,
                batch_size=32, recall_threshold=3, min_m=1.5, time=50,
                bin_out=False, output_ibd_segment_length=True,
                no_conditional_age_estimates=True,
                do_per_pair_posterior_mean=True, do_per_pair_map=True)
        return p._set(kw)

    @classmethod
    def fastsmc_cli_defaults(cls, in_file_root: str, out_file_root: str,
                             decoding_quant_file: str = "", **kw
                             ) -> "DecodingParams":
        """FastSMC CLI profile (reference DecodingParams.cpp:164-276:
        min_m=1.0, time=100, batchSize=32, conditional age estimates on)."""
        p = cls(in_file_root=in_file_root,
                decoding_quant_file=decoding_quant_file,
                out_file_root=out_file_root,
                fastsmc=True, hashing=True,
                batch_size=32, recall_threshold=3, min_m=1.0, time=100,
                bin_out=False, output_ibd_segment_length=True,
                no_conditional_age_estimates=False,
                do_per_pair_posterior_mean=True, do_per_pair_map=True,
                skip_csfs_distance=float("nan"))
        return p._set(kw)

    def _set(self, kw: dict) -> "DecodingParams":
        """Set the fields named in ``kw`` (an unknown name raises
        ``ConfigError``), then :meth:`finalize`."""
        for k, v in kw.items():
            if not hasattr(self, k):
                raise ConfigError(f"Unknown parameter {k!r}")
            setattr(self, k, v)
        return self.finalize()

    # ------------------------------------------------------------------------
    def finalize(self) -> "DecodingParams":
        """Validate and derive dependent fields.

        Mirrors reference DecodingParams.cpp:278-464 (validateParamsFastSMC)
        and :466-558 (processOptions).
        """
        if self.fastsmc and self.hashing:
            if self.within_only:
                raise ConfigError("hashing & withinOnly cannot be used together")
            if self.time <= 0:
                raise ConfigError("time must be a positive integer")

        if self.batch_size == 0 or self.batch_size % 8 != 0:
            raise ConfigError("batchSize must be strictly positive and a multiple of 8")

        # compress <-> skipCSFSdistance coupling (DecodingParams.cpp:306-328)
        if self.compress:
            if self.use_ancestral:
                raise ConfigError("compress & useAncestral cannot be used together")
            if not math.isnan(self.skip_csfs_distance) and self.skip_csfs_distance != float("inf"):
                raise ConfigError("compress & skipCSFSdistance cannot be used together")
            self.skip_csfs_distance = float("inf")
        elif math.isnan(self.skip_csfs_distance):
            self.skip_csfs_distance = 0.0

        if self.skip_csfs_distance != float("inf"):
            self.using_csfs = True

        if self.expected_coal_times_file:
            self.do_per_pair_posterior_mean = True

        # decoding mode matrix (DecodingParams.cpp:330-352)
        mode = self.decoding_mode.lower()
        if mode == "sequence":
            self.decoding_sequence = True
        elif mode == "array":
            self.decoding_sequence = False
        else:
            raise ConfigError(f"Unknown decoding mode: {self.decoding_mode}")
        self.decoding_mode = mode
        self.fold_data = not self.use_ancestral

        if not self.decoding_quant_file:
            self.decoding_quant_file = self.in_file_root + ".decodingQuantities.gz"

        # jobs validation
        if (self.jobs == 0) != (self.job_ind == 0):
            raise ConfigError("jobs and jobInd must both be set or both be unset")
        if self.jobs == 0:
            self.jobs, self.job_ind = 1, 1
        if self.job_ind <= 0 or self.job_ind > self.jobs or self.jobs <= 0:
            raise ConfigError("jobInd must be between 1 and jobs inclusive")

        if self.fastsmc:
            counts = valid_job_counts()
            if self.jobs not in counts:
                below = max((c for c in counts if c < self.jobs), default=1)
                above = min((c for c in counts if c > self.jobs), default=counts[-1])
                raise ConfigError(
                    f"jobs value is incorrect. You should use either {below} or {above}")
            if not (0 <= self.recall_threshold <= 3):
                raise ConfigError("recall must be between 0 and 3")

        if not self.out_file_root:
            self.out_file_root = self.in_file_root
            if self.jobs > 0:
                self.out_file_root += f".{self.job_ind}-{self.jobs}"
        return self

    # ------------------------------------------------------------------------
    def ibd_output_path(self) -> str:
        """Per-job IBD file path (reference HMM.cpp:296-303)."""
        ext = "bibd.gz" if self.bin_out else "ibd.gz"
        return f"{self.out_file_root}.{self.job_ind}.{self.jobs}.FastSMC.{ext}"
