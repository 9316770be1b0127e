"""Compat surface for the reference's prepare-decoding Python package.

The port's copy of ``fastsmc_tpu/preparedecoding.py``. The reference
notebooks do ``from asmc.preparedecoding import *`` (notebooks/
asmc-api-test.ipynb, dependency ``asmc-preparedecoding`` in setup.py:75);
the underlying tool is TOOLS/PREPARE_DECODING
(ASMCprepareDecoding.java:40-346). This module re-exports the port's
implementation (``fastsmc_tpu_torch.prepare``) under that package's
vocabulary:

    from fastsmc_tpu_torch.preparedecoding import prepare_decoding
    dq = prepare_decoding(demography="CEU.demo",
                          discretization="30-100-2000.disc",
                          file_root=".../exampleFile.n300.array")
    dq.save_decoding_quantities("out.decodingQuantities.gz")
    dq.save_intervals("out.intervalsInfo")

All the math lives in ``fastsmc_tpu_torch.prepare`` (Transition/CSFS/
conditioned SFS, host numpy/scipy); this file is only a naming adapter.
"""

from __future__ import annotations

from typing import Optional

from .io.decoding_quantities import DecodingQuantities as _DQ
from .prepare.make_dq import build_decoding_quantities  # noqa: F401
from .prepare.make_dq import prepare_decoding as _prepare
from .prepare.make_dq import write_intervals_info, write_reference_text

__all__ = [
    "DecodingQuantities",
    "prepare_decoding",
    "prepare_decoding_precomputed_csfs",
    "calculate_csfs_and_prepare_decoding",
]

DEFAULT_MU = 1.65e-8
DEFAULT_SAMPLES = 300


class DecodingQuantities:
    """Result wrapper with the save methods the reference package exposes."""

    def __init__(self, native: _DQ):
        self._native = native

    @property
    def native(self) -> _DQ:
        return self._native

    def save_decoding_quantities(self, output_file_root: str) -> None:
        """Write ``<root>.decodingQuantities.gz`` (or the exact path given)
        in the reference gzipped text format (DecodingQuantities.java:190)."""
        path = output_file_root
        if not path.endswith(".decodingQuantities.gz"):
            path = output_file_root + ".decodingQuantities.gz"
        write_reference_text(self._native, path)

    def save_intervals(self, output_file_root: str) -> None:
        """Write ``<root>.intervalsInfo`` (ASMCprepareDecoding.java:339)."""
        path = output_file_root
        if not path.endswith(".intervalsInfo"):
            path = output_file_root + ".intervalsInfo"
        write_intervals_info(self._native, path)

    def save_npz(self, path: str) -> None:
        """Write the dense ``.npz`` artifact (this framework's format)."""
        self._native.save_npz(path)

    def __getattr__(self, name):
        return getattr(self._native, name)


def prepare_decoding(*,
                     demography: str,
                     discretization: str,
                     file_root: Optional[str] = None,
                     freq_file: Optional[str] = None,
                     csfs_file: Optional[str] = None,
                     samples: int = DEFAULT_SAMPLES,
                     mutation_rate: float = DEFAULT_MU,
                     verbose: bool = False) -> DecodingQuantities:
    """Full prepare-decoding pipeline (ASMCprepareDecoding.java:40-346).

    ``csfs_file`` may point at a precomputed (smcpp-style) CSFS table; when
    omitted the conditioned SFS is computed directly from the demography
    (replacing get_csfs.py's smcpp dependency). Array-ascertainment allele
    frequencies come from ``freq_file`` (.frq) or are derived from the haps
    panel at ``file_root``.
    """
    dq = _prepare(demography_file=demography,
                  discretization_file=discretization,
                  csfs_file=csfs_file,
                  file_root=file_root,
                  freq_file=freq_file,
                  samples=samples,
                  mu=mutation_rate,
                  verbose=verbose)
    return DecodingQuantities(dq)


def prepare_decoding_precomputed_csfs(csfs_file: str, *,
                                      demography: str,
                                      discretization: str,
                                      file_root: Optional[str] = None,
                                      freq_file: Optional[str] = None,
                                      samples: int = DEFAULT_SAMPLES,
                                      mutation_rate: float = DEFAULT_MU,
                                      ) -> DecodingQuantities:
    """Reference-package name for the precomputed-CSFS entry point."""
    return prepare_decoding(demography=demography,
                            discretization=discretization,
                            file_root=file_root, freq_file=freq_file,
                            csfs_file=csfs_file, samples=samples,
                            mutation_rate=mutation_rate)


def calculate_csfs_and_prepare_decoding(*,
                                        demography: str,
                                        discretization: str,
                                        file_root: Optional[str] = None,
                                        freq_file: Optional[str] = None,
                                        samples: int = DEFAULT_SAMPLES,
                                        mutation_rate: float = DEFAULT_MU,
                                        ) -> DecodingQuantities:
    """Reference-package name for the compute-CSFS-from-demography path."""
    return prepare_decoding(demography=demography,
                            discretization=discretization,
                            file_root=file_root, freq_file=freq_file,
                            samples=samples, mutation_rate=mutation_rate)
