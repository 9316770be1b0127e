"""Input files for the surfaces, written from what the repository holds.

  * :func:`write_model_files` writes the demography (``time size`` a line)
    and the discretisation (one boundary a line) that a decoding-quantities
    artifact was prepared from: the artifact stores both (``time_vector``/
    ``size_vector`` and ``discretization``, each with the ``inf`` that the
    readers append), so ``prepare`` can rebuild a model without the
    reference's ``CEU.demo`` and ``*.disc`` files.
  * :func:`write_asmc_panel` copies a panel whose map is in FastSMC format
    (``pos rate cM``) to one that the ASMC-mode loader reads: the same
    ``.hap.gz`` and ``.samples``, and a PLINK-style 4-column ``.map``
    (``chr snp cM bp``) holding each site's genetic position as the
    FastSMC-mode loader computes it.
"""

from __future__ import annotations

import os
import shutil
from typing import Tuple

import numpy as np

from ..config import DecodingParams
from .decoding_quantities import DecodingQuantities
from .haps import find_haps_file, find_samples_file, load_data


def _fmt(x) -> str:
    """The shortest decimal that reads back to ``x`` at its own width (a
    float32 as float32), so a value that came from a decimal file is
    written as it was there."""
    return np.format_float_positional(x, trim="-") if np.isfinite(x) \
        else repr(float(x))


def write_model_files(dq: DecodingQuantities, out_root: str
                      ) -> Tuple[str, str]:
    """``(<out_root>.demo, <out_root>.disc)`` written from ``dq``, without
    the ``inf`` entries that ``read_demography`` / ``read_discretization``
    append when they read the files back."""
    if dq.size_vector is None:
        raise ValueError("the decoding quantities store no demography")
    demo, disc = out_root + ".demo", out_root + ".disc"
    with open(demo, "w") as fh:
        for t, n in zip(dq.time_vector[:-1], dq.size_vector[:-1]):
            fh.write(f"{_fmt(t)}\t{_fmt(n)}\n")
    with open(disc, "w") as fh:
        for b in dq.discretization[:-1]:
            fh.write(f"{_fmt(b)}\n")
    return demo, disc


def write_asmc_panel(src_root: str, dst_root: str) -> str:
    """Copy the panel at ``src_root`` (FastSMC-format map) to ``dst_root``
    with an ASMC-format map; returns ``dst_root``."""
    data = load_data(DecodingParams.asmc(src_root, fastsmc=True))
    os.makedirs(os.path.dirname(os.path.abspath(dst_root)), exist_ok=True)
    hap = find_haps_file(src_root)
    shutil.copyfile(hap, dst_root + hap[len(src_root):])
    shutil.copyfile(find_samples_file(src_root), dst_root + ".samples")
    with open(dst_root + ".map", "w") as fh:
        for snp, cm, bp in zip(data.snp_ids, data.genetic_positions * 100.0,
                               data.physical_positions):
            fh.write(f"{data.chr_number}\t{snp}\t{float(cm)!r}\t{bp}\n")
    return dst_root
