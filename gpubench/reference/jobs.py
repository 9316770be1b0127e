"""Which haplotype pairs a job decodes: ASMC's and FastSMC's flat pair
enumeration (HMM.cpp:310-364) and its split into ``jobs`` equal slices.

Per individual i, in order: for each j < i the four pairs (2j + jh,
2i + ih) with (ih, jh) in row-major {0, 1} x {0, 1}, then the pair
(2i, 2i + 1); the pairs before individual i number 2 i^2 - i.
"""

from __future__ import annotations

import numpy as np


def job_range(n_ind: int, jobs: int, job: int) -> tuple:
    """The flat indices [start, end) of job ``job`` (1-based) of ``jobs``
    over all 2 N^2 - N pairs of N individuals."""
    total = 2 * n_ind * n_ind - n_ind
    return total * (job - 1) // jobs, total * job // jobs


def pairs(flat: np.ndarray) -> tuple:
    """Haplotype pairs ``(h1, h2)`` (int64) of the flat indices ``flat``."""
    flat = np.asarray(flat, np.int64)
    # the individual i is the largest with 2 i^2 - i <= flat
    i = np.floor((1.0 + np.sqrt(1.0 + 8.0 * flat)) / 4.0).astype(np.int64)
    i -= (2 * i * i - i > flat)
    i += (2 * (i + 1) * (i + 1) - (i + 1) <= flat)
    r = flat - (2 * i * i - i)
    cross = r < 4 * i
    j, ih, jh = r // 4, (r % 4) // 2, r % 2
    return (np.where(cross, 2 * j + jh, 2 * i),
            np.where(cross, 2 * i + ih, 2 * i + 1))
