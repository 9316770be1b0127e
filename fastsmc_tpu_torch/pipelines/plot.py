"""Posterior heat-map plotting (PLOT_POSTERIORS equivalent).

Reimplementation of reference ``TOOLS/PLOT_POSTERIORS/plotPosteriorHeatMap.py``
(the port's copy of ``fastsmc_tpu/pipelines/plot.py``): renders a
(sites x states) posterior-sum matrix as a log-scaled heat map with the
discretization intervals on the y axis. matplotlib is imported only inside
the function, so nothing else in the package needs it.
"""

from __future__ import annotations

import gzip
from typing import Optional

import numpy as np


def plot_posterior_heatmap(sum_over_pairs_file: str, intervals_file: str,
                           out_file: str, *, log_scale: bool = True,
                           title: Optional[str] = None,
                           max_sites: int = 5000) -> str:
    """Render ``<root>.sumOverPairs.gz`` to an image file."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    with gzip.open(sum_over_pairs_file, "rt") as f:
        mat = np.array([[float(x) for x in line.split()]
                        for line in f if line.strip()], dtype=np.float64)
    intervals = np.loadtxt(intervals_file)
    starts = intervals[:, 0]

    if mat.shape[0] > max_sites:
        stride = mat.shape[0] // max_sites + 1
        mat = mat[::stride]

    data = mat.T  # [states, sites]
    if log_scale:
        with np.errstate(divide="ignore"):
            data = np.log10(np.maximum(data, 1e-12))

    fig, ax = plt.subplots(figsize=(12, 6))
    im = ax.imshow(data, aspect="auto", origin="lower", cmap="viridis",
                   interpolation="nearest")
    ticks = np.linspace(0, data.shape[0] - 1, 10).astype(int)
    ax.set_yticks(ticks)
    ax.set_yticklabels([f"{starts[t]:.0f}" for t in ticks])
    ax.set_xlabel("site index")
    ax.set_ylabel("TMRCA interval start (generations)")
    ax.set_title(title or "sum of posterior coalescence probabilities"
                          + (" (log10)" if log_scale else ""))
    fig.colorbar(im, ax=ax)
    fig.tight_layout()
    fig.savefig(out_file, dpi=120)
    plt.close(fig)
    return out_file
