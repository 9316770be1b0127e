"""``python -m fastsmc_tpu_torch.walkthrough`` once on the CPU (the
kernels' plain versions) at a reduced CSFS sample size: the CEU 69-state
model prepared from the files written out of the artifact, ASMC sums whose
rows add up to the job's pair count, targeted pair decoding, FastSMC
records and, where matplotlib is installed, the heat map. Its own file
because the 69-state transition quantities alone take tens of seconds on
the CPU."""

import gzip
import os

import numpy as np

from fastsmc_tpu_torch import walkthrough
from fastsmc_tpu_torch.io.decoding_quantities import DecodingQuantities

from test_torch_prepare import one_blas_thread  # noqa: F401


def test_walkthrough_runs_on_the_cpu(tmp_path, capsys):
    out = walkthrough.main(["--device", "cpu", "--samples", "8",
                            "--out", str(tmp_path)])
    said = capsys.readouterr().out
    assert out == str(tmp_path) and "walkthrough complete" in said
    dq = DecodingQuantities.load(str(tmp_path /
                                     "model.decodingQuantities.npz"))
    assert dq.states == 69 and dq.csfs_samples == 8
    assert all(np.isfinite(getattr(dq, name)).all()
               for name in ("D", "B", "U", "RR", "initial_state_prob",
                            "homozygous_emissions", "compressed_emission"))
    sums = np.loadtxt(tmp_path / "asmc.sumOverPairs.gz")
    assert sums.shape == (6759, 69)
    # job 7 of 100: 17 pairs of its two 15-individual sample windows
    np.testing.assert_allclose(sums.sum(axis=1), 17, rtol=1e-3)
    with gzip.open(tmp_path / "ibd.1.1.FastSMC.ibd.gz", "rt") as fh:
        records = fh.read().splitlines()
    assert len(records) > 100 and len(records[0].split("\t")) == 13
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        assert "heat map skipped" in said
    else:
        assert os.path.getsize(tmp_path / "heatmap.png") > 0
