"""The port's PosteriorMerger (fastsmc_tpu_torch.pipelines.merge) writes
the JAX package's bytes (decompressed) and holds its values bit for bit,
on the inputs of tests/test_merge.py: per-job sum matrices merged by job
indices (plain, normalised, with expected coalescent times) and two roots
with different maps merged by file list."""

import gzip

import numpy as np
import pytest

from fastsmc_tpu.pipelines.merge import PosteriorMerger as JaxMerger

from fastsmc_tpu_torch.pipelines.merge import PosteriorMerger, _read_matrix


def _write_mat(path, m):
    with gzip.open(path, "wt") as f:
        for row in m:
            f.write("\t".join(str(float(v)) for v in row) + "\n")


@pytest.fixture
def job_outputs(tmp_path):
    """tests/test_merge.py's job_outputs: 4 jobs of 20 x 5 matrices."""
    rng = np.random.default_rng(0)
    rows, cols, jobs = 20, 5, 4
    for tag in ("00", "01", "11"):
        mats = rng.random((jobs, rows, cols)).astype(np.float32)
        for j in range(jobs):
            _write_mat(str(tmp_path / f"r.{j + 1}-{jobs}.{tag}"
                           f".sumOverPairs.gz"), mats[j])
    info = tmp_path / "info"
    with open(info, "w") as f:
        for mu in (10.0, 50.0, 200.0, 1000.0, 5000.0):
            f.write(f"0\t{mu}\t0\n")
    return tmp_path, jobs, str(info)


@pytest.fixture
def roots(tmp_path):
    """tests/test_merge.py's two roots with maps over SNPs 1-5 and 2-6."""
    rng = np.random.default_rng(1)
    out = []
    for name, snps in (("a", [1, 2, 3, 4, 5]), ("b", [2, 3, 4, 5, 6])):
        mat = rng.random((5, 4)).astype(np.float32)
        with gzip.open(tmp_path / f"{name}.map.gz", "wt") as f:
            for s in snps:
                f.write(f"1\tSNP_{s}\t{s / 100}\t{s * 1000}\n")
        for tag in ("00", "01", "11"):
            _write_mat(str(tmp_path / f"{name}.{tag}.sumOverPairs.gz"), mat)
        out.append(str(tmp_path / name))
    return tmp_path, out


def _outputs(d, root):
    """Decompressed bytes of every file a merger wrote under ``root``."""
    files = sorted(p for p in d.iterdir()
                   if p.name.startswith(root + ".merged."))
    assert files
    out = {}
    for p in files:
        with gzip.open(p, "rb") as fh:
            out[p.name[len(root):]] = fh.read()
    return out


@pytest.mark.parametrize("normalize,times", [(False, False), (True, False),
                                             (True, True)],
                         ids=["plain", "normalized", "coal-times"])
def test_merge_by_job_indices_writes_the_jax_bytes(job_outputs, normalize,
                                                   times):
    d, jobs, info = job_outputs
    mergers = [cls.from_job_indices(str(d / "r"), jobs, normalize=normalize)
               for cls in (PosteriorMerger, JaxMerger)]
    for m, tag in zip(mergers, ("port", "jax")):
        if times:
            m.compute_coalescent_times(info)
        m.write(str(d / tag))
    port, jax = mergers
    for f in ("sum00", "sum01", "sum11", "sum_all"):
        np.testing.assert_array_equal(getattr(port, f), getattr(jax, f))
    assert port.exp_times.keys() == jax.exp_times.keys()
    assert _outputs(d, "port") == _outputs(d, "jax")
    if times:
        assert "expCoalTime" in "".join(_outputs(d, "port"))


def test_merge_by_file_list_writes_the_jax_bytes(roots):
    d, names = roots
    port = PosteriorMerger.from_file_list(names)
    jax = JaxMerger.from_file_list(names)
    assert port.sum00.shape == (4, 4) and port.map_keys == jax.map_keys
    port.write(str(d / "port"))
    jax.write(str(d / "jax"))
    assert _outputs(d, "port") == _outputs(d, "jax")
    back = _read_matrix(str(d / "port.merged.sumOverPairs.gz"))
    np.testing.assert_allclose(back, port.sum_all, rtol=1e-6)
