"""The port's command line (``fastsmc_tpu_torch.cli``) against the JAX
package's (``fastsmc_tpu.cli``), every subcommand run in-process through
both ``main``s, the port's on ``--device cpu`` (the kernels' plain
versions).

  * ``prepare`` (a 3-epoch demography, an 8-interval grid, n = 8, with
    ``--text``): equal arrays in the ``.npz``, equal bytes in
    ``.intervalsInfo`` and the decompressed ``.decodingQuantities.gz``;
  * ``merge`` (by job indices and by file list, with ``--norm`` and
    ``--infoFile``): equal decompressed bytes;
  * ``convert-binary`` on the ``.bibd.gz`` of the port's ``fastsmc --bin``
    run: equal stdout, and the same records as the text run;
  * ``asmc`` on an ASMC-format copy of the example panel (``io/inputs.py``;
    the panel's own map is in FastSMC format): the sums within 1e-5 per
    pair;
  * ``fastsmc`` at the CLI's defaults: the records of
    ``tests/fixtures/example_array.cli.FastSMC.ibd.gz`` (made by the JAX
    package's CLI on the CPU), keys in order, floats within relative 1e-4;
  * the refusals: ``--hashingBackend device``, ``asmc`` without an output
    flag, and ``--device cuda`` without CUDA.
"""

import dataclasses
import gzip

import numpy as np
import pytest
import torch

from fastsmc_tpu import cli as jax_cli
from fastsmc_tpu.config import DecodingParams as JaxParams

from fastsmc_tpu_torch import cli
from fastsmc_tpu_torch.config import ConfigError, DecodingParams
from fastsmc_tpu_torch.io import writers
from fastsmc_tpu_torch.io.haps import load_data
from fastsmc_tpu_torch.io.inputs import write_asmc_panel
from fastsmc_tpu_torch.pipelines.asmc import job_pair_range

from test_torch_pipeline import _assert_same_records, _records
from test_torch_prepare import one_blas_thread  # noqa: F401
from test_torch_prepare import write_small_model

PAIR_ATOL = 1e-5
SUMS = ("", ".00", ".01", ".11")


@pytest.fixture(scope="module")
def example(repo_root):
    return (str(repo_root / "artifacts" / "panels" / "example_array" /
                "example"),
            str(repo_root / "artifacts" / "n300.array.decodingQuantities.npz"))


@pytest.fixture(scope="module")
def asmc_panel(example, tmp_path_factory):
    return write_asmc_panel(example[0], str(
        tmp_path_factory.mktemp("asmc_panel") / "example"))


def decompressed(path) -> bytes:
    with gzip.open(path, "rb") as fh:
        return fh.read()


def test_fastsmc_cli_defaults_equal():
    args = ("in", "out")
    kw = dict(decoding_quant_file="dq.npz", jobs=4, job_ind=2, bin_out=True)
    assert dataclasses.asdict(DecodingParams.fastsmc_cli_defaults(
        *args, **kw)) == dataclasses.asdict(
        JaxParams.fastsmc_cli_defaults(*args, **kw))
    p = DecodingParams.fastsmc_cli_defaults(*args)
    assert (p.min_m, p.time, p.batch_size, p.skip_csfs_distance) == \
        (1.0, 100, 32, 0.0)
    assert not p.no_conditional_age_estimates


@pytest.mark.parametrize("profile", ["asmc", "fastsmc_defaults",
                                     "fastsmc_cli_defaults"])
def test_unknown_keyword_raises(profile):
    with pytest.raises(ConfigError, match="Unknown parameter 'min_mm'"):
        getattr(DecodingParams, profile)("in", "out", min_mm=2.0)


def test_prepare_equal(example, tmp_path):
    demo, disc = write_small_model(tmp_path)
    roots = {}
    for tag, main in (("port", cli.main), ("jax", jax_cli.main)):
        roots[tag] = str(tmp_path / tag)
        main(["prepare", "-D", demo, "-d", disc, "-f", example[0], "-n", "8",
              "-o", roots[tag], "--text"])
    port, ref = (np.load(roots[t] + ".decodingQuantities.npz")
                 for t in ("port", "jax"))
    assert sorted(port.files) == sorted(ref.files)
    for k in port.files:
        assert port[k].dtype == ref[k].dtype and \
            np.array_equal(port[k], ref[k]), k
    with open(roots["port"] + ".intervalsInfo", "rb") as a, \
            open(roots["jax"] + ".intervalsInfo", "rb") as b:
        assert a.read() == b.read()
    assert decompressed(roots["port"] + ".decodingQuantities.gz") == \
        decompressed(roots["jax"] + ".decodingQuantities.gz")


def _merge_inputs(d, rng, L=20, K=5):
    """Per-job major/minor sums of 4 jobs, 3 roots with partly shared
    4-column maps, and an intervals file."""
    for job in range(1, 5):
        for tag in SUMS[1:]:
            writers.write_sum_over_pairs(
                str(d / f"jobs.{job}-4{tag}.sumOverPairs.gz"),
                rng.random((L, K)).astype(np.float32))
    roots = []
    for r in range(3):
        root = str(d / f"part{r}")
        keep = np.sort(rng.choice(L + 4, L, replace=False))
        with gzip.open(root + ".map.gz", "wt") as fh:
            for s in keep:
                fh.write(f"1\tSNP_{s}\t{s * 0.01!r}\t{1000 * s}\n")
        for tag in SUMS[1:]:
            writers.write_sum_over_pairs(
                f"{root}{tag}.sumOverPairs.gz",
                rng.random((L, K)).astype(np.float32))
        roots.append(root)
    with open(d / "list.txt", "w") as fh:
        fh.write("\n".join(roots) + "\n")
    with open(d / "model.intervalsInfo", "w") as fh:
        for k in range(K):
            fh.write(f"{100.0 * k!r}\t{100.0 * k + 50!r}\t"
                     f"{100.0 * (k + 1)!r}\n")


@pytest.mark.parametrize("source", ["fileRoot", "fileList"])
def test_merge_equal(tmp_path, source):
    _merge_inputs(tmp_path, np.random.default_rng(7))
    src = ["--fileRoot", str(tmp_path / "jobs"), "--jobs", "4"] \
        if source == "fileRoot" else ["--fileList",
                                      str(tmp_path / "list.txt")]
    for tag, main in (("port", cli.main), ("jax", jax_cli.main)):
        main(["merge", *src, "--out", str(tmp_path / tag), "--norm",
              "--infoFile", str(tmp_path / "model.intervalsInfo")])
    names = [f"merged{t}.sumOverPairs.gz" for t in SUMS] + \
        [f"merged{t}.expCoalTime.gz" for t in SUMS]
    if source == "fileList":
        names.append("merged.map.gz")
    for name in names:
        assert decompressed(tmp_path / f"port.{name}") == \
            decompressed(tmp_path / f"jax.{name}"), name


@pytest.fixture(scope="module")
def fastsmc_runs(example, tmp_path_factory):
    """The port's ``fastsmc`` at the CLI's defaults on the example panel,
    as text and with ``--bin``: the two output paths."""
    d = tmp_path_factory.mktemp("fastsmc_cli")
    paths = []
    for tag, extra in (("text", []), ("bin", ["--bin"])):
        cli.main(["fastsmc", "--inFileRoot", example[0],
                  "--decodingQuantFile", example[1],
                  "--outFileRoot", str(d / tag), "--useKnownSeed",
                  "--device", "cpu", *extra])
        ext = "bibd.gz" if extra else "ibd.gz"
        paths.append(str(d / f"{tag}.1.1.FastSMC.{ext}"))
    return paths


def test_fastsmc_matches_the_jax_cli_fixture(fastsmc_runs, repo_root):
    got = _records(fastsmc_runs[0])
    want = _records(repo_root / "tests" / "fixtures" /
                    "example_array.cli.FastSMC.ibd.gz")
    assert len(got) > 1000
    _assert_same_records(got, want)


def test_convert_binary_equal(fastsmc_runs, capsys):
    outs = []
    for main in (cli.main, jax_cli.main):
        capsys.readouterr()
        main(["convert-binary", fastsmc_runs[1]])
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1]
    # the same records as the text run; the text writer prints the score
    # from float64, the binary file stores float32
    got = [line.split("\t") for line in outs[0].splitlines()]
    want = _records(fastsmc_runs[0])
    assert [r[:9] for r in got] == [r[:9] for r in want]
    np.testing.assert_allclose(
        np.array([r[9:] for r in got], dtype=np.float64),
        np.array([r[9:] for r in want], dtype=np.float64), rtol=1e-6)


def test_asmc_sums_match(example, asmc_panel, tmp_path):
    """jobs=100, job 7 (the job's two sample windows of 15 individuals, 17
    of their pairs; one batch a side), posterior and major/minor sums."""
    args = ["asmc", "--inFileRoot", asmc_panel, "--decodingQuantFile",
            example[1], "--jobs", "100", "--jobInd", "7", "--posteriorSums",
            "--majorMinorPosteriorSums", "--useKnownSeed"]
    cli.main(args + ["--outFileRoot", str(tmp_path / "port"),
                     "--device", "cpu"])
    jax_cli.main(args + ["--outFileRoot", str(tmp_path / "jax")])
    params = DecodingParams.asmc(asmc_panel, example[1], jobs=100, job_ind=7)
    start, end = job_pair_range(load_data(params).n_ind, params)
    pairs = end - start
    assert pairs == 17
    for tag in SUMS:
        got, want = (np.loadtxt(tmp_path / f"{t}{tag}.sumOverPairs.gz")
                     for t in ("port", "jax"))
        assert got.shape == want.shape == (6759, 69), tag
        assert np.abs(got - want).max() <= PAIR_ATOL * pairs, tag
    rows = np.loadtxt(tmp_path / "port.sumOverPairs.gz").sum(axis=1)
    assert np.allclose(rows, pairs, rtol=1e-3)


def test_hashing_backend_device_exits_with_the_ports_message(example,
                                                             tmp_path):
    with pytest.raises(SystemExit) as e:
        cli.main(["fastsmc", "--inFileRoot", example[0],
                  "--decodingQuantFile", example[1],
                  "--outFileRoot", str(tmp_path / "x"),
                  "--hashingBackend", "device", "--device", "cpu"])
    assert e.value.code not in (0, None)
    assert "hashing_backend='device'" in str(e.value.code) and \
        "not ported" in str(e.value.code)


def test_asmc_without_an_output_flag_exits(example, tmp_path):
    with pytest.raises(SystemExit) as e:
        cli.main(["asmc", "--inFileRoot", example[0],
                  "--decodingQuantFile", example[1], "--device", "cpu"])
    assert e.value.code not in (0, None)
    assert "At least one of --posteriorSums" in str(e.value.code)


@pytest.mark.parametrize("cmd", ["fastsmc", "asmc"])
def test_device_cuda_without_cuda_raises(example, asmc_panel, tmp_path,
                                        cmd):
    """The default --device cuda raises without CUDA; nothing falls back
    to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without CUDA")
    root = asmc_panel if cmd == "asmc" else example[0]
    args = [cmd, "--inFileRoot", root, "--decodingQuantFile",
            example[1], "--outFileRoot", str(tmp_path / cmd)]
    if cmd == "asmc":
        args.append("--posteriorSums")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(args)
