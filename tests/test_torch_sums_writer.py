"""The port's posterior-sums writer (``fastsmc_tpu_torch.io.writers``
``write_sums_files``): every file a series of complete gzip members of
SUMS_CHUNK_ROWS rows, formatted by the native library or the Python
"%.6g" loop and deflated on a pool of W threads; the decompressed bytes
equal the Python text and the JAX package's single-stream writers, with the
library and without, at W = 1 and W = 7."""

import gzip
import threading
import zlib

import numpy as np
import pytest

from fastsmc_tpu.io import writers as jax_writers

from fastsmc_tpu_torch import native
from fastsmc_tpu_torch.io import writers
from fastsmc_tpu_torch.utils.timer import SpanRecorder

F32 = np.finfo(np.float32)
# values whose "%.6g" text is easy to get wrong: signed zero, subnormals,
# the switch to an exponent below 1e-4, rounding up to 1e+06, decimal
# ties, both NaNs, the infinities and float32's extremes
EDGES = np.array([0.0, -0.0, 1e-45, -1e-45, F32.tiny, 1e-4, 1e-5,
                  9.99999e-5, 999999.5, 1234565.0, 1234575.0, np.nan,
                  -np.nan, np.inf, -np.inf, F32.max, -F32.max, 0.1, 15000.25],
                 np.float32)
SHAPES = {"one row": (1, 69), "a chunk and a bit": (2001, 7),
          "the biobank job": (6759, 69)}
MODES = ["native, W=7", "native, W=1", "python, W=7", "python, W=1"]


def _workers(monkeypatch, w):
    """W = ``w``, through the core count the writers read."""
    monkeypatch.setattr(writers, "_usable_cores", lambda: w + 1)
    assert writers.pool_workers() == w


def _mode(monkeypatch, mode):
    """The library present or patched away, and W, as ``mode`` names."""
    if mode.startswith("python"):
        monkeypatch.setattr(native, "get_lib", lambda: None)
    else:
        assert native.get_lib() is not None
    _workers(monkeypatch, int(mode.rsplit("=", 1)[1]))


def _matrices(shape, seed):
    """Four [rows, cols] float32 matrices of sums up to ~15,000 with the
    edge values spread over them, and a fold mask."""
    rng = np.random.default_rng(seed)
    mats = (rng.random((4,) + shape) * 15000).astype(np.float32)
    flat = mats.reshape(4, -1)
    for k in range(4):
        at = rng.choice(flat.shape[1], min(len(EDGES), flat.shape[1]),
                        replace=False)
        flat[k, at] = EDGES[:len(at)]
    return mats, rng.random(shape[0]) < 0.5


def _gunzip(path):
    with gzip.open(path, "rb") as fh:
        return fh.read()


def _members(data):
    """Each gzip member's text, walked with zlib alone; every member must
    be complete."""
    out = []
    while data:
        d = zlib.decompressobj(31)
        out.append(d.decompress(data) + d.flush())
        assert d.eof, "a member is cut short"
        data = d.unused_data
    return out


def _python_text(mat):
    return "".join("\t".join("%.6g" % float(v) for v in row) + "\n"
                   for row in mat).encode()


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("mode", MODES)
def test_sums_bytes_equal_python_text_and_jax_writers(shape, mode, tmp_path,
                                                      monkeypatch):
    """``write_sum_over_pairs`` and ``write_major_minor_sums`` write the
    Python "%.6g" text of each matrix, which is what the JAX package's
    writers write, in members of whole rows."""
    _mode(monkeypatch, mode)
    mats, flipped = _matrices(SHAPES[shape], 7)
    files = {}
    for tag, mod in (("port", writers), ("jax", jax_writers)):
        root = str(tmp_path / tag)
        mod.write_sum_over_pairs(root + ".sumOverPairs.gz", mats[0])
        mod.write_major_minor_sums(root, *mats[1:], flipped)
        files[tag] = [root + s for s in (".sumOverPairs.gz",
                                         ".00.sumOverPairs.gz",
                                         ".01.sumOverPairs.gz",
                                         ".11.sumOverPairs.gz")]
    m00 = np.where(flipped[:, None], mats[3], mats[1])
    m11 = np.where(flipped[:, None], mats[1], mats[3])
    for mat, port, jax in zip((mats[0], m00, mats[2], m11), *files.values()):
        want = _python_text(mat)
        got = _gunzip(port)
        assert got == want == _gunzip(jax)
        rows = [t.count(b"\n") for t in _members(open(port, "rb").read())]
        assert rows == [min(writers.SUMS_CHUNK_ROWS, len(mat) - r0) for r0
                        in range(0, len(mat), writers.SUMS_CHUNK_ROWS)]


def test_native_formatter_equals_python_on_doubles_and_empty_shapes():
    """The formatter widens any real input to a double, as ``float(v)``
    does: float64 values over the whole exponent range give Python's
    text; no columns give one newline a row, no rows no text."""
    rng = np.random.default_rng(3)
    m = rng.standard_normal((300, 9)) * 10.0 ** rng.integers(-320, 308,
                                                             (300, 9))
    m[0, :4] = [5e-324, -5e-324, np.nan, -np.inf]
    assert native.format_sums(m) == _python_text(m)
    assert native.format_sums(np.zeros((3, 0), np.float32)) == b"\n" * 3
    assert native.format_sums(np.zeros((0, 5), np.float32)) == b""


@pytest.mark.parametrize("workers", [1, 7])
def test_members_break_at_row_edges_and_read_back(workers, tmp_path,
                                                  monkeypatch):
    """At 100 rows a chunk, each file is a series of complete members,
    each decompressing alone to whole lines; ``gzip.open`` reads back the
    text and ``np.loadtxt`` the values it prints, as one stream; a
    matrix with no rows gives the JAX writer's file of one newline."""
    _workers(monkeypatch, workers)
    monkeypatch.setattr(writers, "SUMS_CHUNK_ROWS", 100)
    rng = np.random.default_rng(5)
    mats = {str(tmp_path / f"{k}.sumOverPairs.gz"):
            (rng.random((n, 13)) * 15000).astype(np.float32)
            for k, n in enumerate((250, 100, 1, 399))}
    spans = SpanRecorder()
    assert writers.write_sums_files(mats, spans) == workers
    total = 0
    for path, mat in mats.items():
        members = _members(open(path, "rb").read())
        total += len(members)
        assert len(members) == -(-len(mat) // 100)
        for i, text in enumerate(members):
            lines = text.decode().split("\n")
            assert lines[-1] == "" and len(lines) - 1 == \
                min(100, len(mat) - 100 * i)
            assert all(len(line.split("\t")) == 13 for line in lines[:-1])
        with gzip.open(path, "rt") as fh:
            assert fh.read() == _python_text(mat).decode()
        six = [[float("%.6g" % v) for v in row] for row in mat]
        assert np.array_equal(np.loadtxt(path, ndmin=2), six)
    assert spans.counter(writers.SUMS_MEMBERS) == total
    empty = str(tmp_path / "empty.gz")
    writers.write_sums_files({empty: np.zeros((0, 69), np.float32)})
    jax_writers.write_sum_over_pairs(str(tmp_path / "jax_empty.gz"),
                                     np.zeros((0, 69), np.float32))
    assert _gunzip(empty) == _gunzip(str(tmp_path / "jax_empty.gz")) \
        == b"\n"
    assert len(_members(open(empty, "rb").read())) == 1


@pytest.mark.parametrize("workers", [1, 7])
def test_formatter_failure_raises_naming_the_file(workers, tmp_path,
                                                  monkeypatch):
    """A buffer too small for the text makes the C side return -1: the
    call raises within 10 s, naming the file and rows; the files before it
    are whole, and the failed one and those after it are not written."""
    _workers(monkeypatch, workers)
    monkeypatch.setattr(writers, "SUMS_CHUNK_ROWS", 50)
    good = (np.random.default_rng(1).random((120, 5))).astype(np.float32)
    # a zero's "0" fits the patched room of two bytes a value; 15000.5
    # does not, from row 60 on
    bad = np.zeros((120, 5), np.float32)
    bad[60:] = 15000.5
    paths = [str(tmp_path / f"{k}.gz") for k in range(3)]
    monkeypatch.setattr(native, "SUMS_BYTES_PER_VALUE", 2)
    box = {}

    def run():
        try:
            writers.write_sums_files(dict(zip(paths, (bad[:60], bad,
                                                      good))))
        except RuntimeError as e:       # handed to the test
            box["err"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(10)
    assert not t.is_alive(), "the writer hung"
    err = box.get("err")
    assert err is not None and paths[1] in str(err) \
        and "rows 50-100" in str(err), err
    assert _gunzip(paths[0]) == _python_text(bad[:60])
    assert not (tmp_path / "1.gz").exists()
    assert not (tmp_path / "2.gz").exists()


def test_level_six_members_near_one_stream_in_size(tmp_path, monkeypatch):
    """The biobank job's matrix at its real chunking: four members, within
    1 % of the same text deflated at level 6 as one stream."""
    _workers(monkeypatch, 4)
    mats, _ = _matrices(SHAPES["the biobank job"], 11)
    path = str(tmp_path / "x.gz")
    writers.write_sums_files({path: mats[0]})
    data = open(path, "rb").read()
    members = _members(data)
    assert len(members) == 4
    one = len(zlib.compress(b"".join(members), 6))
    assert one < len(data) <= 1.01 * one
