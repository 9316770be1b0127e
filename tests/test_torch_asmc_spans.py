"""ASMC's spans and counters (``pipelines/asmc.py``) and its sums against
the benchmark's plain reference, on the CPU, on a 1,024-haplotype mosaic
of ASMC's example array panel (640 sites, one job of 256 pairs): the sums
files lie within 1e-5 per pair of the float64 reference and are never
negative, on a panel where the emission guard's class-sum step acts; under
a CPU ``torch.profiler`` the ``asmc.*`` ranges of a job nest as the
pipeline documents, and without one no range is opened; ``roofline()`` is
the spans' totals and the counters; the sums writer's pool records its
spans under ``asmc.write`` and counts the members in the files; and a
profiled job writes the same sums."""

import gzip
import json
import zlib

import numpy as np
import pytest
import torch

import fastsmc_tpu_torch as sut
from fastsmc_tpu_torch import native
from fastsmc_tpu_torch.config import DecodingParams
from fastsmc_tpu_torch.engine import emissions
from fastsmc_tpu_torch.io import writers
from fastsmc_tpu_torch.engine.oracle import DecodeContext
from fastsmc_tpu_torch.pipelines.asmc import ASMC
from gpubench import checks, harness, panel
from gpubench.reference import model
from gpubench.reference.jobs import job_range

# each span of an ASMC job and the span it opens under (None: no asmc.*
# span around it)
PARENTS = {
    "asmc.init": None,
    "asmc.decode": None,
    "asmc.batch.pairs": "asmc.decode",
    "asmc.decode.prologue": "asmc.decode",
    "asmc.decode.forward": "asmc.decode",
    "asmc.decode.backward": "asmc.decode",
    "asmc.d2h": "asmc.decode",
    "asmc.accumulate": "asmc.decode",
    "asmc.per_pair.write": "asmc.decode",
    "asmc.write": None,
}
# spans of the sums writer's worker threads: in memory only
THREAD_PARENTS = {
    "asmc.write.format": "asmc.write",
    "asmc.write.deflate": "asmc.write",
}
JOBS, JOB, BATCH = 2048, 4, 128       # 256 pairs of 512 samples' 523,776
W, CHUNK_ROWS = 4, 200                # each file of 640 rows in 4 members


@pytest.fixture(scope="module")
def mosaic():
    cell = harness.load_cell("asmc_jobs_sums")
    spec = harness.panel_spec(cell)
    spec.update(haplotypes=1024, sites=640)
    spec.pop("morgans")
    pan = panel.make_panel(spec, 1, "cpu")
    return cell, pan, harness.program_data(sut, pan)


def _job(mosaic, root: str) -> ASMC:
    """The job decoded and its files written: the cell's parameters with
    the per-pair posterior means streamed too; the sums writer on W
    threads, CHUNK_ROWS rows a member."""
    cell, _, data = mosaic
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(writers, "_usable_cores", lambda: W + 1)
        mp.setattr(writers, "SUMS_CHUNK_ROWS", CHUNK_ROWS)
        return _decoded_and_written(cell, data, root)


def _decoded_and_written(cell, data, root: str) -> ASMC:
    p = DecodingParams(
        in_file_root=root, decoding_quant_file=harness.dq_file(cell.config),
        out_file_root=root, jobs=JOBS, job_ind=JOB,
        do_per_pair_posterior_mean=True, **cell.config["params"]).finalize()
    a = ASMC(p, data=data, device="cpu", batch_size=BATCH)
    a.write_outputs(a.decode_all_in_job(verbose=False))
    return a


def _files(mosaic, root: str) -> dict:
    return {k: root + suffix for k, suffix in
            checks.asmc_files(mosaic[0].config["params"]).items()}


def _members(path: str) -> int:
    """The complete gzip members of ``path``, walked with zlib alone."""
    with open(path, "rb") as fh:
        data = fh.read()
    n = 0
    while data:
        d = zlib.decompressobj(31)
        d.decompress(data)
        assert d.eof, "a member is cut short"
        data, n = d.unused_data, n + 1
    return n


def _decompressed(files: dict) -> dict:
    out = {}
    for k, path in files.items():
        with gzip.open(path, "rb") as fh:
            out[k] = fh.read()
    return out


@pytest.fixture(scope="module")
def plain(mosaic, tmp_path_factory):
    """A job with no profiler, every record_function range refused."""
    opened = []

    def record_function(name, *a, **k):
        opened.append(name)
        raise AssertionError("a range opened without a profiler")

    root = str(tmp_path_factory.mktemp("plain") / "job")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.profiler, "record_function", record_function)
        a = _job(mosaic, root)
    return a, _files(mosaic, root), opened


@pytest.fixture(scope="module")
def profiled(mosaic, tmp_path_factory):
    """The same job under a CPU profiler, and the trace's ``asmc.*``
    annotations (start, end, name, thread)."""
    d = tmp_path_factory.mktemp("profiled")
    root = str(d / "job")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        a = _job(mosaic, root)
    prof.export_chrome_trace(str(d / "trace.json"))
    with open(d / "trace.json") as fh:
        events = json.load(fh)["traceEvents"]
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"],
              e.get("tid")) for e in events
             if e.get("cat") == "user_annotation"
             and str(e.get("name", "")).startswith("asmc.")]
    return a, _files(mosaic, root), spans


def test_sums_lie_near_the_reference_and_are_never_negative(mosaic, plain):
    """Each sums file within 1e-5 per pair of the reference's float64
    sums of the job's pairs, as ``checks.check_asmc`` compares them, on a
    panel where the class-sum step of the emission guard acts."""
    cell, pan, data = mosaic
    a, files, _ = plain
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(emissions, "raise_negative_sums",
                   lambda em1, em0minus1, em2minus0: (em0minus1, em2minus0))
        raw = DecodeContext.build(a.params, data, a.dq).emissions
    assert (raw.em1 + raw.em0minus1 + raw.em2minus0 < 0).any()
    got = {k: checks.read_matrix(path) for k, path in files.items()}
    assert min(g.min() for g in got.values()) >= 0
    m = model.build_model(harness.dq_file(cell.config),
                          pan.genetic_positions, pan.dac,
                          np.full(pan.sites, pan.haplotypes), 1234)
    want = checks.asmc_reference(pan, m, JOBS, JOB, "float64", 256, files)
    s, e = job_range(pan.haplotypes // 2, JOBS, JOB)
    assert e - s == 256
    assert checks.asmc_gaps(got, want, e - s)["sums_gap"] <= 1e-5


def test_profiled_job_nests_its_spans_as_documented(profiled):
    """Under a CPU profiler every span of the table appears as a user
    annotation of the main thread, inside the span the table names; the
    recorder saw the same, the constructor's span forgotten at the
    decode's start, and the sums writer's threads' spans under
    ``asmc.write``, out of the trace."""
    a, _, spans = profiled
    assert {s[2] for s in spans} == set(PARENTS)
    assert len({s[3] for s in spans}) == 1
    for s0, s1, name, _ in spans:
        around = [x for x in spans if x[0] <= s0 and s1 <= x[1]
                  and x[:3] != (s0, s1, name)]
        inner = min(around, key=lambda x: x[1] - x[0])[2] if around \
            else None
        assert inner == PARENTS[name], (name, inner)
    st = a.timer.stats()
    assert set(st) == set(PARENTS) - {"asmc.init"} | set(THREAD_PARENTS)
    for name, s in st.items():
        assert set(s.parents) == {(PARENTS | THREAD_PARENTS)[name]}, name
    batches = 256 // BATCH
    for name in ("asmc.batch.pairs", "asmc.decode.prologue",
                 "asmc.decode.forward", "asmc.decode.backward", "asmc.d2h",
                 "asmc.accumulate"):
        assert st[name].count == batches, name
    assert st["asmc.decode"].count == st["asmc.write"].count == 1


def test_no_range_without_a_profiler(plain):
    a, _, opened = plain
    assert opened == []
    assert a.timer.stats()["asmc.d2h"].count == 256 // BATCH


def test_roofline_is_the_span_totals_and_counters(plain):
    a, _, _ = plain
    sp = a.timer
    got = a.roofline()
    spans = {"decode_s": "asmc.decode", "batch_pairs_s": "asmc.batch.pairs",
             "prologue_s": "asmc.decode.prologue",
             "forward_s": "asmc.decode.forward",
             "backward_s": "asmc.decode.backward", "d2h_s": "asmc.d2h",
             "accumulate_s": "asmc.accumulate",
             "per_pair_write_s": "asmc.per_pair.write",
             "write_s": "asmc.write", "write_format_s": "asmc.write.format",
             "write_deflate_s": "asmc.write.deflate"}
    assert set(got) == set(spans) | {"d2h_bytes", "pairs", "batches",
                                     "write_members", "write_native_chunks",
                                     "write_workers"}
    for key, name in spans.items():
        assert got[key] == sp.total_s(name) > 0, key
    assert (got["pairs"], got["batches"]) == (256, 256 // BATCH)
    assert got["d2h_bytes"] == sp.counter("d2h_bytes") > 0
    assert got["write_members"] == sp.counter(writers.SUMS_MEMBERS) == 16
    assert got["write_workers"] == W
    # the loop's breakdown: its direct children, inside its wall
    tops = sp.totals()
    assert set(tops) == {n for n, up in PARENTS.items()
                         if up == "asmc.decode"}
    assert sum(tops.values()) <= sp.total() == got["decode_s"]


def test_profiler_leaves_the_sums_unchanged(plain, profiled):
    a, b = _decompressed(plain[1]), _decompressed(profiled[1])
    assert a == b and all(v.count(b"\n") == 640 for v in a.values())


@pytest.mark.parametrize("library", ["native", "python"])
def test_sums_writer_counts_its_members_and_chunks(library, mosaic, plain,
                                                   tmp_path, monkeypatch):
    """``write_outputs`` writes the four files in one call of the pool:
    ``roofline()``'s ``write_members`` is the members in the four files,
    ``write_native_chunks`` equals it with the library and is 0 without,
    the format and deflate spans, one of each a member, have
    ``asmc.write`` as parent and fit in the workers' time, and the files
    hold the text of the job written with the library."""
    if library == "python":
        monkeypatch.setattr(native, "get_lib", lambda: None)
    else:
        assert native.get_lib() is not None
    root = str(tmp_path / library)
    a = _job(mosaic, root)
    got = a.roofline()
    files = _files(mosaic, root)
    members = sum(_members(p) for p in files.values())
    assert got["write_members"] == members == 4 * -(-640 // CHUNK_ROWS)
    assert got["write_native_chunks"] == \
        (members if library == "native" else 0)
    st = a.timer.stats()
    for name in THREAD_PARENTS:
        assert st[name].parents == {"asmc.write": members}, name
    assert 0 < got["write_format_s"] and 0 < got["write_deflate_s"]
    assert got["write_format_s"] + got["write_deflate_s"] <= \
        W * got["write_s"]
    assert _decompressed(files) == _decompressed(plain[1])
