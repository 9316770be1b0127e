"""The port's spans (fastsmc_tpu_torch.utils.timer.SpanRecorder) and the
spans FastSMC records: nesting, parents and self time; a writer-thread
span linked to the emit that queued its block; under a CPU
``torch.profiler`` the ``fastsmc.*`` ranges of a run nest as the pipeline
documents, and without one no range is opened; ``roofline()``'s host
seconds are the spans' totals; and a profiled run writes the same
records."""

import gzip
import json
import time

import numpy as np
import pytest
import torch

import fastsmc_tpu_torch
from fastsmc_tpu_torch import native
from fastsmc_tpu_torch.io import writers
from fastsmc_tpu_torch.pipelines import fastsmc as pipeline
from fastsmc_tpu_torch.utils.timer import SpanRecorder
from fastsmc_tpu_torch.engine.kernels import GpuDecoder
from test_torch_pipeline import (_tiny_params, mosaic_panel,  # noqa: F401
                                 tiny_panel)

# each span of a FastSMC run and the spans it may open under (None: no
# fastsmc.* span around it)
PARENTS = {
    "fastsmc.init": {None},
    "fastsmc.run": {None},
    "fastsmc.intake": {"fastsmc.run"},
    "fastsmc.dispatch": {"fastsmc.run"},
    "fastsmc.decode.prologue": {"fastsmc.dispatch"},
    "fastsmc.decode.forward": {"fastsmc.dispatch"},
    "fastsmc.decode.backward": {"fastsmc.dispatch"},
    "fastsmc.extract": {"fastsmc.dispatch"},
    "fastsmc.dispatch.count_wait": {"fastsmc.dispatch"},
    "fastsmc.drain": {"fastsmc.run"},
    "fastsmc.drain.wait": {"fastsmc.drain"},
    "fastsmc.emit": {"fastsmc.run"},
    "fastsmc.checkpoint": {"fastsmc.run"},
    "fastsmc.writer.close": {"fastsmc.run"},
}
# spans of the writer and scan threads: in memory only
THREAD_PARENTS = {
    "fastsmc.writer.format": {"fastsmc.emit"},
    "fastsmc.writer.deflate": {"fastsmc.emit"},
    "fastsmc.scan": {"fastsmc.run"},
}


def test_nesting_parents_and_self_time():
    rec = SpanRecorder(root="run")
    with rec.span("run"):
        assert rec.current() == "run"
        with rec.span("a"):
            time.sleep(0.02)
            with rec.span("b"):
                time.sleep(0.03)
            assert rec.current() == "a"
        with rec.span("b"):
            time.sleep(0.01)
    assert rec.current() is None
    st = rec.stats()
    assert (st["run"].count, st["a"].count, st["b"].count) == (1, 1, 2)
    assert st["run"].parents == {None: 1}
    assert st["a"].parents == {"run": 1}
    assert st["b"].parents == {"a": 1, "run": 1}
    # totals(): the root's direct children, in the order they closed
    tops = rec.totals()
    assert list(tops) == ["a", "b"]
    assert tops["a"] == st["a"].total_s >= 0.05
    assert 0.01 <= tops["b"] < st["b"].total_s
    # self time: the total less what the spans nested in it cover
    b_in_a = st["b"].total_s - tops["b"]
    assert b_in_a >= 0.03
    assert st["a"].self_s == pytest.approx(st["a"].total_s - b_in_a)
    assert st["run"].self_s == pytest.approx(
        st["run"].total_s - tops["a"] - tops["b"], abs=1e-9)
    assert st["b"].self_s == st["b"].total_s       # nothing nested in b
    assert rec.total() == st["run"].total_s
    text = rec.report(out=None)
    assert "Time in a " in text and "Time in other" in text
    rec.reset()
    assert rec.stats() == {} and rec.totals() == {}


def test_worker_thread_span_is_linked_not_nested(tmp_path, monkeypatch):
    """The writer's worker spans stay in memory with the emit that began
    the chunk as parent; their time is not taken from the emit's self
    time, which runs on another thread. The three small blocks share one
    chunk: three formats, one deflate."""
    def slow(id_blob, id_off, ind1, *rest):
        time.sleep(0.05)
        return b"record\n" * len(ind1)

    monkeypatch.setattr(native, "get_lib", lambda: object())
    monkeypatch.setattr(native, "format_ibd", slow)
    rec = SpanRecorder()
    w = writers.IbdTextWriter(str(tmp_path / "x.ibd.gz"),
                              [f"f{i}" for i in range(4)],
                              [f"i{i}" for i in range(4)], 1, spans=rec)
    cols = (np.zeros(3, np.int64), np.ones(3, np.int64),
            np.ones(3, np.int64), np.ones(3, np.int64),
            np.arange(3), np.arange(3) + 5, None, np.ones(3), None, None)
    for _ in range(3):
        with rec.span("fastsmc.emit"):
            w.write_block(*cols)
    w.close()
    st = rec.stats()
    assert st["fastsmc.writer.format"].parents == {"fastsmc.emit": 3}
    assert st["fastsmc.writer.deflate"].parents == {"fastsmc.emit": 1}
    assert rec.total_s(writers.FORMAT) \
        == rec.total_s("fastsmc.writer.format") >= 0.15
    assert st["fastsmc.emit"].self_s == st["fastsmc.emit"].total_s < 0.1


def test_binary_writer_spans_nest_in_the_emit(tmp_path):
    """The binary writer formats and deflates on the calling thread: its
    spans nest in the emit, whose self time they leave."""
    rec = SpanRecorder()
    w = writers.IbdBinaryWriter(str(tmp_path / "x.bibd.gz"), ["f0", "f1"],
                                ["i0", "i1"], 1, True, False, False,
                                spans=rec)
    with rec.span("fastsmc.emit"):
        w.write_block(np.zeros(3, np.int64), np.ones(3, np.int64),
                      np.ones(3, np.int64), np.ones(3, np.int64),
                      np.arange(3), np.arange(3) + 5, np.ones(3),
                      np.ones(3))
    w.close()
    st = rec.stats()
    inner = st["fastsmc.writer.format"].total_s \
        + st["fastsmc.writer.deflate"].total_s
    assert st["fastsmc.writer.format"].parents == {"fastsmc.emit": 1}
    assert st["fastsmc.writer.deflate"].parents == {"fastsmc.emit": 1}
    assert st["fastsmc.emit"].self_s == pytest.approx(
        st["fastsmc.emit"].total_s - inner)


def _fastsmc(root, repo_root, out, **kw):
    return fastsmc_tpu_torch.FastSMC(_tiny_params(root, repo_root, out),
                                     device="cpu", flush_group=1, **kw)


def _mosaic_fastsmc(root, repo_root, out):
    """Hashing on the mosaic panel, job 3 of 16, in batches of 512
    candidates and flush groups of 2: batches hold up to ~6,000 level
    boundaries, more than the JAX package's starting caps (raw and kept
    4,096)."""
    return fastsmc_tpu_torch.FastSMC(
        _tiny_params(root, repo_root, out, batch_size=512, jobs=16,
                     job_ind=3), device="cpu", flush_group=2)


def _decompressed(path):
    with gzip.open(path, "rb") as fh:
        return fh.read()


def _annotations(prof, path):
    prof.export_chrome_trace(str(path))
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    return [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"],
             e.get("tid")) for e in events
            if e.get("cat") == "user_annotation"
            and str(e.get("name", "")).startswith("fastsmc.")]


def test_profiled_run_nests_its_spans_as_documented(mosaic_panel, repo_root,
                                                    tmp_path, monkeypatch):
    """Under a CPU profiler every span of the table appears as a
    user annotation of the main thread, inside the span the table names;
    the writer's and the scan's, on their threads, stay out of the
    trace. Its batches hold more runs than the JAX package's starting
    caps; each waits once for its count, none is redone, and the records
    are those of a run without the profiler."""
    monkeypatch.setattr(pipeline, "CHECKPOINT_DRAINS", 1)
    counts = []
    read_counts = GpuDecoder.read_counts

    def spy(c):
        counts.extend(read_counts(c))
        return counts[-1:]

    monkeypatch.setattr(GpuDecoder, "read_counts", staticmethod(spy))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        f = _mosaic_fastsmc(mosaic_panel, repo_root, str(tmp_path / "prof"))
        path = f.run(verbose=False)
    spans = _annotations(prof, tmp_path / "trace.json")
    names = {s[2] for s in spans}
    assert names == set(PARENTS), names ^ set(PARENTS)
    assert len({s[3] for s in spans}) == 1        # the main thread's
    for s0, s1, name, _ in spans:
        around = [x for x in spans if x[0] <= s0 and s1 <= x[1]
                  and x[:3] != (s0, s1, name)]
        inner = min(around, key=lambda x: x[1] - x[0])[2] if around \
            else None
        assert inner in PARENTS[name], (name, inner)
    assert max(n_raw for n_raw, _ in counts) > 4096
    assert f.stats["overflow_redos"] == 0
    assert f.timer.stats()["fastsmc.dispatch.count_wait"].count \
        == len(counts) == f.stats["flushes"]
    plain = _mosaic_fastsmc(mosaic_panel, repo_root, str(tmp_path / "plain"))
    assert _decompressed(plain.run(verbose=False)) == _decompressed(path)
    # the recorder saw the same structure, and the threads' spans
    st = f.timer.stats()
    assert set(st) == set(PARENTS) - {"fastsmc.init"} | set(THREAD_PARENTS)
    for name, s in st.items():
        assert set(s.parents) <= (PARENTS | THREAD_PARENTS)[name], name


def test_no_range_without_a_profiler(tiny_panel, repo_root, tmp_path,
                                     monkeypatch):
    """Without a profiler a run opens no record_function range."""
    opened = []

    def record_function(name, *a, **k):
        opened.append(name)
        raise AssertionError("a range opened without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", record_function)
    f = _fastsmc(tiny_panel, repo_root, str(tmp_path / "plain"))
    f.run(verbose=False)
    assert opened == []
    assert f.timer.stats()["fastsmc.dispatch.count_wait"].count \
        == f.stats["flushes"]


def test_roofline_host_seconds_are_span_totals(tiny_panel, repo_root,
                                               tmp_path, monkeypatch):
    monkeypatch.setattr(pipeline, "CHECKPOINT_DRAINS", 1)
    f = _fastsmc(tiny_panel, repo_root, str(tmp_path / "r"))
    f.run(verbose=False)
    sp = f.timer
    got = f.roofline()
    wait = sp.total_s("fastsmc.drain.wait")
    assert got["drain_wait_s"] == wait > 0
    assert got["drain_host_s"] == sp.total_s("fastsmc.drain") - wait > 0
    assert got["batcher_s"] == sp.total_s("fastsmc.intake") > 0
    assert got["ckpt_s"] == sp.total_s("fastsmc.checkpoint") > 0
    assert got["writer_fmt_s"] == sp.total_s("fastsmc.writer.format") > 0
    assert got["writer_deflate_s"] == sp.total_s("fastsmc.writer.deflate") > 0
    assert got["scan_thread_s"] == sp.total_s("fastsmc.scan") > 0
    assert got["writer_fmt_s"] == f._writer.spans.total_s(writers.FORMAT)
    # the pool: its threads, the members it wrote, its busy wall
    assert got["writer_workers"] == f._writer.workers >= 1
    assert got["writer_chunks"] == sp.counter(writers.CHUNKS) \
        == sp.stats()["fastsmc.writer.deflate"].count > 0
    assert 0 < got["writer_busy_s"] == sp.counter(writers.BUSY) \
        <= got["writer_fmt_s"] + got["writer_deflate_s"]
    # the run's breakdown: its direct children, inside its wall
    tops = sp.totals()
    assert {"fastsmc.dispatch", "fastsmc.drain", "fastsmc.emit",
            "fastsmc.writer.close"} <= set(tops)
    assert sum(tops.values()) <= sp.total()
    assert "fastsmc.decode.forward" not in tops


def test_profiler_leaves_the_records_unchanged(tiny_panel, repo_root,
                                               tmp_path, monkeypatch):
    """The same job with and without a profiler writes the same
    decompressed .ibd.gz bytes (the gzip header holds a time)."""
    monkeypatch.setattr(pipeline, "CHECKPOINT_DRAINS", 1)
    plain = _fastsmc(tiny_panel, repo_root, str(tmp_path / "a")).run(
        verbose=False)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        traced = _fastsmc(tiny_panel, repo_root, str(tmp_path / "b")).run(
            verbose=False)
    a, b = _decompressed(plain), _decompressed(traced)
    assert a == b and a.count(b"\n") > 0
