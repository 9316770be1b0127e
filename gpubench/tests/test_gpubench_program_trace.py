"""The reduction of the program's spans in a trace (gpubench.program_trace)
on synthetic chrome-trace events: idle time cut at the program's span
edges and put down to the innermost span, device time put down to the span
around its launch, the window's thread only, and the readings; and the
summary of gpubench.trace unchanged by the program's spans."""

import copy

import pytest

from gpubench.program_trace import NONE, by_span, readings
from gpubench.trace import summarize_events

MAIN = dict(pid=1, tid=7)


def ann(name, ts, dur, **where):
    return dict(cat="user_annotation", name=name, ts=ts, dur=dur,
                **(where or MAIN))


def dev(name, ts, dur, corr, cat="kernel"):
    return dict(cat=cat, name=name, ts=ts, dur=dur, pid=0, tid=9,
                args={"correlation": corr})


def launch(ts, corr, cat="cuda_runtime"):
    return dict(cat=cat, name="cudaLaunchKernel", ts=ts, dur=1.0, **MAIN,
                args={"correlation": corr})


def job_events():
    """A window [0, 1000) over one job: run [10, 990) holding a dispatch
    [20, 120) with a forward [30, 60), a drain [200, 400) with its wait
    [200, 300), an emit [400, 450) and the writer's close [500, 980); a
    kernel launched in the forward, a copy in the dispatch, a kernel in
    the drain after its wait, and one whose launch the trace lacks."""
    return [
        ann("gpubench.window", 0.0, 1000.0),
        ann("gpubench.fastsmc.run", 5.0, 990.0),
        ann("fastsmc.run", 10.0, 980.0),
        ann("fastsmc.dispatch", 20.0, 100.0),
        ann("fastsmc.decode.forward", 30.0, 30.0),
        ann("fastsmc.drain", 200.0, 200.0),
        ann("fastsmc.drain.wait", 200.0, 100.0),
        ann("fastsmc.emit", 400.0, 50.0),
        ann("fastsmc.writer.close", 500.0, 480.0),
        launch(35.0, 1), dev("fwd", 100.0, 200.0, 1),    # busy [100, 300)
        launch(70.0, 2), dev("Memcpy DtoH", 300.0, 20.0, 2, "gpu_memcpy"),
        launch(350.0, 3), dev("unpack", 600.0, 100.0, 3),
        dev("orphan", 900.0, 10.0, 99),                   # no launch seen
    ]


def test_idle_is_cut_at_span_edges_and_goes_to_the_innermost():
    prog = by_span(job_events())
    idle = {k: v["idle_s"] * 1e6 for k, v in prog.items()}
    # busy [100, 320) [600, 700) [900, 910); idle [0, 100) [320, 600)
    # [700, 900) [910, 1000)
    assert idle[NONE] == pytest.approx(10 + 10)        # [0, 10) [990, 1000)
    assert idle["fastsmc.run"] == pytest.approx(10 + 50 + 10)
    assert idle["fastsmc.dispatch"] == pytest.approx(10 + 40)
    assert idle["fastsmc.decode.forward"] == pytest.approx(30)
    assert idle["fastsmc.drain"] == pytest.approx(80)  # [320, 400)
    assert idle["fastsmc.drain.wait"] == 0             # the card was busy
    assert idle["fastsmc.emit"] == pytest.approx(50)
    assert idle["fastsmc.writer.close"] == pytest.approx(100 + 200 + 70)
    s = summarize_events(job_events())
    assert sum(idle.values()) * 1e-6 == pytest.approx(
        s["window_s"] - s["busy_s"])


def test_device_time_goes_to_the_span_around_its_launch():
    prog = by_span(job_events())
    dev_s = {k: v["device_s"] * 1e6 for k, v in prog.items()
             if v["device_s"]}
    assert dev_s == pytest.approx({"fastsmc.decode.forward": 200.0,
                                   "fastsmc.dispatch": 20.0,
                                   "fastsmc.drain": 100.0, NONE: 10.0})
    host = {k: (v["host_s"] * 1e6, v["count"]) for k, v in prog.items()}
    assert host["fastsmc.drain"] == (pytest.approx(200.0), 1)
    assert host[NONE] == (0.0, 0)
    # a CUDA driver API launch counts as a runtime one: the unpack's launch
    # moved into the forward
    ev = job_events()
    ev[-3] = launch(40.0, 3, "cuda_driver")
    assert by_span(ev)["fastsmc.decode.forward"]["device_s"] == \
        pytest.approx(300e-6)


def test_other_threads_and_the_benchmarks_spans_are_not_the_programs():
    ev = job_events() + [ann("fastsmc.writer.format", 500.0, 400.0, pid=1,
                             tid=8)]
    prog = by_span(ev)
    assert "fastsmc.writer.format" not in prog
    assert not any(k.startswith("gpubench.") for k in prog)
    assert prog == by_span(job_events())


def test_the_summary_is_the_same_with_the_programs_spans():
    """summarize_events gives the same readings whether or not the trace
    holds the program's spans: they are not the benchmark's."""
    ev = job_events()
    plain = [e for e in ev if not e["name"].startswith("fastsmc.")]
    assert summarize_events(copy.deepcopy(ev)) == summarize_events(plain)


def test_readings_per_job_and_absent_without_the_programs_spans():
    prog = by_span(job_events())
    got = readings(prog, 2)
    assert got["fastsmc.idle_writer_s_per_job"] == pytest.approx(
        (50 + 370) * 1e-6 / 2)
    assert got["fastsmc.idle_drain_s_per_job"] == pytest.approx(
        (50 + 30 + 80) * 1e-6 / 2)
    assert got["fastsmc.idle_unattributed_pct"] == pytest.approx(
        100 * (20 + 70) / 670)
    assert "fastsmc.idle_setup_s_per_job" not in got   # no init span
    assert "fastsmc.extract_device_s_per_job" not in got
    # a program without spans (the parent of this reduction) reads nothing
    parent = [e for e in job_events()
              if not e["name"].startswith("fastsmc.")]
    assert readings(by_span(parent), 2) == {}
    with_init = job_events() + [ann("fastsmc.init", 0.0, 8.0),
                                ann("fastsmc.extract", 34.0, 2.0)]
    got = readings(by_span(with_init), 1)
    assert got["fastsmc.idle_setup_s_per_job"] == pytest.approx(8e-6)
    assert got["fastsmc.extract_device_s_per_job"] == pytest.approx(200e-6)


def test_no_window_raises():
    with pytest.raises(RuntimeError):
        by_span([ann("fastsmc.run", 0.0, 1.0)])
