"""The program's own spans in a traced window: the card's time by the
``fastsmc.*`` span that launched the work, and the card's idle time by the
``fastsmc.*`` span the host was in.

``fastsmc_tpu_torch`` opens a ``torch.profiler.record_function`` range for
each span of a FastSMC job while a profiler runs on the calling thread
(``fastsmc_tpu_torch.utils.timer``), so the spans of the thread that runs
the job lie in the trace beside the kernels, on its clock. The harness
keeps no trace events for the metric readers, so no metric of
``BENCHMARK.json`` reads this reduction yet. :func:`main` runs one cell as
``gpubench/run.py --trace 1`` does and prints the reduction and its
per-job readings as one more JSON line after the result line:

    python3 gpubench/program_trace.py --workload NAME --seed N --seconds S
"""

from __future__ import annotations

import bisect
import json
import sys
from pathlib import Path

PREFIX = "fastsmc."
NONE = "none"            # the card's time under no program span
# the host calls that queue device work; their args.correlation names it
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")

# spans whose idle the readings add up ("with their children": the decode
# and extraction spans open only inside dispatch or a redo)
WRITER = ("fastsmc.emit", "fastsmc.checkpoint", "fastsmc.writer.close")
DRAIN = ("fastsmc.intake", "fastsmc.dispatch", "fastsmc.drain",
         "fastsmc.drain.wait", "fastsmc.drain.redo",
         "fastsmc.decode.prologue", "fastsmc.decode.forward",
         "fastsmc.decode.backward", "fastsmc.extract")
SETUP = ("fastsmc.init",)


def _innermost(spans):
    """The sorted edges of nested ``spans`` ([start, end, name]) and the
    name of the innermost span over each piece between two edges."""
    pts = sorted({x for s, e, _ in spans for x in (s, e)})
    order = sorted(spans, key=lambda x: (x[0], -x[1]))
    labels, live, k = [], [], 0
    for a in pts[:-1]:
        while k < len(order) and order[k][0] <= a:
            live.append(order[k])
            k += 1
        live = [x for x in live if x[1] > a]
        labels.append(live[-1][2] if live else NONE)
    return pts, labels


def _label_at(pts, labels, t: float) -> str:
    i = bisect.bisect_right(pts, t) - 1
    return labels[i] if 0 <= i < len(labels) else NONE


def by_span(events: list) -> dict:
    """``{span: {"idle_s", "device_s", "host_s", "count"}}`` of the
    ``gpubench.window`` span of a chrome trace's ``traceEvents``, over the
    ``fastsmc.*`` spans of the window's thread. ``idle_s``: the window's
    time with no kernel, copy or memset on the card (as
    ``trace.summarize_events`` counts it), cut at the spans' edges, each
    piece put down to the innermost span around it; ``device_s``: each
    device operation's time in the window put down to the innermost span
    around its launch (the CUDA runtime or driver API call with its
    ``args.correlation``); ``host_s`` and ``count``: the spans' time in the
    window and their number. Time under no span goes to ``"none"``."""
    from gpubench.trace import _DEVICE_CATS, WINDOW, _union
    win = next((e for e in events if e.get("cat") == "user_annotation"
                and e.get("name") == WINDOW and "ts" in e and "dur" in e),
               None)
    if win is None:
        raise RuntimeError("the trace holds no window span")
    w0 = float(win["ts"])
    w1 = w0 + float(win["dur"])
    thread = (win.get("pid"), win.get("tid"))
    spans, device, launch = [], [], {}
    for e in events:
        if "ts" not in e:
            continue
        cat, args = e.get("cat"), e.get("args") or {}
        if cat in _LAUNCH_CATS and "correlation" in args:
            launch[args["correlation"]] = float(e["ts"])
        if "dur" not in e:
            continue
        s, d = float(e["ts"]), float(e["dur"])
        if cat == "user_annotation" \
                and str(e.get("name", "")).startswith(PREFIX) \
                and (e.get("pid"), e.get("tid")) == thread:
            spans.append((s, s + d, e["name"]))
        elif cat in _DEVICE_CATS:
            device.append((s, s + d, args.get("correlation")))
    out = {}

    def add(name, key, value):
        row = out.setdefault(name, dict(idle_s=0.0, device_s=0.0,
                                        host_s=0.0, count=0))
        row[key] += value

    add(NONE, "count", 0)
    for s, e, name in spans:
        s, e = max(s, w0), min(e, w1)
        if e > s:
            add(name, "host_s", (e - s) * 1e-6)
            add(name, "count", 1)
    pts, labels = _innermost(spans)
    clipped = []
    for s, e, corr in device:
        s, e = max(s, w0), min(e, w1)
        if e > s:
            clipped.append((s, e))
            at = launch.get(corr)
            add(NONE if at is None else _label_at(pts, labels, at),
                "device_s", (e - s) * 1e-6)
    edges = [w0] + [x for iv in _union(clipped) for x in iv] + [w1]
    for s, e in zip(edges[::2], edges[1::2]):
        cut = pts[bisect.bisect_right(pts, s):bisect.bisect_left(pts, e)]
        bounds = [s] + cut + [e]
        for a, b in zip(bounds, bounds[1:]):
            add(_label_at(pts, labels, 0.5 * (a + b)), "idle_s",
                (b - a) * 1e-6)
    return out


def _sum(program: dict, names, key: str):
    """The spans' ``key`` added up, or None where none of them is in the
    trace (a program without these spans)."""
    if not any(n in program for n in names):
        return None
    return sum(program[n][key] for n in names if n in program)


def readings(program: dict, jobs: int) -> dict:
    """Per-job means over the window's ``jobs`` of :func:`by_span`'s
    ``program``: the card's idle time under the IBD writer's spans, under
    intake, dispatch and the drain, and under the constructor; the device
    time launched under extraction; and the idle time under no span or in
    ``fastsmc.run``'s own time as a share of all idle time, in percent.
    Readings whose spans are absent are left out."""
    out = {}
    if jobs > 0:
        for name, names, key in (
                ("fastsmc.idle_writer_s_per_job", WRITER, "idle_s"),
                ("fastsmc.idle_drain_s_per_job", DRAIN, "idle_s"),
                ("fastsmc.idle_setup_s_per_job", SETUP, "idle_s"),
                ("fastsmc.extract_device_s_per_job", ("fastsmc.extract",),
                 "device_s")):
            v = _sum(program, names, key)
            if v is not None:
                out[name] = v / jobs
    idle = sum(v["idle_s"] for v in program.values())
    if "fastsmc.run" in program and idle > 0:
        out["fastsmc.idle_unattributed_pct"] = 100.0 * (
            program[NONE]["idle_s"] + program["fastsmc.run"]["idle_s"]) \
            / idle
    return out


def main(argv=None) -> int:
    """``gpubench/run.py``'s main with ``--trace 1``, the trace's summary
    given :func:`by_span` under ``"program"``; then one JSON line:
    ``program``, ``readings``, ``jobs``, ``pairs_per_s`` (of the traced
    window), ``window_s``, ``busy_s`` and ``idle_s`` (the pieces added
    up, to set beside ``window_s - busy_s``)."""
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from gpubench import harness, run, trace
    from gpubench.readings import pairs_per_s
    seen = {}
    summarize_events = trace.summarize_events
    load_reader = harness.load_reader

    def with_program(events):
        summary = summarize_events(events)
        summary["program"] = by_span(events)
        return summary

    def keeping_run(name):
        read = load_reader(name)

        def keep(r):
            seen["run"] = r
            return read(r)
        return keep

    trace.summarize_events = with_program
    harness.load_reader = keeping_run
    args = list(sys.argv[1:] if argv is None else argv)
    rc = run.main(args + ["--trace", "1"])
    r = seen.get("run")
    if rc or r is None or r.trace is None:
        return rc or 1
    prog = r.trace["program"]
    print(json.dumps(dict(
        program=prog, readings=readings(prog, len(r.jobs)),
        jobs=len(r.jobs), pairs_per_s=pairs_per_s(r),
        window_s=r.trace["window_s"], busy_s=r.trace["busy_s"],
        idle_s=sum(v["idle_s"] for v in prog.values()))), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from gpubench.program_trace import main as _main
    sys.exit(_main())
