"""The device trace of a run's window: ``torch.profiler`` over the window,
reduced to device time by kernel name, the device's busy time, and what
the host was doing in the device's idle gaps.

The benchmark's spans are ``record_function`` ranges named ``gpubench.*``
in the same trace; the window itself is ``gpubench.window``. Device
operations are the trace's kernels, copies and memsets, clipped to the
window; busy time is the length of their union.
"""

from __future__ import annotations

import contextlib
import json
import os

WINDOW = "gpubench.window"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def profiled(enabled: bool):
    """A CPU and CUDA ``torch.profiler.profile`` when ``enabled``, else
    nothing; yields the profiler or None."""
    if not enabled:
        yield None
        return
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        yield prof


def _union(intervals):
    """Sorted, merged [start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _short(name: str) -> str:
    """A kernel's name without its return type, anonymous namespaces and
    parameter list, at most 96 characters."""
    name = name.replace("(anonymous namespace)::", "")
    cut = name.find("(")
    name = name if cut < 0 else name[:cut]
    return (name[5:] if name.startswith("void ") else name).strip()[:96]


def summarize(prof, workdir: str) -> dict:
    """``busy_s``, ``window_s``, ``device_s`` (seconds by operation name as
    the trace gives it),
    ``device_ops`` and ``idle_gaps`` (the ten largest, [name, seconds]) of
    the traced window; ``device_s`` empty where the trace holds no device
    operation."""
    path = os.path.join(workdir, "trace.json")
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.remove(path)
    return summarize_events(events)


def summarize_events(events: list) -> dict:
    """:func:`summarize` of a chrome trace's ``traceEvents``."""
    spans, device = [], []
    for e in events:
        if "ts" not in e or "dur" not in e:
            continue
        s, d = float(e["ts"]), float(e["dur"])
        if e.get("cat") == "user_annotation" \
                and str(e.get("name", "")).startswith("gpubench."):
            spans.append((s, s + d, e["name"]))
        elif e.get("cat") in _DEVICE_CATS:
            device.append((s, s + d, str(e.get("name", "?"))))
    win = [x for x in spans if x[2] == WINDOW]
    if not win:
        raise RuntimeError("the trace holds no window span")
    w0, w1 = win[0][0], win[0][1]
    by_name, shown = {}, {}
    clipped = []
    for s, e, name in device:
        s, e = max(s, w0), min(e, w1)
        if e > s:
            clipped.append((s, e))
            by_name[name] = by_name.get(name, 0.0) + (e - s) * 1e-6
            short = _short(name)
            shown[short] = shown.get(short, 0.0) + (e - s) * 1e-6
    busy = _union(clipped)
    busy_s = sum(e - s for s, e in busy) * 1e-6
    # idle gaps, cut at the spans' ends, each piece put down to the
    # innermost span around it
    inner = [x for x in spans if x[2] != WINDOW]
    cuts = sorted({x for sp in inner for x in sp[:2]})
    gaps = {}
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for s, e in zip(edges[::2], edges[1::2]):
        pts = [s] + [c for c in cuts if s < c < e] + [e]
        for a, b in zip(pts, pts[1:]):
            mid = 0.5 * (a + b)
            around = [x for x in inner if x[0] <= mid < x[1]]
            label = min(around, key=lambda x: x[1] - x[0])[2] if around \
                else "gpubench.between_spans"
            gaps[label] = gaps.get(label, 0.0) + (b - a) * 1e-6
    top = sorted(shown.items(), key=lambda kv: -kv[1])[:10]
    return dict(busy_s=busy_s, window_s=(w1 - w0) * 1e-6, device_s=by_name,
                device_ops=[[k, v] for k, v in top],
                idle_gaps=[[k, v] for k, v in
                           sorted(gaps.items(), key=lambda kv: -kv[1])[:10]])
