"""The arithmetic the metric files share: per-job means of spans and
counters, and the kernels' shares of their bounds from the trace."""

from __future__ import annotations

from .yardstick import decode_bound


def pairs_per_s(run):
    """Pairs of the completed jobs over the wall from the first job's
    start to the last one's end."""
    if not run.jobs or run.window_s <= 0:
        return None
    return sum(j["pairs"] for j in run.jobs) / run.window_s


def span_s_per_job(run, name: str):
    spans = run.spans_named(name)
    return sum(s["end"] - s["start"] for s in spans) / len(spans) \
        if spans else None


def counter_per_job(run, *names: str):
    vals = [sum(j["counters"][n] for n in names) for j in run.jobs
            if all(n in j["counters"] for n in names)]
    return sum(vals) / len(vals) if vals else None


def _need_s(run, kernel: str, key: str) -> float:
    sh = run.shapes
    return 1e-3 * sum(
        decode_bound(kernel, sh["T"], P, sh["K"], sh["G"], sh["seq"],
                     sh["profile"], sh["outputs"])[key]
        for job in run.jobs for P in job["batches"])


def roofline_pct(run, kernel: str, names: tuple):
    """The least time of the window's decodes of ``kernel`` ("forward" or
    "backward") over the device time of the trace's operations whose name
    holds one of ``names``, in percent."""
    if run.trace is None or not run.jobs:
        return None
    t = sum(v for k, v in run.trace["device_s"].items()
            if any(n in k for n in names))
    return 100.0 * _need_s(run, kernel, "ms") / t if t > 0 else None


def step_mfu_pct(run):
    """The window's decode operations at the card's peaks (the forward's
    3xTF32 products at the TF32 peak, the exact backward's at the FP32
    peak) over the window's wall, in percent."""
    if run.trace is None or run.window_s <= 0 or not run.trace["device_s"]:
        return None
    need = _need_s(run, "forward", "op_ms") + _need_s(run, "backward",
                                                      "op_ms")
    return 100.0 * need / run.window_s


def idle_pct(run):
    tr = run.trace
    if tr is None or tr["window_s"] <= 0 or not tr["device_s"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def peak_gib(run):
    return run.memory_peak_bytes / 2 ** 30 if run.memory_peak_bytes else None
