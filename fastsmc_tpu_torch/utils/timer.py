"""Spans: named, nested host intervals of a pipeline's run, with self time,
and in a profiled run also ranges in the profiler's trace.

The reference HMM keeps per-phase tick accumulators and prints a
percentage breakdown after decodeAll (HMM.hpp:159-165, HMM.cpp:371-378,
HmmUtils.cpp:96-100); :meth:`SpanRecorder.report` prints that breakdown
from the spans one level under the run's root span.
"""

from __future__ import annotations

import contextlib
import sys
import threading
import time
from typing import Dict, NamedTuple, Optional

import torch


class SpanStat(NamedTuple):
    count: int
    total_s: float
    self_s: float                  # total_s less its nested spans' time
    parents: Dict[Optional[str], int]   # parent name (None: none) -> count


class SpanRecorder:
    """Spans of one pipeline, on every thread that records one.

    ``span(name)`` times a block on ``time.perf_counter_ns``. Each thread
    keeps its own stack: a span's parent is the innermost span open on its
    thread, or the ``parent`` it is given (a span on a worker thread names
    the span that handed it the work). At exit it adds to its name's count,
    total seconds and self seconds, the total less what the spans nested
    in it on its thread cover. While a profiler runs on the calling thread
    the span is also a ``torch.profiler.record_function`` range, so it
    lands in the trace beside the kernels launched inside it, on the
    trace's clock; otherwise it costs two clock reads and one test. A span
    never waits for the device.

    ``root`` names the run's outermost span, whose direct children
    :meth:`totals` and :meth:`report` show."""

    def __init__(self, root: Optional[str] = None):
        self.root = root
        self._local = threading.local()
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        """Forget every span closed so far."""
        with self._lock:
            self.t0 = time.perf_counter_ns()
            self._stats: Dict[str, list] = {}   # [count, ns, self ns, parents]
            self._top: Dict[str, int] = {}      # root's children: ns
            self._counters: Dict[str, float] = {}

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def current(self) -> Optional[str]:
        """The innermost span open on the calling thread, or None."""
        stack = self._stack()
        return stack[-1][0] if stack else None

    @contextlib.contextmanager
    def span(self, name: str, parent: Optional[str] = None):
        stack = self._stack()
        up = stack[-1] if stack else None
        if parent is None and up is not None:
            parent = up[0]
        frame = [name, 0]            # name, ns its nested spans cover
        ranged = torch.profiler.record_function(name) \
            if torch.autograd._profiler_enabled() else None
        if ranged is not None:
            ranged.__enter__()
        stack.append(frame)
        t = time.perf_counter_ns()
        try:
            yield
        finally:
            dt = time.perf_counter_ns() - t
            stack.pop()
            if ranged is not None:
                ranged.__exit__(None, None, None)
            if up is not None:
                up[1] += dt
            with self._lock:
                st = self._stats.get(name)
                if st is None:
                    st = self._stats[name] = [0, 0, 0, {}]
                st[0] += 1
                st[1] += dt
                st[2] += dt - frame[1]
                st[3][parent] = st[3].get(parent, 0) + 1
                if up is not None and up[0] == self.root:
                    self._top[name] = self._top.get(name, 0) + dt

    def stats(self) -> Dict[str, SpanStat]:
        """Each name's closed spans: count, total and self seconds, and
        their parents."""
        with self._lock:
            return {k: SpanStat(c, ns * 1e-9, own * 1e-9, dict(par))
                    for k, (c, ns, own, par) in self._stats.items()}

    def total_s(self, name: str) -> float:
        """Seconds of the closed spans named ``name`` (0 if none)."""
        with self._lock:
            st = self._stats.get(name)
            return st[1] * 1e-9 if st else 0.0

    def add(self, name: str, value: float = 1.0) -> None:
        """Add ``value`` to the counter ``name``: a sum kept beside the
        spans, from any thread, and forgotten with them by :meth:`reset`."""
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + value

    def counter(self, name: str) -> float:
        """The counter ``name`` (0 if never added to)."""
        with self._lock:
            return self._counters.get(name, 0.0)

    def total(self) -> float:
        """Seconds of the root span, or since :meth:`reset` while none has
        closed."""
        with self._lock:
            st = self._stats.get(self.root)
            ns = st[1] if st else time.perf_counter_ns() - self.t0
        return ns * 1e-9

    def totals(self) -> Dict[str, float]:
        """Seconds of each span nested directly in the root on its thread,
        in the order they first closed."""
        with self._lock:
            return {k: ns * 1e-9 for k, ns in self._top.items()}

    def report(self, out="stdout") -> str:
        """Percentage breakdown like asmc::printPctTime (HmmUtils.cpp:96-100)
        of :meth:`totals` over :meth:`total`, the rest as "other".

        Prints to stdout by default (the reference prints after decodeAll);
        pass ``out=None`` to only return the text."""
        total = max(self.total(), 1e-9)
        lines = []
        accounted = 0.0
        for name, v in self.totals().items():
            lines.append(f"Time in {name:<22} : {100.0 * v / total:5.1f}%"
                         f"  ({v:.2f}s)")
            accounted += v
        lines.append(f"Time in {'other':<22} : "
                     f"{100.0 * (total - accounted) / total:5.1f}%"
                     f"  ({total - accounted:.2f}s)")
        text = "\n".join(lines)
        if out is not None:
            print(text, file=sys.stdout if out == "stdout" else out)
        return text
