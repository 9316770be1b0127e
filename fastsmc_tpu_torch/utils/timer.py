"""Phase timing with percentage breakdown (parity feature).

The reference HMM keeps per-phase tick accumulators and prints a
percentage breakdown after decodeAll (HMM.hpp:159-165, HMM.cpp:371-378,
HmmUtils.cpp:96-100). The port's copy of ``fastsmc_tpu/utils/timer.py``:
the same observability for the port's pipelines.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict


class PhaseTimer:
    def __init__(self):
        self.t0 = time.time()
        self.acc: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t = time.time()
        try:
            yield
        finally:
            self.acc[name] = self.acc.get(name, 0.0) + (time.time() - t)

    def total(self) -> float:
        return time.time() - self.t0

    def totals(self) -> Dict[str, float]:
        """Accumulated seconds per phase (copy)."""
        return dict(self.acc)

    def report(self, out="stdout") -> str:
        """Percentage breakdown like asmc::printPctTime (HmmUtils.cpp:96-100).

        Prints to stdout by default (the reference prints after decodeAll);
        pass ``out=None`` to only return the text."""
        import sys
        total = self.total()
        lines = []
        accounted = 0.0
        for name, v in self.acc.items():
            lines.append(f"Time in {name:<14} : {100.0 * v / total:5.1f}%"
                         f"  ({v:.2f}s)")
            accounted += v
        lines.append(f"Time in {'other':<14} : "
                     f"{100.0 * (total - accounted) / total:5.1f}%"
                     f"  ({total - accounted:.2f}s)")
        text = "\n".join(lines)
        if out is not None:
            print(text, file=sys.stdout if out == "stdout" else out)
        return text
