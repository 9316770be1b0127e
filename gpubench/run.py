"""Run one cell of the benchmark of fastsmc_tpu_torch on the local GPU(s).

    python3 gpubench/run.py --workload NAME --seed N --seconds S --trace 0|1

From the root of a checkout. Prints, as the last line of standard output,
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and last ``check``: each
number compared with the plain reference beside its limit (also the last
lines of standard error). Exits non-zero, printing no result, without
CUDA or with fewer cards than the cell asks for, and if JAX or the JAX
package is loaded when the window has closed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# top-level module names the process may not hold (compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "fastsmc_tpu")


def process_start() -> float:
    """The process's start on the ``time.time()`` clock (from
    /proc/self/stat; now, where that cannot be read)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return time.time() - (up - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


T_START = process_start()


def set_cache_dirs() -> None:
    """Every compiler and kernel cache at a fixed path in the checkout:
    the program builds its kernels under build/ there itself."""
    cache = ROOT / "build" / "gpubench"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(cache / sub)
    os.environ["USE_FLAX"] = "0"


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_cache_dirs()
    sys.path.insert(0, str(ROOT))
    from gpubench import harness
    cell = harness.load_cell(args.workload)

    import torch
    chips = int(cell.workload["chips"])
    seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if seen < chips:
        print(f"needs {chips} CUDA device(s); torch sees {seen}",
              file=sys.stderr)
        return 2
    import fastsmc_tpu_torch as sut

    with tempfile.TemporaryDirectory(prefix="gpubench-") as work:
        res = harness.run_cell(cell, args.seed, args.seconds,
                               bool(args.trace), "cuda", T_START, sut, work)
    bad = forbidden_modules()
    if bad:
        print(f"the process holds {bad}", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips, "memory_peak_bytes": res["memory_peak_bytes"],
              "power_limit_w": power_limit()}
    if args.trace:
        device.update(busy_s=res["busy_s"], window_s=res["window_s"])
    line = {"correct": res["correct"], "attempted": res["attempted"],
            "failed": res["failed"], "metrics": res["metrics"],
            "device": device}
    if args.trace:
        line["breakdown"] = res["breakdown"]
    line["check"] = res["check"]
    for k, v in res["check"].items():
        print(f"check {k} = {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


def power_limit():
    """The card's power limit in watts, from nvidia-smi; None where it
    cannot be read."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30, check=True).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


if __name__ == "__main__":
    sys.exit(main())
