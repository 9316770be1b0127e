"""The control of a cell's check: the plain reference computed in TF32 put
in the program's place, at the cell's own size, on the given seeds.

    python3 gpubench/control.py --workload NAME --seeds 11,12,13

For each seed: the run's panel and its first job, and the numbers the
cell's check compares (``checks.CONTROLS``) with the control's outputs in
place of the program's; one JSON line a seed. The benchmark's runs never
run it; its readings set the upper end of each limit (PERF.md).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def control(cell, seed: int, device: str) -> dict:
    import numpy as np
    from gpubench import checks, harness, panel
    from gpubench.reference.model import build_model
    pan = panel.make_panel(harness.panel_spec(cell), seed, device)
    model = build_model(harness.dq_file(cell.config), pan.genetic_positions,
                        pan.dac, np.full(pan.sites, pan.haplotypes), 1234,
                        device)
    jobs = int(cell.config["jobs"])
    job = panel.job_sequence(jobs, seed)[0]
    rng = np.random.default_rng(panel.seeds(seed, 3)[2])
    return checks.CONTROLS[cell.config["entry"]](cell, pan, model, jobs,
                                                 job, rng)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from gpubench import harness
    cell = harness.load_cell(args.workload)
    limits = cell.config["check"]["limits"]
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.time()
        got = control(cell, seed, args.device)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "seconds": time.time() - t0,
                          "fails": [k for k in limits
                                    if not got[k] <= limits[k]],
                          **got}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
