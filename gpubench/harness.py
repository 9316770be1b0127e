"""The benchmark's run of one cell: set-up, the measured window, the
per-layer readings, and the check of what the window produced.

Everything that belongs to one configuration, traffic mix or metric lives
in a file of its own, found by its name in ``BENCHMARK.json``:
``gpubench/configs/<config>.json`` (named by the configuration's
``file``), ``gpubench/traffic/<traffic>.json`` and
``gpubench/metrics/<metric>.py`` (a ``read(run)`` that returns the
metric's value, or None where the run holds nothing to read).
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import hashlib
import importlib.util
import itertools
import json
import os
import shutil
import sys
import tempfile
import time
import traceback
from pathlib import Path
from typing import Optional

import numpy as np

from . import checks, entries, panel as panel_mod, trace as trace_mod
from .reference.model import build_model, round_morgans

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict       # the BENCHMARK.json entry
    config: dict         # the configuration file
    traffic: dict        # the traffic file
    end_to_end: list     # BENCHMARK.json metric entries the cell reports
    per_layer: list


def load_cell(name: str) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files."""
    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(ROOT / conf["file"]) as f:
        config = json.load(f)
    with open(HERE / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m
                 else m["moves"] in reported)]
    return Cell(name, w, config, traffic, e2e, layer)


def load_reader(metric: str):
    """``read`` of ``gpubench/metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "gpubench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Recorder:
    """The benchmark's spans: host-clock intervals, and in a traced run
    also ``record_function`` ranges named ``gpubench.<name>``."""

    def __init__(self, traced: bool):
        self.traced = traced
        self.spans = []

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        ctx = contextlib.nullcontext()
        if self.traced:
            import torch
            ctx = torch.profiler.record_function("gpubench." + name)
        t0 = time.perf_counter()
        with ctx:
            yield
        self.spans.append(dict(name=name, start=t0,
                               end=time.perf_counter(), **attrs))


@dataclasses.dataclass
class Env:
    """What every job of the run shares: the program's inputs."""
    config: dict
    data: object          # the program's Data of the panel
    dq: object            # the program's DecodingQuantities
    dq_path: str
    device: str


@dataclasses.dataclass
class Run:
    """What the metric readers read."""
    cell: Cell
    seed: int
    setup_s: float
    jobs: list            # per job: job, pairs, batches, start, end, ...
    spans: list
    window_s: float
    shapes: dict          # T, K, G, mode, profile, outputs
    memory_peak_bytes: int
    trace: Optional[dict] = None

    def spans_named(self, name: str) -> list:
        return [s for s in self.spans if s["name"] == name]


def checked_file(rel: str, sha256: str) -> str:
    """The repository file ``rel``, checked against the digest that a
    configuration or traffic file states for it."""
    path = ROOT / rel
    digest = hashlib.sha256(path.read_bytes()).hexdigest()
    if digest != sha256:
        raise RuntimeError(f"{path} has sha256 {digest}, the benchmark "
                           f"states {sha256}")
    return str(path)


def dq_file(config: dict) -> str:
    """The configuration's decoding-quantities file."""
    spec = config["decoding_quantities"]
    return checked_file(spec["path"], spec["sha256"])


def program_data(sut, pan: panel_mod.Panel):
    """The program's ``Data`` of the panel: its bits, map and counts as
    the file loader would give them (folded, known seed)."""
    H, L = pan.haplotypes, pan.sites
    n = H // 2
    return sut.io.haps.Data(
        sites=L, sample_size=n,
        fam_id_list=[f"f{i}" for i in range(n)],
        iid_list=[f"s{i}" for i in range(n)],
        hap_bits=pan.bits.cpu().numpy(),
        genetic_positions=pan.genetic_positions,
        physical_positions=pan.physical_positions,
        rec_rate_at_marker=np.zeros(L),
        snp_ids=[f"snp{i}" for i in range(L)],
        derived_allele_counts=pan.dac,
        total_samples_count=np.full(L, H, np.int32),
        site_was_flipped=pan.flipped,
        chr_number=1, windows=None,
        fold_to_minor=True, decoding_uses_csfs=True, use_known_seed=True)


def panel_spec(cell: Cell) -> dict:
    """The panel: the configuration's sizes, the traffic's statistics and
    its founders' files."""
    cfg = cell.config
    spec = dict(cell.traffic["panel"], haplotypes=2 * int(cfg["samples"]),
                sites=int(cfg["sites"]))
    if "morgans" in cfg:
        spec["morgans"] = float(cfg["morgans"])
    f = spec["founders"]
    spec.update(hap_path=checked_file(f["haps"], f["haps_sha256"]),
                map_path=checked_file(f["map"], f["map_sha256"]))
    return spec


def _shapes(cell: Cell, pan, dq) -> dict:
    cfg = cell.config
    p = cfg["params"]
    g32 = np.asarray(pan.genetic_positions, np.float32)
    G = len(np.unique(round_morgans(g32[1:] - g32[:-1]))) + 1
    if cfg["entry"] == "asmc":
        outs = dict(posterior_sums=p.get("do_posterior_sums", False),
                    major_minor_sums=p.get("do_major_minor_posterior_sums",
                                           False))
    else:
        outs = dict(threshold_sums=True,
                    posterior=p.get("do_per_pair_posterior_mean", False)
                    or p.get("do_per_pair_map", False))
    return dict(T=pan.sites, K=int(dq.states), G=G,
                seq=p.get("decoding_mode", "array") == "sequence",
                profile=cfg["decode_profile"], outputs=outs)


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool,
             device: str, t_start: float, sut, workdir: str) -> dict:
    """One run: set-up, the window, the readings, the check. Returns the
    result's fields (``correct``, ``attempted``, ``failed``, ``metrics``,
    ``memory_peak_bytes``, ``busy_s``/``window_s``/``breakdown`` when
    traced, ``check``)."""
    import torch
    cfg, traffic = cell.config, cell.traffic
    run_job = entries.ENTRIES[cfg["entry"]]
    dq_path = dq_file(cfg)
    t0 = time.time()
    pan = panel_mod.make_panel(panel_spec(cell), seed, device)
    dq = sut.io.decoding_quantities.DecodingQuantities.load(dq_path)
    env = Env(cfg, program_data(sut, pan), dq, dq_path, device)
    jobs_n = int(cfg["jobs"])
    out_dir = tempfile.mkdtemp(prefix="jobs-", dir=workdir)
    rec = Recorder(traced)

    # warm-up: a job of one whole batch, through the same calls
    t1 = time.time()
    warm = traffic["warmup"]
    w = run_job(sut, env, int(warm["job"]), os.path.join(out_dir, "warm"),
                Recorder(False), int(warm["jobs"]))
    entries.remove_outputs(w)
    if device.startswith("cuda"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.time() - t_start
    print(f"setup {setup_s:.3f} s: to the panel {t0 - t_start:.3f}, panel "
          f"and inputs {t1 - t0:.3f}, warm-up job {time.time() - t1:.3f}",
          file=sys.stderr, flush=True)

    order = panel_mod.job_sequence(jobs_n, seed)
    jobs, failed = [], 0
    with trace_mod.profiled(traced) as prof:
        with rec.span("window"):
            t0 = time.perf_counter()
            # the job list again from its start where the window outlasts it
            for k, j in enumerate(itertools.cycle(order)):
                if time.perf_counter() - t0 >= seconds:
                    break
                root = os.path.join(out_dir, f"job{k}")
                start = time.perf_counter()
                try:
                    job = run_job(sut, env, j, root, rec, jobs_n)
                except Exception:           # counted, and the run fails
                    failed += 1
                    traceback.print_exc()
                    break
                job.update(job=j, start=start, end=time.perf_counter())
                jobs.append(job)
                print(f"job {j}: {job['pairs']} pairs in "
                      f"{job['end'] - start:.3f} s {job['counters']}",
                      file=sys.stderr, flush=True)
    peak = int(torch.cuda.max_memory_allocated()) \
        if device.startswith("cuda") else 0
    window_s = jobs[-1]["end"] - jobs[0]["start"] if jobs else 0.0
    summary = trace_mod.summarize(prof, workdir) if prof is not None \
        else None
    run = Run(cell, seed, setup_s, jobs, rec.spans, window_s,
              _shapes(cell, pan, dq), peak, summary)
    names = cell.per_layer if traced else cell.end_to_end
    metrics = {}
    for m in names:
        v = load_reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    # the check: the program's state goes first, then the reference
    del env, w
    gc.collect()
    if device.startswith("cuda"):
        torch.cuda.empty_cache()
    check = {}
    if jobs:
        rng = np.random.default_rng(panel_mod.seeds(seed, 3)[2])
        job = jobs[int(rng.integers(len(jobs)))]
        model = build_model(dq_path, pan.genetic_positions, pan.dac,
                            np.full(pan.sites, pan.haplotypes), 1234,
                            device)
        check = checks.CHECKS[cfg["entry"]](cell, pan, model, job, jobs_n,
                                            rng)
    for job in jobs:
        entries.remove_outputs(job)
    shutil.rmtree(out_dir, ignore_errors=True)
    limits = cfg["check"]["limits"]
    got = {k: float(check.get(k, float("nan"))) for k in limits}
    correct = bool(jobs) and failed == 0 and all(
        np.isfinite(v) and v <= limits[k] for k, v in got.items())
    out = dict(correct=correct, attempted=len(jobs) + failed, failed=failed,
               metrics=metrics, memory_peak_bytes=peak,
               check={k: {"value": v, "limit": float(limits[k])}
                      for k, v in got.items()})
    if summary is not None:
        out.update(busy_s=summary["busy_s"], window_s=summary["window_s"],
                   breakdown={"device_ops": summary["device_ops"],
                              "idle_gaps": summary["idle_gaps"]})
    return out
