"""Smoke run of the PyTorch/CUDA port (fastsmc_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit code:
  1. the card (name, power limit) and the torch/CUDA versions;
  2. build both CUDA kernels from csrc/ with nvcc;
  3. each kernel against its plain PyTorch version on the card, for every
     output the main path uses (alpha; posterior and threshold sums), at a
     main-path shape (T=1024, P=8192) and at a window padded past the
     panel end, with median times from CUDA events;
  4. golden leg: FastSMC(...).run() on artifacts/panels/example_array
     must reproduce the record keys (first 9 columns) of
     tests/fixtures/example_array.golden.FastSMC.ibd.gz in order, with
     float columns within relative 1e-4;
  5. scale leg: the 16,384-haplotype x 6,400-site folded founder-mosaic
     panel (scripts/biobank_probe.py make_panel), batch 8192, min_m 1.5,
     ages on, exact profile, run twice with identical output.
The last line is {"ok": true, "device": {...}}; the line before it lists
the kernels as JSON. Outputs go to build/chip_smoke/ in the checkout.
"""

from __future__ import annotations

import gzip
import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

OUT = os.path.join(REPO, "build", "chip_smoke")
DQ = os.path.join(REPO, "artifacts", "n300.array.decodingQuantities.npz")
EXAMPLE = os.path.join(REPO, "artifacts", "panels", "example_array",
                       "example")
GOLDEN = os.path.join(REPO, "tests", "fixtures",
                      "example_array.golden.FastSMC.ibd.gz")
# kernel vs plain version on the card: f32 sums taken in another order in
# a K=69 product that is renormalised at every site
KERNEL_ATOL = 1e-5
GOLDEN_RTOL = 1e-4
SCALE_HAPS = 16384


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def median_ms(fn, reps: int) -> float:
    """Median wall of ``fn`` on the card, from CUDA events."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def compare_kernels(dec, kernels) -> dict:
    """Phase 3: kernels vs plain versions at two windows; returns per-kernel
    {max_abs_err, ms, plain_ms} (times at the main-path shape)."""
    t = dec.tables
    rng = np.random.default_rng(0)
    P, T = 8192, 1024
    H = t.hap_bits.shape[0]
    ha = rng.integers(0, H, P)
    hb = (ha + 1 + rng.integers(0, H - 1, P)) % H
    outs = kernels.BwdOutputs(posterior=True, threshold_sums=True)
    res = {"hmm_forward": {"max_abs_err": 0.0},
           "hmm_backward": {"max_abs_err": 0.0}}
    for label, t0 in (("main-path", 2048), ("end-of-panel", dec.L - 700)):
        obs, em, ops_f, ops_b, mask = dec.prologue(ha, hb, t0, T)
        real = min(T, dec.L - t0)
        fwd_args = (t.Mf, em, obs, t.isp, ops_f, mask)
        alpha = kernels.forward(*fwd_args)
        alpha_ref = kernels.forward_reference(*fwd_args)
        bwd_args = (t.Mb, em, obs, alpha, ops_b, mask, dec.K, 11, outs)
        got = kernels.backward_combine(*bwd_args)
        want = kernels.backward_combine_reference(*bwd_args)
        torch.cuda.synchronize()
        errs = {"alpha": (alpha - alpha_ref).abs().max().item()}
        for name in ("posterior", "threshold_sums"):
            errs[name] = (got[name] - want[name]).abs().max().item()
        finite = all(bool(torch.isfinite(x).all()) for x in
                     (alpha, got["posterior"], got["threshold_sums"]))
        log(f"[kernels] {label}: t0={t0} T={T} real={real} P={P} "
            f"max|diff| {json.dumps(errs)} finite={finite}")
        if not finite or max(errs.values()) > KERNEL_ATOL:
            raise AssertionError(f"kernel disagrees with its plain version "
                                 f"at {label}: {errs} (atol {KERNEL_ATOL})")
        res["hmm_forward"]["max_abs_err"] = max(
            res["hmm_forward"]["max_abs_err"], errs["alpha"])
        res["hmm_backward"]["max_abs_err"] = max(
            res["hmm_backward"]["max_abs_err"], errs["posterior"],
            errs["threshold_sums"])
        if label == "main-path":
            res["hmm_forward"]["ms"] = median_ms(
                lambda: kernels.forward(*fwd_args), 10)
            res["hmm_forward"]["plain_ms"] = median_ms(
                lambda: kernels.forward_reference(*fwd_args), 3)
            res["hmm_backward"]["ms"] = median_ms(
                lambda: kernels.backward_combine(*bwd_args), 10)
            res["hmm_backward"]["plain_ms"] = median_ms(
                lambda: kernels.backward_combine_reference(*bwd_args), 3)
            log(f"[kernels] median ms at T={T} P={P}: "
                + json.dumps({k: {m: v[m] for m in ("ms", "plain_ms")}
                              for k, v in res.items()}))
        del alpha, alpha_ref, got, want
    return res


def read_records(path: str):
    with gzip.open(path, "rt") as fh:
        return [line.split("\t") for line in fh.read().splitlines()]


def golden_leg(FastSMC, DecodingParams, kernels):
    params = DecodingParams.fastsmc_defaults(
        EXAMPLE, DQ, os.path.join(OUT, "example"), use_known_seed=True)
    kernels.LAUNCHES.clear()
    t0 = time.perf_counter()
    path = FastSMC(params, device="cuda").run(verbose=False)
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    got, want = read_records(path), read_records(GOLDEN)
    if [r[:9] for r in got] != [r[:9] for r in want]:
        raise AssertionError(f"golden leg: record keys differ ({len(got)} "
                             f"records vs {len(want)} in the golden)")
    rel = 0.0
    for g, w in zip(got, want):
        for x, y in zip(g[9:], w[9:]):
            x, y = float(x), float(y)
            rel = max(rel, abs(x - y) / max(abs(y), 1e-30))
    log(f"[golden] {len(got)} records, keys equal in order, float max rel "
        f"{rel:.3g}, wall {wall:.2f} s, launches {launches}")
    if rel > GOLDEN_RTOL:
        raise AssertionError(f"golden leg: float columns off by rel {rel}")
    if min(launches.get(k, 0) for k in ("hmm_forward", "hmm_backward")) < 1:
        raise AssertionError(f"golden leg launched no kernel: {launches}")


def scale_params(DecodingParams, tag: str):
    """The scale leg's configuration: batch 8192, min_m 1.5, the
    reference's default 13-column records (ages on), exact profile."""
    return DecodingParams(
        fastsmc=True, hashing=True, batch_size=8192, in_file_root=OUT,
        out_file_root=os.path.join(OUT, tag), decoding_quant_file=DQ,
        min_m=1.5, use_known_seed=True, output_ibd_segment_length=True,
        do_per_pair_posterior_mean=True, do_per_pair_map=True).finalize()


def scale_leg(FastSMC, DecodingParams, kernels):
    from scripts.biobank_probe import make_panel

    t0 = time.perf_counter()
    data = make_panel(SCALE_HAPS, seed=0)
    log(f"[scale] panel {data.n_haps} haps x {data.sites} sites in "
        f"{time.perf_counter() - t0:.1f} s")
    runs = []
    dq = None
    for i in range(2):
        f = FastSMC(scale_params(DecodingParams, f"scale{i}"), data=data,
                    dq=dq, device="cuda")
        dq = f.dq
        kernels.LAUNCHES.clear()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = f.run(verbose=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with gzip.open(path, "rb") as fh:
            digest = hashlib.sha256(fh.read()).hexdigest()
        row = dict(run="cold" if i == 0 else "warm", wall_s=wall,
                   candidates=f._cpt, records=f.n_segments,
                   candidates_per_s=f._cpt / wall,
                   decoded_site_pairs=f.stats["decoded_site_pairs"],
                   cand_site_pairs=f.stats["cand_site_pairs"],
                   flushes=f.stats["flushes"],
                   max_memory_allocated=torch.cuda.max_memory_allocated(),
                   launches=dict(kernels.LAUNCHES),
                   phase_s=f.timer.totals(), sha256=digest)
        log("[scale] " + json.dumps(row))
        if min(row["launches"].get(k, 0)
               for k in ("hmm_forward", "hmm_backward")) < 1:
            raise AssertionError(f"scale leg launched no kernel: {row}")
        runs.append(row)
        os.remove(path)
    if runs[0]["sha256"] != runs[1]["sha256"] \
            or runs[0]["records"] != runs[1]["records"]:
        raise AssertionError("scale leg: the two runs' outputs differ")
    log("[scale] both runs wrote identical decompressed output")
    return runs[0]["launches"]


def main() -> int:
    # 1. the card
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    log(f"[card] {card_line()}")
    log(f"[card] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} devices {torch.cuda.device_count()}")
    os.makedirs(OUT, exist_ok=True)

    from fastsmc_tpu_torch import DecodingParams, FastSMC
    from fastsmc_tpu_torch.engine import _build, kernels
    from scripts.biobank_probe import make_panel

    # 2. build
    info = _build.build()
    log(f"[build] {info.path.name} in {info.seconds:.1f} s")

    # 3. kernels vs plain versions, on the tables of a 4,096-hap panel
    dec = FastSMC(scale_params(DecodingParams, "kernels"),
                  data=make_panel(4096, seed=1), device="cuda").decoder
    # ptxas' registers and spills of the instantiation this model runs
    tag, fn = f"_kernelILi{dec.tables.KP // 8}E", None
    for line in info.log.splitlines():
        if "Compiling entry function" in line:
            fn = line
        elif fn and tag in fn and ("registers" in line or "spill" in line):
            kind = "forward" if "forward" in fn else "backward"
            log(f"[build] hmm_{kind}_kernel, K={dec.K}: {line.strip()}")
    kres = compare_kernels(dec, kernels)
    del dec

    # 4. golden leg, 5. scale leg
    golden_leg(FastSMC, DecodingParams, kernels)
    launches = scale_leg(FastSMC, DecodingParams, kernels)

    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    rows = []
    for name, src, line in (("hmm_forward", "hmm_forward.cu", 96),
                            ("hmm_backward", "hmm_backward.cu", 185)):
        rows.append(dict(
            name=name, route="cuda",
            source=f"fastsmc_tpu_torch/csrc/{src}",
            replaces=f"fastsmc_tpu/engine/kernels.py:{line}",
            launches=launches.get(name, 0), **kres[name]))
    print(card_line())
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
