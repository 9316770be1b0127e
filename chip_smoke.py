"""Smoke run of the PyTorch/CUDA port (fastsmc_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit code:
  1. the card (name, power limit) and the torch/CUDA versions;
  2. build the three CUDA sources from csrc/ with nvcc, one process each;
  3. each kernel against its plain PyTorch version on the card: the forward
     kernel (alpha) and the backward kernel with all six outputs, at a
     main-path shape (T=1024, P=8192), at a window padded past the panel
     end and with P=8187 (dead lanes in the last 32-pair block); the block
     reduction on the backward kernel's partials; median times from CUDA
     events, per backward output; then the forward kernel and the backward
     kernel with the two sums at the ASMC scale leg's batches (the whole
     chromosome's T=8192 window, P=8192 and the last batch's P=3137),
     against their plain versions;
  4. FastSMC golden leg: FastSMC(...).run() on artifacts/panels/
     example_array must reproduce the record keys (first 9 columns) of
     tests/fixtures/example_array.golden.FastSMC.ibd.gz in order, with
     float columns within relative 1e-4;
  5. FastSMC scale leg: the 16,384-haplotype x 6,400-site folded
     founder-mosaic panel (scripts/biobank_probe.py make_panel), batch
     8192, min_m 1.5, ages on, exact profile, run twice with identical
     output;
  6. ASMC golden leg: the sums of pairs 2,691..3,138 (jobs=100, job 7) of
     the example panel must reproduce the JAX-made
     tests/fixtures/example_array.asmc_job7of100.npz within 1e-5 per pair;
  7. ASMC per-pair leg: the example panel's 150 within-sample pairs stream
     posterior means and MAP states; for three pairs they must agree with
     the decode_pairs API, which reads the kernel's posterior output;
  8. ASMC scale leg: the scale panel, jobs=1000, job 1 (134,209 pairs),
     batch 8192, posterior sums and major/minor sums, run twice with
     byte-identical .sumOverPairs.gz outputs;
  9. FastSMC without hashing: the example panel, jobs=25, job 1 (1,794
     pairs); and jobs=400, job 1 (112 pairs) on the card against the plain
     versions on the CPU: the same records, floats within relative 1e-4.
Each leg clears the launch counts before it runs and fails unless every
kernel of its path was launched. The last line is {"ok": true, "device":
{...}}; the line before it lists the kernels as JSON. Outputs go to
build/chip_smoke/ in the checkout.
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
ASMC_GOLDEN = os.path.join(REPO, "tests", "fixtures",
                           "example_array.asmc_job7of100.npz")
# kernel vs plain version on the card: f32 sums taken in another order in
# a K=69 product that is renormalised at every site; sums over P pairs
# get 1e-5 per pair, posterior means (in generations) 1e-5 times the
# largest expected time, and MAP states may differ only at ties within
# KERNEL_ATOL
KERNEL_ATOL = 1e-5
GOLDEN_RTOL = 1e-4
SCALE_HAPS = 16384
SUMS = ("sum_over_pairs", "sum_over_pairs00", "sum_over_pairs01",
        "sum_over_pairs11")
ASMC_KERNELS = ("hmm_forward", "hmm_backward", "hmm_block_reduce")
DECODE_KERNELS = ("hmm_forward", "hmm_backward")


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


def run_leg(kernels, name: str, need, fn):
    """Run one leg with the launch counts cleared; fail unless every kernel
    in ``need`` launched. Returns (fn's result, launches)."""
    kernels.LAUNCHES.clear()
    out = fn()
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    missing = [k for k in need if launches.get(k, 0) < 1]
    if missing:
        raise AssertionError(f"{name} leg launched no {missing}: {launches}")
    return out, launches


# ---------------------------------------------------------------------------
# 3. kernels against their plain versions
# ---------------------------------------------------------------------------

def map_flips(got_map, want_map, post_want) -> int:
    """MAP disagreements with the plain version; each must be a tie within
    KERNEL_ATOL in the plain posterior."""
    flip = (got_map != want_map).nonzero()
    t, p = flip[:, 0], flip[:, 1]
    gap = (post_want[t, want_map[t, p].long(), p]
           - post_want[t, got_map[t, p].long(), p]).abs()
    if gap.numel() and float(gap.max()) > KERNEL_ATOL:
        raise AssertionError(f"MAP differs beyond a tie: gap {gap.max()}")
    return int(gap.numel())


def backward_errors(kernels, got, want, P, exp_max) -> dict:
    """Per-output error of the kernel, scaled to its gate: the raw abs
    error for per-pair outputs, /P for the sums over pairs, /max(time)
    for the means; MAP must equal the first maximum of the kernel's own
    posterior."""
    errs = {}
    for name in ("posterior", "threshold_sums"):
        errs[name] = (got[name] - want[name]).abs().max().item()
    errs["per_pair_mean"] = ((got["per_pair_mean"] - want["per_pair_mean"])
                             .abs().max().item() / exp_max)
    for name in ("posterior_sums", "major_minor_sums"):
        errs[name] = (got[name] - want[name]).abs().max().item() / P
    if not torch.equal(got["per_pair_map"],
                       got["posterior"].argmax(dim=1).float()):
        raise AssertionError("MAP output is not the first maximum of the "
                             "kernel's posterior")
    errs["per_pair_map_ties"] = map_flips(got["per_pair_map"],
                                          want["per_pair_map"],
                                          want["posterior"])
    return errs


def compare_kernels(dec, kernels) -> dict:
    """Phase 3: kernels vs plain versions; returns per-kernel
    {max_abs_err, ms, plain_ms, ...} (times at the main-path shape)."""
    t = dec.tables
    rng = np.random.default_rng(0)
    T = 1024
    H = t.hap_bits.shape[0]
    all_outs = kernels.BwdOutputs(**{n: True for n in
                                     kernels.KERNEL_OUTPUTS})
    exp_max = float(t.exp_times.max())
    res = {"hmm_forward": {"max_abs_err": 0.0},
           "hmm_backward": {"max_abs_err": 0.0, "errors": {}},
           "hmm_block_reduce": {"max_abs_err": 0.0}}
    for label, t0, P in (("main-path", 2048, 8192),
                         ("end-of-panel", dec.L - 700, 8192),
                         ("dead-lanes", 2048, 8187)):
        ha = rng.integers(0, H, P)
        hb = (ha + 1 + rng.integers(0, H - 1, P)) % H
        obs, em, ops_f, ops_b, mask = dec.prologue(ha, hb, t0, T)
        real = min(T, dec.L - t0)
        fwd_args = (t.Mf, em, obs, t.isp, ops_f, mask)
        alpha = kernels.forward(*fwd_args)
        alpha_ref = kernels.forward_reference(*fwd_args)
        bwd_args = (t.Mb, em, obs, alpha, ops_b, mask, dec.K, 11, all_outs,
                    t.exp_times)
        got = kernels.backward_combine(*bwd_args)
        want = kernels.backward_combine_reference(*bwd_args)
        torch.cuda.synchronize()
        a_err = (alpha - alpha_ref).abs().max().item()
        errs = backward_errors(kernels, got, want, P, exp_max)
        finite = all(bool(torch.isfinite(x).all())
                     for x in [alpha, *got.values()])
        log(f"[kernels] {label}: t0={t0} T={T} real={real} P={P} "
            f"max|diff| alpha {a_err:.3g}, backward (sums /P, mean "
            f"/max time) {json.dumps(errs)} finite={finite}")
        worst = max(a_err, *(v for k, v in errs.items()
                             if k != "per_pair_map_ties"))
        if not finite or worst > KERNEL_ATOL:
            raise AssertionError(f"kernel disagrees with its plain version "
                                 f"at {label}: {errs} (atol {KERNEL_ATOL})")
        res["hmm_forward"]["max_abs_err"] = max(
            res["hmm_forward"]["max_abs_err"], a_err)
        raw = max(errs["posterior"], errs["threshold_sums"])
        res["hmm_backward"]["max_abs_err"] = max(
            res["hmm_backward"]["max_abs_err"], raw)
        res["hmm_backward"]["errors"][label] = errs
        if label == "main-path":
            time_main_path(kernels, res, fwd_args, bwd_args, all_outs, P)
        del alpha, alpha_ref, got, want
    time_asmc_shape(dec, kernels, res, rng)
    return res


def time_main_path(kernels, res, fwd_args, bwd_args, all_outs, P):
    """Kernel and plain times at the main-path shape: forward; backward
    with the FastSMC outputs (posterior + threshold sums) and with each
    output alone; the block reduction of the two sums' partials."""
    res["hmm_forward"]["ms"] = median_ms(
        lambda: kernels.forward(*fwd_args), 10)
    res["hmm_forward"]["plain_ms"] = median_ms(
        lambda: kernels.forward_reference(*fwd_args), 3)
    per_output = {}
    configs = [("posterior+threshold_sums",
                kernels.BwdOutputs(posterior=True, threshold_sums=True))]
    configs += [(n, kernels.BwdOutputs(**{f: f == n for f in
                                          kernels.KERNEL_OUTPUTS}))
                for n in kernels.KERNEL_OUTPUTS]
    for name, outs in configs:
        args = (*bwd_args[:8], outs, bwd_args[9])
        per_output[name] = {
            "ms": median_ms(lambda: kernels.backward_combine(*args), 10),
            "plain_ms": median_ms(
                lambda: kernels.backward_combine_reference(*args), 3)}
    res["hmm_backward"].update(per_output["posterior+threshold_sums"])
    res["hmm_backward"]["per_output"] = per_output
    T, KP = bwd_args[3].shape[:2]
    nblk = -(-P // kernels.PAIRS_PER_BLOCK)
    gen = torch.Generator(device="cuda").manual_seed(0)
    err, times = 0.0, {}
    for name, shape in (("posterior_sums", (nblk, T, KP)),
                        ("major_minor_sums", (nblk, T, 3, KP))):
        part = torch.rand(shape, generator=gen, device="cuda")
        got = kernels.block_reduce(part)
        err = max(err, (got - kernels.block_reduce_reference(part))
                  .abs().max().item())
        times[name] = {
            "ms": median_ms(lambda: kernels.block_reduce(part), 10),
            "plain_ms": median_ms(
                lambda: kernels.block_reduce_reference(part), 10)}
        del part, got
    if err > KERNEL_ATOL:
        raise AssertionError(f"block reduction disagrees: {err}")
    res["hmm_block_reduce"].update(max_abs_err=err,
                                   **times["major_minor_sums"],
                                   per_output=times)
    log(f"[kernels] median ms at T={T} P={P}: " + json.dumps(
        {k: {m: v[m] for m in ("ms", "plain_ms", "per_output") if m in v}
         for k, v in res.items()}))


def once_ms(fn):
    """(wall of one call of ``fn`` on the card from CUDA events, result)."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b), out


def time_asmc_shape(dec, kernels, res, rng):
    """The kernels at the ASMC scale leg's batches: the whole 6,400-site
    chromosome in its 8,192-site window, posterior sums and major/minor
    sums, 8,192 pairs and the last batch's 3,137. Each against its plain
    version on the same inputs (alpha within KERNEL_ATOL, the sums within
    KERNEL_ATOL per pair); median kernel times, one plain call each."""
    t = dec.tables
    T = 8192
    H = t.hap_bits.shape[0]
    outs = kernels.BwdOutputs(posterior=False, posterior_sums=True,
                              major_minor_sums=True)
    for P in (8192, 3137):
        label = f"asmc-shape P={P}"
        ha = rng.integers(0, H, P)
        hb = (ha + 1 + rng.integers(0, H - 1, P)) % H
        obs, em, ops_f, ops_b, mask = dec.prologue(ha, hb, 0, T)
        fwd_args = (t.Mf, em, obs, t.isp, ops_f, mask)
        alpha = kernels.forward(*fwd_args)
        plain_fwd, alpha_ref = once_ms(
            lambda: kernels.forward_reference(*fwd_args))
        a_err = (alpha - alpha_ref).abs().max().item()
        del alpha_ref
        bwd_args = (t.Mb, em, obs, alpha, ops_b, mask, dec.K, 0, outs)
        got = kernels.backward_combine(*bwd_args)
        plain_bwd, want = once_ms(
            lambda: kernels.backward_combine_reference(*bwd_args))
        errs = {n: (got[n] - want[n]).abs().max().item() / P
                for n in ("posterior_sums", "major_minor_sums")}
        finite = all(bool(torch.isfinite(x).all())
                     for x in [alpha, *got.values()])
        ms = {"forward": median_ms(lambda: kernels.forward(*fwd_args), 3),
              "forward_plain": plain_fwd,
              "backward+reduce": median_ms(
                  lambda: kernels.backward_combine(*bwd_args), 3),
              "backward_plain": plain_bwd}
        log(f"[kernels] {label} T={T}: max|diff| alpha {a_err:.3g}, sums "
            f"(/P) {json.dumps(errs)} finite={finite}; ms (posterior sums "
            f"+ major/minor sums) {json.dumps(ms)}")
        if not finite or max(a_err, *errs.values()) > KERNEL_ATOL:
            raise AssertionError(f"kernel disagrees with its plain version "
                                 f"at {label}: alpha {a_err}, {errs} (atol "
                                 f"{KERNEL_ATOL})")
        res["hmm_forward"]["max_abs_err"] = max(
            res["hmm_forward"]["max_abs_err"], a_err)
        res["hmm_backward"]["errors"][label] = errs
        if P == 8192:
            res["hmm_forward"]["asmc_shape_ms"] = ms["forward"]
            res["hmm_backward"]["asmc_shape_ms"] = ms["backward+reduce"]
        del alpha, got, want


# ---------------------------------------------------------------------------
# FastSMC legs
# ---------------------------------------------------------------------------

def read_records(path: str):
    with gzip.open(path, "rt") as fh:
        return [line.split("\t") for line in fh.read().splitlines()]


def compare_records(got, want, leg: str) -> float:
    """The same record keys (first 9 columns) in the same order, float
    columns within GOLDEN_RTOL; returns the largest relative difference."""
    if [r[:9] for r in got] != [r[:9] for r in want]:
        raise AssertionError(f"{leg}: record keys differ ({len(got)} "
                             f"records vs {len(want)} in the reference)")
    rel = 0.0
    for g, w in zip(got, want):
        for x, y in zip(g[9:], w[9:]):
            x, y = float(x), float(y)
            rel = max(rel, abs(x - y) / max(abs(y), 1e-30))
    if rel > GOLDEN_RTOL:
        raise AssertionError(f"{leg}: float columns off by rel {rel}")
    return rel


def golden_leg(FastSMC, DecodingParams, kernels) -> dict:
    params = DecodingParams.fastsmc_defaults(
        EXAMPLE, DQ, os.path.join(OUT, "example"), use_known_seed=True)
    t0 = time.perf_counter()
    path, launches = run_leg(
        kernels, "FastSMC golden", DECODE_KERNELS,
        lambda: FastSMC(params, device="cuda").run(verbose=False))
    wall = time.perf_counter() - t0
    got = read_records(path)
    rel = compare_records(got, read_records(GOLDEN), "golden leg")
    log(f"[golden] {len(got)} records, keys equal in order, float max rel "
        f"{rel:.3g}, wall {wall:.2f} s, launches {launches}")
    return launches


def scale_params(DecodingParams, tag: str):
    """The scale leg's configuration: batch 8192, min_m 1.5, the
    reference's default 13-column records (ages on), exact profile."""
    return DecodingParams(
        fastsmc=True, hashing=True, batch_size=8192, in_file_root=OUT,
        out_file_root=os.path.join(OUT, tag), decoding_quant_file=DQ,
        min_m=1.5, use_known_seed=True, output_ibd_segment_length=True,
        do_per_pair_posterior_mean=True, do_per_pair_map=True).finalize()


def scale_leg(FastSMC, DecodingParams, kernels, data) -> dict:
    runs = []
    dq = None
    for i in range(2):
        f = FastSMC(scale_params(DecodingParams, f"scale{i}"), data=data,
                    dq=dq, device="cuda")
        dq = f.dq
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        path, launches = run_leg(kernels, "FastSMC scale", DECODE_KERNELS,
                                 lambda: f.run(verbose=False))
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
                   launches=launches, phase_s=f.timer.totals(),
                   sha256=digest)
        log("[scale] " + json.dumps(row))
        runs.append(row)
        os.remove(path)
    if runs[0]["sha256"] != runs[1]["sha256"] \
            or runs[0]["records"] != runs[1]["records"]:
        raise AssertionError("scale leg: the two runs' outputs differ")
    log("[scale] both runs wrote identical decompressed output")
    return runs[1]["launches"]


def no_hashing_leg(FastSMC, DecodingParams, kernels, data) -> dict:
    """FastSMC without hashing: every pair of job 1 of 25 (1,794 pairs of
    the example panel) over the whole chromosome, batch 256; then job 1 of
    400 (112 pairs) on the card against the plain versions on the CPU."""
    def params(tag, jobs):
        return DecodingParams.fastsmc_defaults(
            EXAMPLE, DQ, os.path.join(OUT, tag), use_known_seed=True,
            hashing=False, jobs=jobs, job_ind=1, batch_size=256)

    f = FastSMC(params("nohash", 25), data=data, device="cuda")
    t0 = time.perf_counter()
    path, launches = run_leg(kernels, "no-hashing", DECODE_KERNELS,
                             lambda: f.run(verbose=False))
    wall = time.perf_counter() - t0
    recs = read_records(path)
    vals = np.array([[float(x) for x in r[9:]] for r in recs])
    if not recs or len(recs[0]) != 13 or not np.isfinite(vals).all() \
            or len(recs) != f.n_segments:
        raise AssertionError(f"no-hashing leg: {len(recs)} records")
    got = read_records(FastSMC(params("nohash_small", 400), data=data,
                               device="cuda").run(verbose=False))
    want = read_records(FastSMC(params("nohash_small_cpu", 400), data=data,
                                device="cpu").run(verbose=False))
    rel = compare_records(got, want, "no-hashing leg, card vs CPU")
    log(f"[no-hashing] {f._cpt} pairs, {len(recs)} records, "
        f"{f.stats['decoded_site_pairs']} decoded site-pairs, wall "
        f"{wall:.2f} s, launches {launches}; job 1 of 400: {len(got)} "
        f"records, keys equal to the plain versions' on the CPU in order, "
        f"float max rel {rel:.3g}")
    return launches


# ---------------------------------------------------------------------------
# ASMC legs
# ---------------------------------------------------------------------------

def asmc_golden_leg(ASMC, DecodingParams, kernels, data) -> dict:
    params = DecodingParams.asmc(
        EXAMPLE, DQ, os.path.join(OUT, "asmc_golden"), use_known_seed=True,
        do_posterior_sums=True, do_major_minor_posterior_sums=True,
        jobs=100, job_ind=7)
    a = ASMC(params, data=data, device="cuda", batch_size=64)
    start, end = a._job_pair_range()
    res, launches = run_leg(kernels, "ASMC golden", ASMC_KERNELS,
                            lambda: a.decode_all_in_job(verbose=False))
    want = np.load(ASMC_GOLDEN)
    errs = {f: float(np.abs(getattr(res, f) - want[f]).max()) for f in SUMS}
    log(f"[asmc-golden] pairs {start}..{end - 1}: max|diff| vs the JAX "
        f"golden {json.dumps(errs)} (gate {KERNEL_ATOL * (end - start):g}),"
        f" launches {launches}")
    if max(errs.values()) > KERNEL_ATOL * (end - start):
        raise AssertionError(f"ASMC golden leg: {errs}")
    return launches


def asmc_per_pair_leg(ASMC, DecodingParams, kernels, data) -> dict:
    """The 150 within-sample pairs, batch 64: streamed means and MAP states
    against the decode_pairs API for three pairs."""
    root = os.path.join(OUT, "asmc_pp")
    params = DecodingParams.asmc(
        EXAMPLE, DQ, root, use_known_seed=True, within_only=True,
        do_per_pair_posterior_mean=True, do_per_pair_map=True)
    a = ASMC(params, data=data, device="cuda", batch_size=64)
    _, launches = run_leg(kernels, "ASMC per-pair", DECODE_KERNELS,
                          lambda: a.decode_all_in_job(verbose=False))
    means = np.loadtxt(root + ".perPairPosteriorMeans.gz", dtype=np.float32)
    maps = np.loadtxt(root + ".perPairMAP.gz", dtype=np.int64)
    if means.shape != (150, data.sites) or maps.shape != means.shape:
        raise AssertionError(f"per-pair streams: {means.shape} {maps.shape}")
    pick = np.array([0, 75, 149])
    api = a.decode_pairs(list(2 * pick), list(2 * pick + 1))
    rel = float(np.abs(api.per_pair_posterior_means - means[pick]).max()
                / np.abs(means[pick]).max())
    map_equal = bool((api.per_pair_maps == maps[pick]).all())
    log(f"[asmc-per-pair] 150 pairs; pairs {pick.tolist()} vs decode_pairs:"
        f" means max rel {rel:.3g}, MAP equal {map_equal}, launches "
        f"{launches}")
    if rel > KERNEL_ATOL or not map_equal:
        raise AssertionError("per-pair streams disagree with decode_pairs")
    return launches


def asmc_scale_leg(ASMC, DecodingParams, kernels, data) -> dict:
    """jobs=1000, job 1 of the scale panel's 2N^2 - N pairs, batch 8192,
    posterior sums and major/minor sums, twice."""
    runs, digests, sums = [], [], []
    dq = None
    for i in range(2):
        root = os.path.join(OUT, f"asmc_scale{i}")
        params = DecodingParams.asmc(
            OUT, DQ, root, use_known_seed=True, do_posterior_sums=True,
            do_major_minor_posterior_sums=True, jobs=1000, job_ind=1)
        a = ASMC(params, data=data, dq=dq, device="cuda", batch_size=8192)
        dq = a.dq
        start, end = a._job_pair_range()
        n = end - start
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res, launches = run_leg(kernels, "ASMC scale", ASMC_KERNELS,
                                lambda: a.decode_all_in_job(verbose=False))
        wall = time.perf_counter() - t0
        a.write_outputs(res)
        with gzip.open(root + ".sumOverPairs.gz", "rb") as fh:
            digests.append(hashlib.sha256(fh.read()).hexdigest())
        sums.append([getattr(res, f) for f in SUMS])
        total = res.sum_over_pairs
        row_rel = float(np.abs(total.sum(1) / n - 1.0).max())
        mm_err = float(np.abs(res.sum_over_pairs00 + res.sum_over_pairs01
                              + res.sum_over_pairs11 - total).max())
        row = dict(run="cold" if i == 0 else "warm", pairs=n,
                   batches=-(-n // a.batch_size), wall_s=wall,
                   pairs_per_s=n / wall,
                   site_pairs_per_s=n * data.sites / wall,
                   max_memory_allocated=torch.cuda.max_memory_allocated(),
                   row_sum_max_rel=row_rel, classes_vs_total_max_abs=mm_err,
                   launches=launches, sha256=digests[-1])
        log("[asmc-scale] " + json.dumps(row))
        if row_rel > 1e-3 or mm_err > KERNEL_ATOL * n:
            raise AssertionError(f"ASMC scale leg: sums off: {row}")
        runs.append(row)
    if digests[0] != digests[1] or not all(
            np.array_equal(x, y) for x, y in zip(*sums)):
        raise AssertionError("ASMC scale leg: the two runs' sums differ")
    log("[asmc-scale] both runs wrote byte-identical sumOverPairs, and the "
        "four sum matrices are equal bit for bit")
    return runs[1]["launches"]


def main() -> int:
    # 1. the card
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    log(f"[card] {card_line()}")
    log(f"[card] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} devices {torch.cuda.device_count()}")
    os.makedirs(OUT, exist_ok=True)

    from fastsmc_tpu_torch import ASMC, DecodingParams, FastSMC
    from fastsmc_tpu_torch.engine import _build, kernels
    from fastsmc_tpu.io.haps import load_data
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
        elif fn and (tag in fn or "reduce" in fn) \
                and ("registers" in line or "spill" in line):
            kind = next(k for k in ("forward", "backward", "reduce")
                        if k in fn)
            if "Lb1E" in fn or "Lb0E" in fn:
                kind += (" (all outputs)" if "Lb1E" in fn else
                         " (posterior, threshold sums)")
            log(f"[build] {kind} kernel, K={dec.K}: {line.strip()}")
    kres = compare_kernels(dec, kernels)
    del dec
    torch.cuda.empty_cache()

    # 4.-9. the legs; launches summed over every leg's own run
    launches: dict = {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    t0 = time.perf_counter()
    scale_data = make_panel(SCALE_HAPS, seed=0)
    log(f"[scale] panel {scale_data.n_haps} haps x {scale_data.sites} sites "
        f"in {time.perf_counter() - t0:.1f} s")
    example = load_data(DecodingParams.asmc(EXAMPLE, DQ, OUT, fastsmc=True,
                                            use_known_seed=True))
    add(golden_leg(FastSMC, DecodingParams, kernels))
    add(scale_leg(FastSMC, DecodingParams, kernels, scale_data))
    add(asmc_golden_leg(ASMC, DecodingParams, kernels, example))
    add(asmc_per_pair_leg(ASMC, DecodingParams, kernels, example))
    add(asmc_scale_leg(ASMC, DecodingParams, kernels, scale_data))
    add(no_hashing_leg(FastSMC, DecodingParams, kernels, example))

    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    rows = []
    for name, src, line in (
            ("hmm_forward", "hmm_forward.cu", "96"),
            ("hmm_backward", "hmm_backward.cu", "185"),
            # the over-pairs sums in _make_bwd_kernel's body
            ("hmm_block_reduce", "hmm_reduce.cu", "267")):
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
