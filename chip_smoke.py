"""Smoke run of the PyTorch/CUDA port (fastsmc_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit code:
  1. the card (name, power limit) and the torch/CUDA versions;
  2. build the four CUDA sources from csrc/ with nvcc, one process each,
     and the native host library (g++; the run fails without it);
  3. each kernel against its plain PyTorch version on the card: the forward
     kernel (alpha) and the backward kernel with all six outputs, at a
     main-path shape (T=1024, P=8192), at a window padded past the panel
     end and with P=8187 (dead lanes in the last 32-pair block); the block
     reduction on the backward kernel's partials; median times from CUDA
     events, per backward output; then the forward kernel and the backward
     kernel with the two sums at the ASMC scale leg's batches (the whole
     chromosome's T=8192 window, P=8192 and the last batch's P=3137),
     against their plain versions; batch invariance: 3,137 pairs as the
     first of an 8,192-pair launch and alone give the same bits, forward
     and backward, array and sequence mode, exact and fast;
  4. FastSMC golden leg: FastSMC(...).run() on artifacts/panels/
     example_array must reproduce the record keys (first 9 columns) of
     tests/fixtures/example_array.golden.FastSMC.ibd.gz in order, with
     float columns within relative 1e-4; then the overflow redo: the same
     run with every extraction cap started at 8 must redo batches at grown
     caps and write the same bytes (decompressed);
  5. FastSMC scale leg: the 16,384-haplotype x 6,400-site folded
     founder-mosaic panel (fastsmc_tpu_torch.probes.biobank make_panel,
     a copy of scripts/biobank_probe.py's), batch
     8192, min_m 1.5, ages on, exact profile, run twice with identical
     output, each row with roofline(); in the first run every flush group
     after the first is queued under torch.cuda.set_sync_debug_mode
     ("error"), so a call that waits for the card fails the run (the
     drain's wait on the group's event is outside);
  6. ASMC golden leg: the sums of pairs 2,691..3,138 (jobs=100, job 7) of
     the example panel must reproduce the JAX-made
     tests/fixtures/example_array.asmc_job7of100.npz within 1e-5 per pair;
  7. ASMC per-pair leg: the example panel's 150 within-sample pairs stream
     posterior means and MAP states; for three pairs they must agree with
     the decode_pairs API, which reads the kernel's posterior output;
  8. ASMC scale leg: the scale panel, jobs=1000, job 1 (134,209 pairs),
     batch 8192, posterior sums and major/minor sums, run twice with
     byte-identical .sumOverPairs.gz outputs; then once more under
     torch.profiler (device busy and idle share, device time by kernel);
  9. FastSMC without hashing: the example panel, jobs=25, job 1 (1,794
     pairs); and jobs=400, job 1 (112 pairs) on the card against the plain
     versions on the CPU: the same records, floats within relative 1e-4.
 10. the kernels' sequence-mode and fast/turbo instantiations against their
     plain versions (APPROX_ATOL, APPROX_SUM_ATOL: per mode): at T=1024
     with P=8192 and P=8187, and at the ASMC shape (T=8192, both sums,
     P=8192 and P=3137); turbo's outputs must equal fast's bit for bit; at
     T=1024 the fast kernel against the exact one (posterior within
     PROFILE_POST_ATOL), with the plain versions reading the same
     difference on the pairs where it is largest;
 11. sequence mode: the ASMC golden (tests/fixtures/
     example_array.seq_asmc_job7of100.npz) and the FastSMC golden
     (tests/fixtures/example_array.seq.FastSMC.ibd.gz, both made by the JAX
     package on the CPU) reproduced; the ASMC scale leg in sequence mode,
     run twice with bit-identical sums;
 12. the fast/turbo profiles: the ASMC scale leg on the fast profile at the
     batch cap its bf16 alpha allows, sums against the exact leg's within
     PROFILE_SUM_ATOL per pair; the per-pair leg on the fast profile against
     the exact one's streams (PROFILE_MEAN_RTOL, PROFILE_MAP_AGREE); the
     FastSMC scale leg on the fast profile, run twice with identical
     output, bp-F1 >= 0.99 against the exact leg's records; on the example
     panel turbo equals fast bit for bit (FastSMC records, ASMC
     sequence-mode sums) and fast is within PROFILE_SUM_ATOL per pair of the
     sequence-mode golden.
 13. the alpha-wall probe (fastsmc_tpu_torch.probes.alpha_wall, run before
     the legs of 4.-12.): its six variants' kernels against their plain
     versions at the probe's shape (T=4096, P=8192, KC=128, KA=72, S=8)
     and with P=8187 (raw alpha within ALPHA_WALL_FWD_RTOL, the backward
     output within ALPHA_WALL_BWD_ATOL, its raw carry after site 1 within
     ALPHA_WALL_CARRY_RTOL; two wrongly normalising forwards must miss the
     alpha gate, a wrongly normalising backward the carry gate), then the
     probe's main(): the six median times and the alpha write and read
     costs.
 14. (after phase 5) the exact FastSMC scale leg once more, warm, under
     torch.profiler: wall, device busy time and idle share, device time by kernel group,
     roofline() and peak memory;
 15. (after 14) resume: the exact scale leg stopped by an exception at the drain after
     its first checkpoint, then resumed by a fresh FastSMC; the output's
     sha256 (decompressed) must equal phase 5's and no .progress may be
     left;
 16. (after 12) the entry options on the example panel: sort_batches=8,
     bucket_sites=0 and permissive_window=True, each against the JAX
     package's records (tests/fixtures/example_array.{sort8,arrival,
     permissive}.FastSMC.ibd.gz) as in phase 4.
 17. (after 16) the mesh (fastsmc_tpu_torch.parallel) on this card: the
     FastSMC golden on 1, 2 and 4 shards on cuda:0, and on 4 with every cap
     started at 8, each writing phase 4's bytes; on 2 shards the exact
     FastSMC scale leg (phase 5's sha256, its flush groups after the first
     queued under the sync check, then profiled: wall and device idle
     share beside phase 5's and 14's; torch's current device unchanged),
     the ASMC scale leg (sums within relative 1e-6 of phase 8's, two runs
     byte-identical) and the per-pair leg (phase 7's streams byte for
     byte). With more than one card the same legs run over the real
     devices too; on one card a line says that scaling is not measured.
 18. (after 17) two processes of this script (--multihost-worker) join one
     gloo group on localhost and run their tiles of the example panel
     (jobs=4) on cuda:0; the merged output must cover the pair set (first
     6 columns) of phase 4's run, and each process must launch the decode
     kernels (their launches count with the legs').
Each leg clears the launch counts before it runs and fails unless every
kernel of its path was launched. The line before the last lists the
kernels as JSON, each with its time, its plain version's, its bound on the
card (bound_ms, bound_by: see MEM_BW, PEAK), the time of the one PyTorch
call that computes the same function where there is one (library_ms), its
launches over all legs and per scale leg; the line before that is the
card's name and power limit. The last line is {"ok": true, "device":
{...}}. The run imports nothing of JAX or of the JAX package. Outputs go to
build/chip_smoke/ in the checkout.

Phase 10 also times the fast array kernels at the fast ASMC leg's batch
(FAST_CAP_PAIRS pairs, T=8192), kernel only.

    python3 chip_smoke.py --fastsmc-parent DIR

first runs the exact FastSMC scale leg of this tree and of the checkout at
DIR (e.g. a `git archive` of the parent commit), each through its own
package: one run a side, then profiled runs in turns (parent, this, this,
parent) with wall, device idle share, roofline() (where the side has one)
and peak memory; this tree's records must have the parent's keys in the
parent's order (floats within GOLDEN_RTOL), each side's runs the same
bytes. Then the phases above.

    python3 chip_smoke.py --ab-parent DIR [--ab-only]

adds, before phase 3, an A/B of the forward kernel against that of another
checkout at DIR (e.g. a `git archive` of the parent commit), each called
through its own checkout's wrappers on the same inputs: every forward
branch (array and sequence mode, exact and fast) at T=1024 and at the ASMC
shape (T=8192, P=8192 and 3137), fast array also at FAST_CAP_PAIRS, alpha
within KERNEL_ATOL (exact) or APPROX_ATOL (fast) of the parent's, and bit
for bit on the bf16 array branch, which keeps its FFMA kernel; the backward
at the ASMC shape on one alpha fed to both sides as the control, every
output equal to the parent's bit for bit (the sums as their per-group
partials); times in turns three times each; both builds' ptxas lines and
SASS counts; then each forward branch against its plain version beside
the plain version with f64 sums against it. --ab-only stops after the A/B
and the batch-invariance check.
"""

from __future__ import annotations

import argparse
import gzip
import hashlib
import inspect
import json
import os
import re
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
SEQ_ASMC_GOLDEN = os.path.join(REPO, "tests", "fixtures",
                               "example_array.seq_asmc_job7of100.npz")
SEQ_GOLDEN = os.path.join(REPO, "tests", "fixtures",
                          "example_array.seq.FastSMC.ibd.gz")
# kernel vs plain version on the card: f32 sums taken in another order in
# a K=69 product that is renormalised at every site; sums over P pairs
# get 1e-5 per pair, posterior means (in generations) 1e-5 times the
# largest expected time, and MAP states may differ only at ties within
# KERNEL_ATOL
KERNEL_ATOL = 1e-5
# the fast/turbo kernels against their plain versions, per mode: the two
# round the same operands to bf16, but their f32 carries may differ in the
# last bit; then one bf16 rounding goes the other way (2^-8 relative) and
# the two recursions drift apart at bf16 level, most in sequence mode (two
# rounded products a site, no block normalisation). Largest readings on an
# H100 over phase 10's windows (8.4M pair-sites at T=1024; the sums also at
# T=8192): array alpha 7.9e-4, posterior 3.2e-4, threshold sums 1.2e-4,
# means 3.2e-5 x the largest time, sums over pairs 1.6e-7 per pair;
# sequence alpha 1.2e-2, posterior 1.7e-2, threshold sums 1.1e-3, means
# 4.3e-4 x the largest time, sums 4.6e-6 per pair. Gates: per-pair outputs
# (and alpha, columns normalised) 5e-3 array, 5e-2 sequence, times the
# largest expected time on means, MAP states differing only where the plain
# posterior's two states lie within it; sums over pairs about 10x their
# readings.
APPROX_ATOL = {"array": 5e-3, "sequence": 5e-2}
APPROX_SUM_ATOL = {"array": 2e-6, "sequence": 5e-5}
# the fast profile against the exact one: the profile's own error, not a
# kernel's. Sums over pairs: 5e-3 per pair (readings 2.6e-4 on the ASMC
# scale leg, 1.3e-3 on the 448-pair sequence-mode golden job). Posterior:
# 0.25 over phase 10's 8.4M pair-sites a mode (readings 0.13 array, 0.16
# sequence). Per-pair streams of the example panel's 150 within-sample
# pairs (array mode; the plain versions on the CPU read 2.2e-2 and 0.857):
# posterior means within relative 5e-2, MAP states equal at >= 80 % of the
# pair-sites (the others are states of flat, near-tied posteriors).
PROFILE_SUM_ATOL = 5e-3
PROFILE_POST_ATOL = 0.25
PROFILE_MEAN_RTOL = 5e-2
PROFILE_MAP_AGREE = 0.8
GOLDEN_RTOL = 1e-4
F1_MIN = 0.99
# the alpha-wall probe's kernels against their plain versions (phase 13),
# per pass: bf16 operands, f32 sums in another order, the carry rounded to
# bf16 at every site, so the two drift at bf16 level once a rounding parts
# them. Alpha is held raw, element by element, relative to the plain
# version's value (every value is a sum of positive products, so a
# normalisation at the wrong site or by the wrong sum shows as a wrong
# scale); one bf16 step is 2^-8 to 2^-7 relative. Largest readings on an
# H100 over the six variants at P=8192 and 8187: forward alpha 7.8e-3
# relative (2^-7: one bf16 step, in every forward variant), backward
# output 1.8e-5 absolute (values in (0, 1]). Gates: two bf16 steps on
# alpha, about 10x the reading on the backward. A forward that normalises
# at every site, held to fwd_norm_block's plain version, reads 36; one
# that divides by the stored rows' sum reads 1.18.
ALPHA_WALL_FWD_RTOL = 1.6e-2
ALPHA_WALL_BWD_ATOL = 2e-4
# the backward's output is renormalised per column and cannot show where
# the pass normalises; its raw carry after ALPHA_WALL_CARRY_SITE (inside a
# block: the backward normalises at r % S == 0) can. Held element by
# element, relative to the plain value, at two bf16 steps; a backward that
# normalises at every site under block normalisation must miss it.
ALPHA_WALL_CARRY_RTOL = 1.6e-2
ALPHA_WALL_CARRY_SITE = 1
# the card's published peaks (H100 SXM, dense, at 700 W): HBM bytes/s and
# FLOP/s by operand type. A
# bound is the larger of bytes / MEM_BW and FLOP / PEAK[type], counting
# each input byte read once and each output byte written once, and the
# operator products only (the elementwise work of the decode kernels is
# ~3 % more), at the real K (never the padded KP); bf16 operands with f32
# sums are tensor-core work (but the bf16 array forward, whose kernel runs
# them on the FP32 pipe); the forward's exact products run as 3xTF32 on the
# tensor cores, three TF32 products for each, and the backward's on the
# FP32 pipe.
MEM_BW = 3.35e12
PEAK = {"f32": 67e12, "bf16": 989e12, "tf32": 495e12}
SCALE_HAPS = 16384
# where the tables live and the kernels run
DEVICE = "cuda"
SUMS = ("sum_over_pairs", "sum_over_pairs00", "sum_over_pairs01",
        "sum_over_pairs11")
DECODE_KERNELS = ("hmm_forward", "hmm_backward")
# the instantiations besides (array, exact), in an order where turbo follows
# fast in each mode
VARIANTS = (("sequence", "exact"), ("array", "fast"), ("array", "turbo"),
            ("sequence", "fast"), ("sequence", "turbo"))
# phase 10's windows (label, t0, T, P, outputs): the main path's with all
# six outputs, then the ASMC scale leg's batches with the two sums
VARIANT_SHAPES = (("main-path", 2048, 1024, 8192, "all"),
                  ("dead-lanes", 2048, 1024, 8187, "all"),
                  ("asmc-shape P=8192", 0, 8192, 8192, "sums"),
                  ("asmc-shape P=3137", 0, 8192, 3137, "sums"))


def decode_kernels(kernels, mode: str, profile: str):
    """The forward and backward instantiations of a mode and profile."""
    return tuple(kernels.kernel_name(k, mode == "sequence", profile)
                 for k in ("hmm_forward", "hmm_backward"))


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


def bound(nbytes: float, flop: float, kind: str) -> dict:
    """The least time the card could take: bound_ms, and bound_by "bytes"
    or "operations", whichever sets it."""
    mem_ms = 1e3 * nbytes / MEM_BW
    op_ms = 1e3 * flop / PEAK[kind]
    return {"bound_ms": max(mem_ms, op_ms),
            "bound_by": "bytes" if mem_ms >= op_ms else "operations"}


def decode_bound(kernel: str, T: int, P: int, K: int, G: int, seq: bool,
                 profile: str, outs=None) -> dict:
    """Bound of the forward (``outs`` None) or backward+reduction kernel on
    a T-site window of P pairs at K real states: the T-1 steps' K x K
    products (two a step in sequence mode), f32 on the exact profile and
    bf16 operands otherwise; bytes of the observations, emission rows,
    homozygous emissions (sequence mode), the G operators of the panel,
    alpha (f32 exact, bf16 otherwise; written or read) and the requested
    outputs (the sums over pairs as the reduced [T, K] and [T, 3, K]).
    The exact forward reads its operators as two TF32 tables and does three
    TF32 products for each f32 one (3xTF32). bf16 operands are bounded by
    the bf16 tensor-core peak whatever unit the kernel uses."""
    approx = profile != "exact"
    tf32x3 = kernel == "forward" and not approx
    ab = 2 if approx else 4
    nbytes = 4 * (2 * T * P + 3 * T * K + (T * K if seq else 0)) \
        + G * K * K * (2 if profile == "turbo" else 8 if tf32x3 else 4) \
        + T * K * P * ab
    if outs is not None:
        nbytes += 4 * (T * K * P * outs.posterior
                       + T * P * (outs.threshold_sums + outs.per_pair_mean
                                  + outs.per_pair_map)
                       + T * K * (outs.posterior_sums
                                  + 3 * outs.major_minor_sums))
    flop = 2 * (T - 1) * P * K * K * (2 if seq else 1)
    if tf32x3:
        return bound(nbytes, 3 * flop, "tf32")
    return bound(nbytes, flop, "bf16" if approx else "f32")


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

def map_flips(got_map, want_map, post_want, tol=KERNEL_ATOL) -> int:
    """MAP disagreements with the plain version; each must be a tie within
    ``tol`` in the plain posterior."""
    flip = (got_map != want_map).nonzero()
    t, p = flip[:, 0], flip[:, 1]
    gap = (post_want[t, want_map[t, p].long(), p]
           - post_want[t, got_map[t, p].long(), p]).abs()
    if gap.numel() and float(gap.max()) > tol:
        raise AssertionError(f"MAP differs beyond a tie: gap {gap.max()}")
    return int(gap.numel())


def backward_errors(kernels, got, want, P, exp_max, tol=KERNEL_ATOL) -> dict:
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
                                          want["posterior"], tol)
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
        alpha = kernels.forward(*fwd_args, split=t.split)
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
            time_main_path(dec, kernels, res, fwd_args, bwd_args, P)
        del alpha, alpha_ref, got, want
    time_asmc_shape(dec, kernels, res, rng)
    return res


def time_main_path(dec, kernels, res, fwd_args, bwd_args, P):
    """Kernel and plain times at the main-path shape, with their bounds:
    forward; backward with the FastSMC outputs (posterior + threshold
    sums) and with each output alone; the block reduction of the two sums'
    partials, and the one PyTorch call that computes the same sum."""
    T, G = bwd_args[3].shape[0], dec.tables.Mf.shape[0]
    res["hmm_forward"].update(decode_bound("forward", T, P, dec.K, G, False,
                                           "exact"))
    res["hmm_forward"]["ms"] = median_ms(
        lambda: kernels.forward(*fwd_args, split=dec.tables.split), 10)
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
                lambda: kernels.backward_combine_reference(*args), 3),
            **decode_bound("backward", T, P, dec.K, G, False, "exact", outs)}
    res["hmm_backward"].update(per_output["posterior+threshold_sums"])
    res["hmm_backward"]["per_output"] = per_output
    KP = bwd_args[3].shape[1]
    nblk = -(-P // kernels.PAIRS_PER_BLOCK)
    gen = torch.Generator(device="cuda").manual_seed(0)
    err, times = 0.0, {}
    for name, shape in (("posterior_sums", (nblk, T, KP)),
                        ("major_minor_sums", (nblk, T, 3, KP))):
        part = torch.rand(shape, generator=gen, device="cuda")
        got = kernels.block_reduce(part)
        err = max(err, (got - kernels.block_reduce_reference(part))
                  .abs().max().item())
        # each partial read once, the sums written once; the adds (f64 in
        # the kernel) counted at the f32 rate: the bytes set the bound
        E = part[0].numel()
        times[name] = {
            "ms": median_ms(lambda: kernels.block_reduce(part), 10),
            "plain_ms": median_ms(
                lambda: kernels.block_reduce_reference(part), 10),
            "library_ms": median_ms(
                lambda: part.sum(0, dtype=torch.float64), 10),
            **bound(4 * (nblk + 1) * E, nblk * E, "f32")}
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
        alpha = kernels.forward(*fwd_args, split=t.split)
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
        ms = {"forward": median_ms(
            lambda: kernels.forward(*fwd_args, split=t.split), 3),
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
            G = t.Mf.shape[0]
            for name, key, o in (("hmm_forward", "forward", None),
                                 ("hmm_backward", "backward+reduce", outs)):
                b = decode_bound(name.split("_")[1], T, P, dec.K, G, False,
                                 "exact", o)
                res[name].update(asmc_shape_ms=ms[key],
                                 asmc_shape_bound_ms=b["bound_ms"],
                                 asmc_shape_bound_by=b["bound_by"])
        del alpha, got, want


# the fast ASMC scale leg's batch: the cap ASMC sets for a bf16 alpha at
# T=8192 on this card's 80 GB (phase 12's leg)
FAST_CAP_PAIRS = 27296


def time_fast_cap(decs, kernels, res) -> None:
    """The fast array kernels at the fast ASMC scale leg's batch (T=8192,
    FAST_CAP_PAIRS pairs, both sums): kernel times only, median of 3, no
    plain version at this size; each forward's alpha is freed before the
    next (one takes 32 GB)."""
    dec = decs["array", "fast"]
    t = dec.tables
    T, P = 8192, FAST_CAP_PAIRS
    obs, em, ops_f, ops_b, mask, _, _ = window_inputs(
        dec, *random_pairs(np.random.default_rng(11), t.hap_bits.shape[0],
                           P), 0, T)
    outs = kernels.BwdOutputs(posterior=False, posterior_sums=True,
                              major_minor_sums=True)
    fname, bname = decode_kernels(kernels, "array", "fast")

    def fwd():
        return kernels.forward(t.Mf, em, obs, t.isp, ops_f, mask, None,
                               "fast")

    res[fname]["asmc_cap_ms"] = median_ms(fwd, 3)
    alpha = fwd()

    def bwd():
        return kernels.backward_combine(t.Mb, em, obs, alpha, ops_b, mask,
                                        dec.K, 0, outs, None, None, "fast")

    res[bname]["asmc_cap_ms"] = median_ms(bwd, 3)
    for name, o in ((fname, None), (bname, outs)):
        res[name]["asmc_cap_bound_ms"] = decode_bound(
            "forward" if o is None else "backward", T, P, dec.K,
            t.Mf.shape[0], False, "fast", o)["bound_ms"]
    log(f"[variants] fast array kernels at the fast ASMC leg's batch (T={T},"
        f" P={P}, both sums), median ms of 3: forward "
        f"{res[fname]['asmc_cap_ms']:.2f}, backward+reduce "
        f"{res[bname]['asmc_cap_ms']:.2f}")
    del alpha
    torch.cuda.empty_cache()


def random_pairs(rng, H: int, P: int):
    ha = rng.integers(0, H, P)
    return ha, (ha + 1 + rng.integers(0, H - 1, P)) % H


def window_inputs(dec, ha, hb, t0: int, T: int):
    """The prologue of a window: (obs, em, ops_f, ops_b, mask, seq_f,
    seq_b), the seq operands None in array mode."""
    obs, em, ops_f, ops_b, mask = dec.prologue(ha, hb, t0, T)
    seq_f = seq_b = None
    if dec.sequence:
        seq_f, seq_b = dec.seq_prologue(t0, T)
    return obs, em, ops_f, ops_b, mask, seq_f, seq_b


def alpha_err(a, b, chunk: int = 512) -> float:
    """Largest difference of two alphas [T, KP, P] after each site's column
    is divided by its sum (block normalisation leaves alpha unnormalised
    within a block), in chunks of sites to bound the f32 copies."""
    err = 0.0
    for t in range(0, a.shape[0], chunk):
        x = a[t:t + chunk].float()
        y = b[t:t + chunk].float()
        x = x / x.sum(dim=1, keepdim=True)
        y = y / y.sum(dim=1, keepdim=True)
        err = max(err, (x - y).abs().max().item())
    return err


def profile_error(ex_dec, kernels, inp, got, want, outs, tol,
                  n_worst: int = 8) -> dict:
    """The fast profile's own error on one window: its kernel (``got``)
    against the exact kernel on the same inputs (posterior, per-pair means
    relative to the exact ones, the share of equal MAP states), gated at
    PROFILE_POST_ATOL on the posterior. Then the witness that the error is
    the profile's arithmetic, not the kernel's: on the ``n_worst`` pairs
    where the two kernels differ most, the plain fast version (``want``)
    against the plain exact one reads the same, within the two kernels'
    gates against their plain versions (``tol`` + KERNEL_ATOL)."""
    obs, em, ops_f, ops_b, mask, seq_f, seq_b = inp
    t = ex_dec.tables
    alpha = kernels.forward(t.Mf, em, obs, t.isp, ops_f, mask, seq_f,
                            split=t.split)
    ex = kernels.backward_combine(t.Mb, em, obs, alpha, ops_b, mask,
                                  ex_dec.K, 11, outs, t.exp_times, seq_b)
    del alpha
    kern = (got["posterior"] - ex["posterior"]).abs().amax(dim=(0, 1))
    worst = kern.topk(n_worst).indices
    obs_w = obs[..., worst].contiguous()
    alpha = kernels.forward_reference(t.Mf, em, obs_w, t.isp, ops_f, mask,
                                      seq_f)
    plain_ex = kernels.backward_combine_reference(
        t.Mb, em, obs_w, alpha, ops_b, mask, ex_dec.K, 0,
        kernels.BwdOutputs(), seq=seq_b)["posterior"]
    plain = (want["posterior"][..., worst] - plain_ex).abs().amax(dim=(0, 1))
    res = {"posterior": kern.max().item(),
           "worst_pairs_kernels": kern[worst].tolist(),
           "worst_pairs_plain_versions": plain.tolist(),
           "per_pair_mean_rel": ((got["per_pair_mean"] - ex["per_pair_mean"])
                                 .abs() / ex["per_pair_mean"]).max().item(),
           "map_equal_share": (got["per_pair_map"] == ex["per_pair_map"])
           .float().mean().item()}
    if res["posterior"] > PROFILE_POST_ATOL \
            or (kern[worst] - plain).abs().max().item() > tol + KERNEL_ATOL:
        raise AssertionError(f"fast against exact: {res} (posterior gate "
                             f"{PROFILE_POST_ATOL}, kernels against plain "
                             f"versions within {tol + KERNEL_ATOL})")
    return res


def compare_variants(decs, kernels) -> dict:
    """Phase 10: the sequence-mode and fast/turbo instantiations against
    their plain versions at the main-path window (T=1024, P=8192 and 8187,
    all six outputs) and at the ASMC shape (T=8192, both sums, P=8192 and
    3137); turbo equal to fast bit for bit. Returns per-instantiation
    {max_abs_err, ms, plain_ms, ...}."""
    rng = np.random.default_rng(2)
    all_outs = kernels.BwdOutputs(**{n: True for n in
                                     kernels.KERNEL_OUTPUTS})
    sums = kernels.BwdOutputs(posterior=False, posterior_sums=True,
                              major_minor_sums=True)
    res, prev = {}, {}
    for mode, profile in VARIANTS:
        dec = decs[mode, profile]
        t = dec.tables
        H = t.hap_bits.shape[0]
        exp_max = float(t.exp_times.max())
        tol, sum_tol = (KERNEL_ATOL, KERNEL_ATOL) if profile == "exact" \
            else (APPROX_ATOL[mode], APPROX_SUM_ATOL[mode])
        fname, bname = decode_kernels(kernels, mode, profile)
        rf = res[fname] = {"max_abs_err": 0.0}
        rb = res[bname] = {"max_abs_err": 0.0, "errors": {}}
        for label, t0, T, P, which in VARIANT_SHAPES:
            outs = all_outs if which == "all" else sums
            if profile != "turbo":
                # turbo takes fast's inputs, to compare bit for bit
                pairs = random_pairs(rng, H, P)
            else:
                pairs = prev[label][0]
            inp = window_inputs(dec, *pairs, t0, T)
            obs, em, ops_f, ops_b, mask, seq_f, seq_b = inp
            fwd_args = (t.Mf, em, obs, t.isp, ops_f, mask, seq_f, profile)
            alpha = kernels.forward(*fwd_args, split=t.split)
            plain_fwd, alpha_ref = once_ms(
                lambda: kernels.forward_reference(*fwd_args))
            a_err = alpha_err(alpha, alpha_ref)
            del alpha_ref
            bwd_args = (t.Mb, em, obs, alpha, ops_b, mask, dec.K, 11, outs,
                        t.exp_times, seq_b, profile)
            got = kernels.backward_combine(*bwd_args)
            plain_bwd, want = once_ms(
                lambda: kernels.backward_combine_reference(*bwd_args))
            if outs.posterior:
                errs = backward_errors(kernels, got, want, P, exp_max, tol)
            else:
                errs = {n: (got[n] - want[n]).abs().max().item() / P
                        for n in ("posterior_sums", "major_minor_sums")}
            finite = all(bool(torch.isfinite(x).all())
                         for x in [alpha, *got.values()])
            prof = {}
            if profile == "fast" and outs.posterior:
                prof = profile_error(decs[mode, "exact"], kernels, inp, got,
                                     want, outs, tol)
            del want
            same = None
            if profile == "turbo":
                f_alpha, f_got = prev[label][1:]
                same = torch.equal(alpha, f_alpha) and all(
                    torch.equal(got[n], f_got[n]) for n in got)
            log(f"[variants] {bname} {label}: t0={t0} T={T} P={P} max|diff| "
                f"alpha (columns normalised) {a_err:.3g}, backward (sums /P,"
                f" mean /max time) {json.dumps(errs)} finite={finite}"
                + ("" if same is None else f" bit-equal to fast: {same}")
                + (f"; fast against exact {json.dumps(prof)}" if prof
                   else ""))
            over_pairs = [errs[k] for k in ("posterior_sums",
                                            "major_minor_sums")]
            per_pair = [v for k, v in errs.items() if k not in (
                "per_pair_map_ties", "posterior_sums", "major_minor_sums")]
            if not finite or max([a_err, *per_pair]) > tol \
                    or max(over_pairs) > sum_tol or same is False:
                raise AssertionError(
                    f"{bname} at {label}: alpha {a_err}, {errs} (atol {tol}, "
                    f"sums {sum_tol} per pair), turbo equal to fast: {same}")
            rf["max_abs_err"] = max(rf["max_abs_err"], a_err)
            rb["max_abs_err"] = max(rb["max_abs_err"], *(
                v for k, v in errs.items() if k != "per_pair_map_ties"))
            rb["errors"][label] = errs
            if prof:
                rb.setdefault("fast_vs_exact", {})[label] = prof
            key = "" if label == "main-path" else \
                "asmc_shape_" if label == "asmc-shape P=8192" else None
            if key is not None:
                reps = 10 if which == "all" else 3
                fb = kernels.BwdOutputs(posterior=True, threshold_sums=True) \
                    if which == "all" else outs
                fb_args = (*bwd_args[:8], fb, *bwd_args[9:])
                rf[key + "ms"] = median_ms(
                    lambda: kernels.forward(*fwd_args, split=t.split), reps)
                rb[key + "ms"] = median_ms(
                    lambda: kernels.backward_combine(*fb_args), reps)
                for r, o in ((rf, None), (rb, fb)):
                    b = decode_bound("forward" if o is None else "backward",
                                     T, P, dec.K, t.Mf.shape[0],
                                     mode == "sequence", profile, o)
                    r[key + "bound_ms"] = b["bound_ms"]
                    r[key + "bound_by"] = b["bound_by"]
                if which == "all":
                    rf["plain_ms"] = median_ms(
                        lambda: kernels.forward_reference(*fwd_args), 3)
                    rb["plain_ms"] = median_ms(
                        lambda: kernels.backward_combine_reference(*fb_args),
                        3)
                else:
                    rf["asmc_shape_plain_ms"] = plain_fwd
                    rb["asmc_shape_plain_ms"] = plain_bwd
            if profile == "fast":
                prev[label] = (pairs, alpha, got)
            else:
                del alpha, got
            if profile == "turbo":
                del prev[label]
        log(f"[variants] {fname}: " + json.dumps(rf))
        log(f"[variants] {bname}: " + json.dumps(
            {k: v for k, v in rb.items() if k != "errors"}))
    return res


def alpha_wall_bound(shape, name: str) -> dict:
    """Bound of one probe variant at ``shape``: the products' FLOP on bf16
    operands (T-1 products forward, T backward), the observations,
    emission rows, operators and alpha (every site or once per block;
    bf16) and the backward output."""
    from fastsmc_tpu_torch.probes.alpha_wall import VARIANTS
    kind, every, _ = VARIANTS[name]
    T, P, KC, KA = shape.T, shape.P, shape.KC, shape.KA
    rows = T if every else T // shape.S
    nbytes = 4 * (2 * T * P + 3 * T * KC + KC) + 2 * shape.G * KC * KC \
        + 4 * T + 2 * rows * KA * P + (4 * T * P if kind == "bwd" else 0)
    steps = T - 1 if kind == "fwd" else T
    return bound(nbytes, 2 * steps * P * KC * KC, "bf16")


def stored_rows_witness(alpha, chunk: int = 256) -> float:
    """What a probe forward that divides the carry by the sum of its stored
    rows (instead of all KC) at every site would read against ``alpha``,
    the plain version that normalises at every site: alpha divided by the
    sum of its own rows, held by the forward's gate measure."""
    err = 0.0
    for t in range(0, alpha.shape[0], chunk):
        x = alpha[t:t + chunk].float()
        err = max(err, ((x / x.sum(dim=1, keepdim=True) - x).abs() / x)
                  .max().item())
    return err


def alpha_wall_phase(kernels):
    """Phase 13: the alpha-wall probe's two kernels. Each of the six
    variants against its plain version on the card at the probe's shape
    (P=8192) and with dead lanes (P=8187): alpha raw, within
    ALPHA_WALL_FWD_RTOL of the plain value at every element, the backward
    output within ALPHA_WALL_BWD_ATOL and its raw carry after
    ALPHA_WALL_CARRY_SITE within ALPHA_WALL_CARRY_RTOL. At P=8192, two
    forwards that normalise in the wrong place (at every site under block
    normalisation; by the stored rows' sum) must miss the alpha gate, and a
    backward that normalises at every site under block normalisation the
    carry gate. Then the
    probe's main() with the launch counts cleared, which times the six
    variants (median of 20 passes, CUDA events) and the alpha write and
    read costs. Returns (per-kernel rows, the probe's launches)."""
    import dataclasses
    from fastsmc_tpu_torch.probes import alpha_wall as aw
    shape = aw.Shape()
    res = {f"alpha_wall_{k}": {"max_abs_err": 0.0, "max_rel_err": 0.0,
                               "variants": {}}
           for k in ("forward", "backward")}
    witness, carry_witness, carries = {}, {}, {}
    site = ALPHA_WALL_CARRY_SITE
    for P in (shape.P, 8187):
        sh = dataclasses.replace(shape, P=P)
        inp = aw.make_inputs(sh, DEVICE)
        every_site = None
        for name, (kind, _, _) in aw.VARIANTS.items():
            carry_site = site if kind == "bwd" else None
            got = aw.run_variant(name, inp, sh, carry_site=carry_site)
            plain_ms, want = once_ms(
                lambda: aw.run_variant(name, inp, sh, plain=True,
                                       carry_site=carry_site))
            carry_rel = 0.0
            if kind == "bwd":
                (got, got_carry), (want, want_carry) = got, want
                carry_rel = aw.max_errors(got_carry, want_carry)[1]
                if P == shape.P:
                    carries[name] = want_carry
                del got_carry, want_carry
            err, rel = aw.max_errors(got, want)
            finite = bool(torch.isfinite(got.float()).all())
            del got
            gate_err, gate = (rel, ALPHA_WALL_FWD_RTOL) if kind == "fwd" \
                else (err, ALPHA_WALL_BWD_ATOL)
            log(f"[alpha-wall] {name} P={P}: max|diff| against the plain "
                f"version {err:.3g}, relative {rel:.3g}"
                + (f", raw carry after site {site} relative {carry_rel:.3g}"
                   if kind == "bwd" else "")
                + f", finite={finite}, plain {plain_ms:.1f} ms")
            if not finite or gate_err > gate \
                    or carry_rel > ALPHA_WALL_CARRY_RTOL:
                raise AssertionError(f"alpha-wall {name} at P={P}: {err} "
                                     f"(relative {rel}; gate {gate}), carry "
                                     f"{carry_rel} (gate "
                                     f"{ALPHA_WALL_CARRY_RTOL})")
            if P == shape.P and name == "fwd_store":
                every_site = want
                witness["divides by the stored rows' sum"] = \
                    stored_rows_witness(want)
            elif P == shape.P and name == "fwd_norm_block":
                witness["ignores NORM_BLOCK"] = aw.max_errors(every_site,
                                                              want)[1]
                every_site = None
            del want
            row = res["alpha_wall_" + ("forward" if kind == "fwd"
                                       else "backward")]
            v = row["variants"].setdefault(name, {"max_abs_err": 0.0,
                                                  "max_rel_err": 0.0})
            for r in (row, v):
                r["max_abs_err"] = max(r["max_abs_err"], err)
                r["max_rel_err"] = max(r["max_rel_err"], rel)
                if kind == "bwd":
                    r["carry_max_rel_err"] = max(
                        r.get("carry_max_rel_err", 0.0), carry_rel)
            if P == shape.P:
                v.update(plain_ms=plain_ms, **alpha_wall_bound(sh, name))
        del inp
        torch.cuda.empty_cache()
        if P == shape.P:
            carry_witness["ignores NORM_BLOCK"] = aw.max_errors(
                carries.pop("bwd_read"), carries.pop("bwd_norm_block"))[1]
            carries.clear()
    log("[alpha-wall] wrong forwards against the plain versions, relative "
        f"(gate {ALPHA_WALL_FWD_RTOL}): {json.dumps(witness)}; a wrong "
        f"backward's carry after site {site} (gate {ALPHA_WALL_CARRY_RTOL})"
        f": {json.dumps(carry_witness)}")
    if min(witness.values()) <= ALPHA_WALL_FWD_RTOL:
        raise AssertionError(f"the alpha gate passes a wrong forward: "
                             f"{witness}")
    if carry_witness["ignores NORM_BLOCK"] <= ALPHA_WALL_CARRY_RTOL:
        raise AssertionError(f"the carry gate passes a wrong backward: "
                             f"{carry_witness}")
    res["alpha_wall_forward"]["wrong_forwards_rel"] = witness
    res["alpha_wall_backward"]["wrong_backward_carry_rel"] = carry_witness
    probe, launches = run_leg(
        kernels, "alpha-wall probe",
        ("alpha_wall_forward", "alpha_wall_backward"),
        lambda: aw.main(["--reps", "20"]))
    for name, ms in probe["ms"].items():
        row = res["alpha_wall_" + ("forward" if name.startswith("fwd")
                                   else "backward")]
        row["variants"][name]["ms"] = ms
    for k, name in (("forward", "fwd_store"), ("backward", "bwd_read")):
        v = res[f"alpha_wall_{k}"]["variants"][name]
        res[f"alpha_wall_{k}"].update(
            {f: v[f] for f in ("ms", "plain_ms", "bound_ms", "bound_by")})
    log("[alpha-wall] " + json.dumps(
        {k: probe[k] for k in ("card", "ms", "alpha_GB_per_pass",
                               "write_cost_ms", "write_GB_per_s",
                               "read_cost_ms", "read_GB_per_s")})
        + f"; launches {launches}")
    log("[alpha-wall] variants: " + json.dumps(
        {k: r["variants"] for k, r in res.items()}))
    return res, launches


# the A/B's branches (mode, profile): turbo runs fast's instantiation
# (phase 10 holds it bit-equal)
AB_MODES = (("array", "exact"), ("sequence", "exact"), ("array", "fast"),
            ("sequence", "fast"))
# the forward's A/B windows (t0, T, P): the main-path window and the ASMC
# scale leg's batches (P=8192 and the last batch's 3,137); fast array also
# at the fast ASMC leg's batch (FAST_CAP_PAIRS)
AB_FWD_SHAPES = ((2048, 1024, 8192), (0, 8192, 8192), (0, 8192, 3137))
# the backward control's window and outputs: both sums at the ASMC shape
AB_BWD_SHAPE = (0, 8192, 8192)


def split_arg(k, tables) -> dict:
    """The forward's ``split`` argument for a side's kernels module ``k``
    whose wrapper takes one (a parent from before the TF32 split has
    none)."""
    if "split" in inspect.signature(k.forward).parameters:
        return {"split": tables.split}
    return {}


def unreduced(call, sides):
    """``call()`` with each side's ``block_reduce`` returning its input, so
    that the backward wrappers hand back the kernel's per-group partials."""
    saved = {k: k.block_reduce for k in sides}
    for k in sides:
        k.block_reduce = lambda part: part
    try:
        return call()
    finally:
        for k, f in saved.items():
            k.block_reduce = f


def equal_bits(a, b, chunk: int = 256) -> bool:
    """torch.equal over chunks of sites: no full-size temporary."""
    return a.shape == b.shape and all(
        torch.equal(a[i:i + chunk], b[i:i + chunk])
        for i in range(0, a.shape[0], chunk))


def all_finite(a, chunk: int = 256) -> bool:
    return all(bool(torch.isfinite(a[i:i + chunk]).all())
               for i in range(0, a.shape[0], chunk))


def ab_forward_cases():
    """(mode, profile, t0, T, P) of the forward A/B."""
    cases = [(m, p, *shape) for m, p in AB_MODES for shape in AB_FWD_SHAPES]
    return cases + [("array", "fast", 0, 8192, FAST_CAP_PAIRS)]


def load_parent(parent: str) -> None:
    """Register the package of the checkout at ``parent`` as
    ``parent_port``, so that its modules (which import each other
    relatively) import under that name."""
    import types
    if "parent_port" in sys.modules:
        return
    # a parent from before the port owned its host modules imports
    # fastsmc_tpu, whose __init__ imports JAX unless this is set
    os.environ.setdefault("FASTSMC_TPU_NO_CACHE", "1")
    pkg = types.ModuleType("parent_port")
    pkg.__path__ = [os.path.join(parent, "fastsmc_tpu_torch")]
    sys.modules[pkg.__name__] = pkg


def ab_parent(parent: str, decs, kernels, info, reps: int = 3) -> dict:
    """This tree's forward kernel against the parent checkout's at
    ``parent``, each called through its own checkout's wrappers
    (``kernels.forward`` / ``backward_combine``, the parent's package
    loaded under another name), on the same inputs: every forward branch
    (AB_MODES) at AB_FWD_SHAPES and fast array at FAST_CAP_PAIRS, alpha
    within KERNEL_ATOL (exact, raw) or APPROX_ATOL[mode] (fast, columns
    normalised) of the parent's, and equal to it bit for bit on the bf16
    array branch, which keeps the parent's FFMA kernel; the backward at
    AB_BWD_SHAPE on one alpha (this tree's) fed to both sides as the
    control, every output (the sums' per-group partials) equal to the
    parent's bit for bit. Median of 10
    calls a side at T=1024 and of 3 at T=8192, the sides in turns (parent,
    this; this, parent; ...), ``reps`` times each. Logs both builds' ptxas
    lines and SASS counts (fastsmc_tpu_torch.probes.sass) for both decode
    kernels at this model's K."""
    import importlib
    from fastsmc_tpu_torch.probes import sass
    load_parent(parent)
    pinfo = importlib.import_module("parent_port.engine._build").build()
    pk = importlib.import_module("parent_port.engine.kernels")
    log(f"[a/b] parent library built in {pinfo.seconds:.1f} s")
    rpw = decs["array", "exact"].tables.KP // 8
    for side, bi in (("parent", pinfo), ("this", info)):
        for kernel in DECODE_KERNELS:
            for fn, r in sass.sass_report(bi.path, bi.log, kernel,
                                          rpw).items():
                log(f"[a/b] {side}: {fn}: ptxas {r['ptxas']}; SASS total "
                    f"{json.dumps(r['total'])}; densest loop "
                    f"{json.dumps(r['densest_loop'])}")
    sides = {"parent": pk, "this": kernels}
    res = {}

    def turns(what, call, n, check):
        times = {"parent": [], "this": []}
        for r in range(reps):
            order = ("parent", "this") if r % 2 == 0 else ("this", "parent")
            for side in order:
                times[side].append(median_ms(lambda: call(sides[side]), n))
        res[what] = times
        log(f"[a/b] {what}, median ms of {n} per turn, in turns: "
            f"{json.dumps(times)}; {check}")

    rng = np.random.default_rng(5)
    for mode, profile, t0, T, P in ab_forward_cases():
        dec = decs[mode, profile]
        t = dec.tables
        obs, em, ops_f, _, mask, seq_f, _ = window_inputs(
            dec, *random_pairs(rng, t.hap_bits.shape[0], P), t0, T)
        what = f"{mode} {profile} forward, T={T} P={P}"

        def fwd(k):
            return k.forward(t.Mf, em, obs, t.isp, ops_f, mask, seq_f,
                             profile, **split_arg(k, t))

        a = fwd(kernels)
        b = fwd(pk)
        if mode == "array" and profile != "exact":
            # the bf16 array branch keeps the parent's FFMA kernel
            err, tol = (0.0 if equal_bits(a, b) else float("inf")), 0.0
            check = "alpha equal to the parent's bit for bit"
        else:
            if profile == "exact":
                err, tol = (a - b).abs().max().item(), KERNEL_ATOL
            else:
                err, tol = alpha_err(a, b, 128), APPROX_ATOL[mode]
            check = f"alpha within {err:.3g} of the parent's (atol {tol})"
        finite = all_finite(a)
        del a, b
        torch.cuda.empty_cache()
        if not finite or err > tol:
            raise AssertionError(f"a/b: {what}: alpha differs from the "
                                 f"parent's by {err} (atol {tol}), finite="
                                 f"{finite}")
        turns(what, fwd, 10 if T <= 1024 else 3, check)
    for mode, profile in AB_MODES:
        dec = decs[mode, profile]
        t = dec.tables
        t0, T, P = AB_BWD_SHAPE
        obs, em, ops_f, ops_b, mask, seq_f, seq_b = window_inputs(
            dec, *random_pairs(rng, t.hap_bits.shape[0], P), t0, T)
        alpha = kernels.forward(t.Mf, em, obs, t.isp, ops_f, mask, seq_f,
                                profile, t.split)
        what = f"{mode} {profile} backward (control, both sums), T={T} P={P}"

        def call(k):
            return k.backward_combine(
                t.Mb, em, obs, alpha, ops_b, mask, dec.K, 11,
                k.BwdOutputs(posterior=False, posterior_sums=True,
                             major_minor_sums=True),
                t.exp_times, seq_b, profile)

        a, b = unreduced(lambda: [call(k) for k in sides.values()],
                         sides.values())
        if a.keys() != b.keys() or not all(torch.equal(a[n], b[n])
                                           for n in a):
            raise AssertionError(f"a/b: {what} differs from the parent's "
                                 "bits")
        del a, b
        turns(what, call, 3, "outputs equal bit for bit")
        del alpha
        torch.cuda.empty_cache()
    return res


def forward_reference_f64(kernels, Mf, em, obs, isp, ops, mask, seq,
                          profile):
    """kernels.forward_reference with every operator product summed in f64
    (the operands as the profile rounds them), rounded once to f32: the
    same recursion with sums free of f32 rounding."""
    rnd = kernels._bf16 if profile != "exact" else (lambda x: x)
    norm_block = profile != "exact" and seq is None
    T = obs.shape[0]
    M = rnd(Mf.index_select(0, ops).float()).double()
    if seq is not None:
        M2 = rnd(Mf.index_select(0, seq.rops).float()).double()
    alpha = torch.empty((T, Mf.shape[-1], obs.shape[2]),
                        dtype=kernels.alpha_dtype(profile), device=obs.device)
    c = isp[:, None] * kernels._emission(em[0], obs[0])
    c = c / c.sum(dim=0, keepdim=True)
    alpha[0] = c
    for t in range(1, T):
        if seq is None:
            c = (M[t] @ rnd(c).double()).float() \
                * kernels._emission(em[t], obs[t])
        else:
            mid = (M[t] @ rnd(c).double()).float() * seq.hem[t][:, None]
            c = (M2[t] @ rnd(mid).double()).float() \
                * kernels._emission(em[t], obs[t])
        if norm_block:
            if t % kernels.BLOCK_SITES == kernels.BLOCK_SITES - 1:
                c = c * (1.0 / c.sum(dim=0, keepdim=True))
        else:
            s = c.sum(dim=0, keepdim=True)
            c = c * torch.where(mask[t] != 0, 1.0 / s, 1.0)
        alpha[t] = c
    return alpha


def forward_sum_orders(decs, kernels) -> dict:
    """How far each forward branch's kernel is from its plain f32 version,
    beside how far the plain version with f64 sums (forward_reference_f64)
    is from it, and the kernel from the f64 one: alpha with columns
    normalised, largest difference over the pairs, at T=1024 (P=8187) and
    at the ASMC shape (T=8192, P=8192). A tensor-core kernel adds with
    truncation and with the operators' diagonal last; its readings against
    the f32 sums are those of exact-arithmetic sums."""
    rng = np.random.default_rng(17)
    res = {}
    for mode, profile in AB_MODES:
        dec = decs[mode, profile]
        t = dec.tables
        for t0, T, P in ((2048, 1024, 8187), (0, 8192, 8192)):
            obs, em, ops_f, _, mask, seq_f, _ = window_inputs(
                dec, *random_pairs(rng, t.hap_bits.shape[0], P), t0, T)
            args = (t.Mf, em, obs, t.isp, ops_f, mask, seq_f, profile)
            plain = kernels.forward_reference(*args)
            f64 = forward_reference_f64(kernels, *args)
            kern = kernels.forward(*args, split=t.split)
            row = {"kernel vs plain": alpha_err(kern, plain, 256),
                   "f64 sums vs plain": alpha_err(f64, plain, 256),
                   "kernel vs f64 sums": alpha_err(kern, f64, 256)}
            del plain, f64, kern
            torch.cuda.empty_cache()
            res[f"{mode} {profile} T={T} P={P}"] = row
            log(f"[a/b] forward sum orders, {mode} {profile}, T={T} P={P}, "
                f"alpha (columns normalised): {json.dumps(row)}")
    return res


def batch_invariance(decs, kernels, T: int = 1024, P: int = 8192,
                     n: int = 3137) -> None:
    """The same ``n`` pairs as the first ``n`` of a P-pair launch and
    alone: their alpha from the forward kernel, and on one alpha their
    posterior, threshold sums, means and MAP states from the backward,
    equal bit for bit, in array and sequence mode, exact and fast."""
    rng = np.random.default_rng(9)
    per_pair = ("posterior", "threshold_sums", "per_pair_mean",
                "per_pair_map")
    outs = kernels.BwdOutputs(**{k: k in per_pair
                                 for k in kernels.KERNEL_OUTPUTS})
    for mode, profile in AB_MODES:
        dec = decs[mode, profile]
        t = dec.tables
        obs, em, ops_f, ops_b, mask, seq_f, seq_b = window_inputs(
            dec, *random_pairs(rng, t.hap_bits.shape[0], P), 2048, T)

        def fwd(obs):
            return kernels.forward(t.Mf, em, obs, t.isp, ops_f, mask, seq_f,
                                   profile, t.split)

        alpha = fwd(obs)
        obs_n = obs[..., :n].contiguous()
        same = {"alpha": torch.equal(alpha[..., :n], fwd(obs_n))}

        def bwd(obs, alpha):
            return kernels.backward_combine(
                t.Mb, em, obs, alpha, ops_b, mask, dec.K, 11, outs,
                t.exp_times, seq_b, profile)

        full = bwd(obs, alpha)
        alone = bwd(obs_n, alpha[..., :n].contiguous())
        same.update({k: torch.equal(full[k][..., :n], alone[k])
                     for k in per_pair})
        log(f"[kernels] batch invariance, {mode} {profile}: pairs 0..{n - 1}"
            f" of a {P}-pair launch and alone, T={T}, bit-equal: "
            f"{json.dumps(same)}")
        if not all(same.values()):
            raise AssertionError(f"batch invariance ({mode}, {profile}): "
                                 f"{same}")
        del full, alone, alpha
        torch.cuda.empty_cache()


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


def decompressed_sha256(path: str) -> str:
    with gzip.open(path, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


def golden_leg(FastSMC, DecodingParams, kernels) -> dict:
    """The example panel against the golden; then again with every
    extraction cap started at 8 (its batches hold at most 32 candidates,
    so the usual caps never overflow there): the batches are redone at
    grown caps, and the output must equal the first run's byte for byte
    (decompressed)."""
    def run(tag, caps=None):
        f = FastSMC(DecodingParams.fastsmc_defaults(
            EXAMPLE, DQ, os.path.join(OUT, tag), use_known_seed=True),
            device=DEVICE)
        if caps:
            f._seg_cap = f._kept_cap = f._pps_cap = caps
        t0 = time.perf_counter()
        path, launches = run_leg(kernels, f"FastSMC golden ({tag})",
                                 DECODE_KERNELS, lambda: f.run(verbose=False))
        return f, path, launches, time.perf_counter() - t0

    f, path, launches, wall = run("example")
    got = read_records(path)
    rel = compare_records(got, read_records(GOLDEN), "golden leg")
    log(f"[golden] {len(got)} records, keys equal in order, float max rel "
        f"{rel:.3g}, wall {wall:.2f} s, launches {launches}")
    g, tiny, n, wall = run("example_tiny_caps", caps=8)
    same = decompressed_sha256(tiny) == decompressed_sha256(path)
    log(f"[golden] caps started at 8: {g.stats['overflow_redos']} overflow "
        f"redos (default caps: {f.stats['overflow_redos']}), caps grown to "
        f"raw {g._seg_cap} / kept {g._kept_cap} / ages {g._pps_cap}, output "
        f"equal byte for byte: {same}, wall {wall:.2f} s, launches {n}")
    if not same or g.stats["overflow_redos"] < 1:
        raise AssertionError("overflow redo leg: the tiny-cap run's output "
                             "differs or nothing overflowed")
    for k, v in n.items():
        launches[k] = launches.get(k, 0) + v
    return launches, path


def options_leg(FastSMC, DecodingParams, kernels) -> dict:
    """The example panel with sort_batches=8, bucket_sites=0 and
    permissive_window=True, each against the JAX package's records
    (tests/fixtures/example_array.<tag>.FastSMC.ibd.gz)."""
    launches = {}
    for tag, kw, pkw in (("sort8", dict(sort_batches=8), {}),
                         ("arrival", dict(bucket_sites=0), {}),
                         ("permissive", {}, dict(permissive_window=True))):
        params = DecodingParams.fastsmc_defaults(
            EXAMPLE, DQ, os.path.join(OUT, f"example_{tag}"),
            use_known_seed=True, **pkw)
        path, n = run_leg(kernels, f"FastSMC {tag}", DECODE_KERNELS,
                          lambda: FastSMC(params, device=DEVICE, **kw)
                          .run(verbose=False))
        got = read_records(path)
        rel = compare_records(got, read_records(os.path.join(
            REPO, "tests", "fixtures", f"example_array.{tag}.FastSMC.ibd.gz")),
            f"{tag} leg")
        log(f"[options] {tag} ({kw or pkw}): {len(got)} records, keys equal "
            f"in order to the JAX package's, float max rel {rel:.3g}, "
            f"launches {n}")
        for k, v in n.items():
            launches[k] = launches.get(k, 0) + v
    return launches


def scale_params(DecodingParams, tag: str):
    """The scale leg's configuration: batch 8192, min_m 1.5, the
    reference's default 13-column records (ages on)."""
    return DecodingParams(
        fastsmc=True, hashing=True, batch_size=8192, in_file_root=OUT,
        out_file_root=os.path.join(OUT, tag), decoding_quant_file=DQ,
        min_m=1.5, use_known_seed=True, output_ibd_segment_length=True,
        do_per_pair_posterior_mean=True, do_per_pair_map=True).finalize()


def check_no_sync(f) -> dict:
    """Queue every flush group of ``f`` after its first under
    torch.cuda.set_sync_debug_mode("error"), so that a call that waits for
    the card raises; the drains (the wait on each group's event) stay
    outside. Returns the count of groups checked, filled in as it runs."""
    checked = {"groups": 0, "calls": 0}
    queue = f._queue_group

    def queue_checked(entries):
        checked["calls"] += 1
        if checked["calls"] == 1:
            return queue(entries)
        torch.cuda.set_sync_debug_mode("error")
        try:
            res = queue(entries)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        checked["groups"] += 1
        return res

    f._queue_group = queue_checked
    return checked


def scale_leg(FastSMC, DecodingParams, kernels, data, profile="exact"):
    """Twice on ``profile``; on the exact profile the first run's flush
    groups after its first are queued under check_no_sync. Returns
    (launches, the second run's records file, its row)."""
    runs = []
    dq = None
    tag = "scale" if profile == "exact" else f"scale_{profile}"
    for i in range(2):
        f = FastSMC(scale_params(DecodingParams, f"{tag}{i}"), data=data,
                    dq=dq, device=DEVICE, decode_profile=profile)
        dq = f.dq
        checked = check_no_sync(f) if profile == "exact" and i == 0 \
            else None
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        path, launches = run_leg(kernels, f"FastSMC scale ({profile})",
                                 decode_kernels(kernels, "array", profile),
                                 lambda: f.run(verbose=False))
        wall = time.perf_counter() - t0
        row = dict(profile=profile, run="cold" if i == 0 else "warm",
                   wall_s=wall, candidates=f._cpt, records=f.n_segments,
                   candidates_per_s=f._cpt / wall,
                   decoded_site_pairs=f.stats["decoded_site_pairs"],
                   cand_site_pairs=f.stats["cand_site_pairs"],
                   flushes=f.stats["flushes"],
                   overflow_redos=f.stats["overflow_redos"],
                   max_memory_allocated=torch.cuda.max_memory_allocated(),
                   launches=launches, phase_s=f.timer.totals(),
                   roofline=f.roofline(), sha256=decompressed_sha256(path))
        if checked is not None:
            row["groups_queued_without_sync"] = checked["groups"]
            if checked["groups"] < 1:
                raise AssertionError("scale leg: no flush group was queued "
                                     "under the sync check")
        log("[scale] " + json.dumps(row))
        runs.append(row)
        if i == 0:
            os.remove(path)
    if runs[0]["sha256"] != runs[1]["sha256"] \
            or runs[0]["records"] != runs[1]["records"]:
        raise AssertionError(f"scale leg ({profile}): the two runs' "
                             "outputs differ")
    log(f"[scale] {profile}: both runs wrote identical decompressed output")
    return runs[1]["launches"], path, runs[1]


def resume_leg(FastSMC, DecodingParams, kernels, data, want: str) -> dict:
    """The exact scale leg stopped by an exception in the drain after its
    first checkpoint (about 18 drains at flush group 8: the records of
    that drain follow the checkpoint, and a group is in flight), then
    resumed by a fresh FastSMC: its decompressed output must have sha256
    ``want`` (the uninterrupted leg's), and no .progress may be left."""
    class Interrupted(Exception):
        pass

    params = scale_params(DecodingParams, "scale_resume")
    out = params.ibd_output_path()
    progress = out + ".progress"
    for stale in (out, progress):
        if os.path.exists(stale):
            os.remove(stale)
    f = FastSMC(params, data=data, device=DEVICE)
    drain = f._drain_group

    def drain_then_stop():
        after_checkpoint = os.path.exists(progress)
        drain()
        if after_checkpoint:
            raise Interrupted()

    f._drain_group = drain_then_stop
    try:
        f.run(verbose=False)
        raise AssertionError("resume leg: the run ended before a drain "
                             "followed its first checkpoint")
    except Interrupted:
        pass
    f._writer.close()
    torch.cuda.synchronize()
    with open(progress) as fh:
        done, nseg, offset = map(int, fh.read().split())
    written = os.path.getsize(out)
    g = FastSMC(params, data=data, dq=f.dq, device=DEVICE)
    t0 = time.perf_counter()
    path, launches = run_leg(kernels, "FastSMC resume", DECODE_KERNELS,
                             lambda: g.run(verbose=False, resume=True))
    wall = time.perf_counter() - t0
    digest = decompressed_sha256(path)
    log(f"[resume] stopped after batch {f._batch_idx} with the checkpoint "
        f"at batch {done} ({nseg} records, byte {offset} of {written}); "
        f"resumed: {g._resume_skip} batches skipped, {g.n_segments} "
        f"records in {wall:.2f} s, output equal to the uninterrupted "
        f"run's: {digest == want}, .progress left: "
        f"{os.path.exists(progress)}, launches {launches}")
    if digest != want or os.path.exists(progress) or written <= offset \
            or g._resume_skip != done:
        raise AssertionError("resume leg failed")
    return launches


def fastsmc_ab(parent: str, FastSMC, DecodingParams, data) -> None:
    """The exact FastSMC scale leg of this tree against the parent
    checkout's (``--fastsmc-parent``), each through its own package on one
    card: one unprofiled run a side, then profiled runs in turns (parent,
    this, this, parent; :func:`device_profile`) with roofline() where the
    side has one and peak memory. This tree's records must have the
    parent's keys in the parent's order with floats within GOLDEN_RTOL,
    and each side's runs must write the same bytes."""
    import importlib
    load_parent(parent)
    sides = {"parent": (
        importlib.import_module("parent_port.pipelines.fastsmc").FastSMC,
        importlib.import_module("parent_port.config").DecodingParams),
        "this": (FastSMC, DecodingParams)}
    digests = {"parent": set(), "this": set()}
    paths = {}
    for i, (side, profiled) in enumerate(
            (("parent", False), ("this", False), ("parent", True),
             ("this", True), ("this", True), ("parent", True))):
        cls, params = sides[side]
        f = cls(scale_params(params, f"ab_{side}_{i}"), data=data,
                device=DEVICE)
        torch.cuda.reset_peak_memory_stats()
        if profiled:
            row = device_profile(lambda: f.run(verbose=False),
                                 KERNEL_GROUPS)
        else:
            t0 = time.perf_counter()
            f.run(verbose=False)
            torch.cuda.synchronize()
            row = dict(wall_s=time.perf_counter() - t0)
        path = f.params.ibd_output_path()
        digests[side].add(decompressed_sha256(path))
        paths[side] = path
        row.update(side=side, profiled=profiled, records=f.n_segments,
                   flushes=f.stats["flushes"],
                   max_memory_allocated=torch.cuda.max_memory_allocated(),
                   roofline=f.roofline() if hasattr(f, "roofline") else None,
                   phase_s=f.timer.totals())
        log("[fastsmc a/b] " + json.dumps(row))
    rel = compare_records(read_records(paths["this"]),
                          read_records(paths["parent"]), "fastsmc a/b")
    log(f"[fastsmc a/b] this tree's records have the parent's keys in the "
        f"parent's order, float max rel {rel:.3g}; runs identical within "
        f"each side: {json.dumps({k: len(v) == 1 for k, v in digests.items()})}")
    if any(len(v) != 1 for v in digests.values()):
        raise AssertionError("fastsmc a/b: a side's runs differ")


def seq_golden_leg(FastSMC, DecodingParams, kernels) -> dict:
    """Sequence mode on the example panel against the JAX package's
    records (tests/fixtures/example_array.seq.FastSMC.ibd.gz)."""
    params = DecodingParams.fastsmc_defaults(
        EXAMPLE, DQ, os.path.join(OUT, "example_seq"), use_known_seed=True,
        decoding_mode="sequence")
    path, launches = run_leg(
        kernels, "FastSMC sequence golden",
        decode_kernels(kernels, "sequence", "exact"),
        lambda: FastSMC(params, device=DEVICE).run(verbose=False))
    got = read_records(path)
    rel = compare_records(got, read_records(SEQ_GOLDEN), "seq golden leg")
    log(f"[seq-golden] {len(got)} records, keys equal in order to the JAX "
        f"package's, float max rel {rel:.3g}, launches {launches}")
    return launches


def fastsmc_profiles_leg(FastSMC, DecodingParams, kernels) -> dict:
    """The example panel on the fast and turbo profiles: the same bytes,
    and bp-F1 >= F1_MIN against the exact golden."""
    from fastsmc_tpu_torch.probes.f1 import f1_scores
    launches, digests, path = {}, {}, None
    for profile in ("fast", "turbo"):
        params = DecodingParams.fastsmc_defaults(
            EXAMPLE, DQ, os.path.join(OUT, f"example_{profile}"),
            use_known_seed=True)
        path, n = run_leg(
            kernels, f"FastSMC {profile}",
            decode_kernels(kernels, "array", profile),
            lambda: FastSMC(params, device=DEVICE,
                            decode_profile=profile).run(verbose=False))
        launches.update(n)
        with gzip.open(path, "rb") as fh:
            digests[profile] = hashlib.sha256(fh.read()).hexdigest()
    f1 = f1_scores(GOLDEN, path)
    log(f"[profiles] example panel: turbo output equal to fast: "
        f"{digests['fast'] == digests['turbo']}; against the exact golden "
        f"{json.dumps(f1)}; launches {launches}")
    if digests["fast"] != digests["turbo"] or f1["bp_f1"] < F1_MIN:
        raise AssertionError(f"profiles leg: {digests} {f1}")
    return launches


def no_hashing_leg(FastSMC, DecodingParams, kernels, data) -> dict:
    """FastSMC without hashing: every pair of job 1 of 25 (1,794 pairs of
    the example panel) over the whole chromosome, batch 256; then job 1 of
    400 (112 pairs) on the card against the plain versions on the CPU."""
    def params(tag, jobs):
        return DecodingParams.fastsmc_defaults(
            EXAMPLE, DQ, os.path.join(OUT, tag), use_known_seed=True,
            hashing=False, jobs=jobs, job_ind=1, batch_size=256)

    f = FastSMC(params("nohash", 25), data=data, device=DEVICE)
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
                               device=DEVICE).run(verbose=False))
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

def asmc_golden_leg(ASMC, DecodingParams, kernels, data,
                    mode: str = "array") -> dict:
    golden = ASMC_GOLDEN if mode == "array" else SEQ_ASMC_GOLDEN
    params = DecodingParams.asmc(
        EXAMPLE, DQ, os.path.join(OUT, f"asmc_golden_{mode}"),
        use_known_seed=True, do_posterior_sums=True,
        do_major_minor_posterior_sums=True, jobs=100, job_ind=7,
        decoding_mode=mode)
    a = ASMC(params, data=data, device=DEVICE, batch_size=64)
    start, end = a._job_pair_range()
    res, launches = run_leg(
        kernels, f"ASMC golden ({mode})",
        (*decode_kernels(kernels, mode, "exact"), "hmm_block_reduce"),
        lambda: a.decode_all_in_job(verbose=False))
    want = np.load(golden)
    errs = {f: float(np.abs(getattr(res, f) - want[f]).max()) for f in SUMS}
    log(f"[asmc-golden] {mode} mode, pairs {start}..{end - 1}: max|diff| vs "
        f"the JAX golden {json.dumps(errs)} (gate "
        f"{KERNEL_ATOL * (end - start):g}), launches {launches}")
    if max(errs.values()) > KERNEL_ATOL * (end - start):
        raise AssertionError(f"ASMC golden leg ({mode}): {errs}")
    return launches


def asmc_profiles_leg(ASMC, DecodingParams, kernels, data) -> dict:
    """Sequence mode on the fast and turbo profiles, the golden's job:
    turbo's sums equal fast's bit for bit, and fast's are within
    PROFILE_SUM_ATOL per pair of the exact golden."""
    want = np.load(SEQ_ASMC_GOLDEN)
    launches, sums = {}, {}
    for profile in ("fast", "turbo"):
        params = DecodingParams.asmc(
            EXAMPLE, DQ, os.path.join(OUT, f"asmc_seq_{profile}"),
            use_known_seed=True, do_posterior_sums=True,
            do_major_minor_posterior_sums=True, jobs=100, job_ind=7,
            decoding_mode="sequence")
        a = ASMC(params, data=data, device=DEVICE, batch_size=64,
                 decode_profile=profile)
        start, end = a._job_pair_range()
        res, n = run_leg(
            kernels, f"ASMC sequence {profile}",
            (*decode_kernels(kernels, "sequence", profile),
             "hmm_block_reduce"),
            lambda: a.decode_all_in_job(verbose=False))
        launches.update(n)
        sums[profile] = [getattr(res, f) for f in SUMS]
    same = all(np.array_equal(x, y) for x, y in zip(*sums.values()))
    errs = {f: float(np.abs(x - want[f]).max()) / (end - start)
            for f, x in zip(SUMS, sums["fast"])}
    log(f"[asmc-profiles] sequence mode, pairs {start}..{end - 1}: turbo "
        f"equal to fast: {same}; fast vs the exact golden, max|diff| per "
        f"pair {json.dumps(errs)} (gate {PROFILE_SUM_ATOL}); launches "
        f"{launches}")
    if not same or max(errs.values()) > PROFILE_SUM_ATOL:
        raise AssertionError(f"ASMC profiles leg: {same} {errs}")
    return launches


def asmc_per_pair_leg(ASMC, DecodingParams, kernels, data,
                      profile: str = "exact", mesh=None, tag: str = ""):
    """The 150 within-sample pairs, batch 64, on ``profile`` (on ``mesh``
    where given; ``tag`` names the leg's files): streamed means and MAP
    states against the decode_pairs API for three pairs. Returns
    (launches, (means, MAP states))."""
    root = os.path.join(OUT, "asmc_pp" + ("" if profile == "exact" else
                                          f"_{profile}") + tag)
    params = DecodingParams.asmc(
        EXAMPLE, DQ, root, use_known_seed=True, within_only=True,
        do_per_pair_posterior_mean=True, do_per_pair_map=True)
    a = ASMC(params, data=data, device=DEVICE, batch_size=64,
             decode_profile=profile, mesh=mesh)
    _, launches = run_leg(kernels, f"ASMC per-pair ({profile})",
                          decode_kernels(kernels, "array", profile),
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
    log(f"[asmc-per-pair] {profile}, 150 pairs; pairs {pick.tolist()} vs "
        f"decode_pairs: means max rel {rel:.3g}, MAP equal {map_equal}, "
        f"launches {launches}")
    if rel > KERNEL_ATOL or not map_equal:
        raise AssertionError("per-pair streams disagree with decode_pairs")
    return launches, (means, maps)


def per_pair_profile_check(fast, exact) -> None:
    """The fast profile's per-pair streams against the exact profile's:
    means within relative PROFILE_MEAN_RTOL, MAP states equal at a share
    of at least PROFILE_MAP_AGREE of the pair-sites."""
    rel = float((np.abs(fast[0] - exact[0]) / np.abs(exact[0])).max())
    agree = float((fast[1] == exact[1]).mean())
    log(f"[asmc-per-pair] fast against exact: means max rel {rel:.4g} (gate "
        f"{PROFILE_MEAN_RTOL}), MAP states equal at {agree:.4f} of the "
        f"pair-sites (gate >= {PROFILE_MAP_AGREE})")
    if rel > PROFILE_MEAN_RTOL or agree < PROFILE_MAP_AGREE:
        raise AssertionError(f"ASMC fast per-pair streams: rel {rel}, MAP "
                             f"agreement {agree}")


def asmc_scale_leg(ASMC, DecodingParams, kernels, data, mode="array",
                   profile="exact", batch_size=8192, mesh=None, tag=""):
    """jobs=1000, job 1 of the scale panel's 2N^2 - N pairs, posterior sums
    and major/minor sums, twice, in batches of ``batch_size`` pairs (None:
    the cap ASMC sets from the card's free memory, taken by the first run
    and kept for the second), on ``mesh`` where given (``tag`` names the
    leg's files); returns (launches, the sums, the second run's row)."""
    runs, digests, sums = [], [], []
    dq = None
    tag = ("" if (mode, profile) == ("array", "exact") else
           f"_{mode}_{profile}") + tag
    for i in range(2):
        root = os.path.join(OUT, f"asmc_scale{tag}{i}")
        params = DecodingParams.asmc(
            OUT, DQ, root, use_known_seed=True, do_posterior_sums=True,
            do_major_minor_posterior_sums=True, jobs=1000, job_ind=1,
            decoding_mode=mode)
        torch.cuda.empty_cache()
        a = ASMC(params, data=data, dq=dq, device=DEVICE,
                 batch_size=batch_size or 1 << 30, decode_profile=profile,
                 mesh=mesh)
        if a.batch_size != (batch_size or a.batch_size):
            raise AssertionError(f"ASMC scale leg: batch {a.batch_size}, "
                                 f"not the first run's {batch_size}")
        batch_size = a.batch_size
        dq = a.dq
        start, end = a._job_pair_range()
        n = end - start
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res, launches = run_leg(
            kernels, f"ASMC scale ({mode}, {profile})",
            (*decode_kernels(kernels, mode, profile), "hmm_block_reduce"),
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
        row = dict(mode=mode, profile=profile,
                   shards=None if mesh is None else mesh.size,
                   run="cold" if i == 0 else "warm", pairs=n,
                   batch_size=a.batch_size,
                   batches=-(-n // a.batch_size), wall_s=wall,
                   pairs_per_s=n / wall,
                   site_pairs_per_s=n * data.sites / wall,
                   max_memory_allocated=torch.cuda.max_memory_allocated(),
                   row_sum_max_rel=row_rel, classes_vs_total_max_abs=mm_err,
                   launches=launches, sha256=digests[-1])
        del a, res                    # free the card for the next run's cap
        log("[asmc-scale] " + json.dumps(row))
        if row_rel > 1e-3 or mm_err > KERNEL_ATOL * n:
            raise AssertionError(f"ASMC scale leg: sums off: {row}")
        runs.append(row)
    if digests[0] != digests[1] or not all(
            np.array_equal(x, y) for x, y in zip(*sums)):
        raise AssertionError(f"ASMC scale leg ({mode}, {profile}): the two "
                             "runs' sums differ")
    log(f"[asmc-scale] {mode}, {profile}: both runs wrote byte-identical "
        "sumOverPairs, and the four sum matrices are equal bit for bit")
    return runs[1]["launches"], sums[1], runs[1]


def device_profile(run, groups) -> dict:
    """``run()`` under torch.profiler, ended by a synchronise: the wall, the
    device's busy time (the union of its kernels' and copies' intervals)
    and idle share, and device seconds by kernel group (``groups``: pairs
    of a name substring and a group; the rest is "other torch kernels");
    only the wall when the profiler saw no device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans, by_group = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        lo, hi = e.time_range.start, e.time_range.end
        spans.append((lo, hi))
        group = next((g for k, g in groups if k in e.name),
                     "other torch kernels")
        by_group[group] = by_group.get(group, 0.0) + (hi - lo) / 1e6
    busy, end = 0.0, -1.0
    for lo, hi in sorted(spans):
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    res = dict(wall_s=wall)
    if spans:
        res.update(device_busy_s=busy / 1e6,
                   device_idle_share=1 - busy / 1e6 / wall,
                   device_s_by_group=by_group)
    return res


KERNEL_GROUPS = (("hmm_backward", "backward"), ("hmm_forward", "forward"),
                 ("block_reduce", "reduction"), ("emcpy", "copies"),
                 ("emset", "copies"))


def profile_asmc_leg(ASMC, DecodingParams, data) -> dict:
    """The ASMC scale leg (array, exact, batch 8192) once more, warm, under
    torch.profiler (:func:`device_profile`); the other torch kernels are
    the prologue."""
    params = DecodingParams.asmc(
        OUT, DQ, os.path.join(OUT, "asmc_profiled"), use_known_seed=True,
        do_posterior_sums=True, do_major_minor_posterior_sums=True,
        jobs=1000, job_ind=1)
    a = ASMC(params, data=data, device=DEVICE, batch_size=8192)
    a.decode_all_in_job(verbose=False)
    res = device_profile(lambda: a.decode_all_in_job(verbose=False),
                         KERNEL_GROUPS)
    log("[asmc-scale] profiled warm run (array, exact): " + json.dumps(res))
    del a
    return res


def profile_fastsmc_leg(FastSMC, DecodingParams, kernels, data) -> dict:
    """The exact FastSMC scale leg once more, warm, under torch.profiler
    (:func:`device_profile`; the other torch kernels are the prologue and
    run extraction), with its roofline() and peak memory."""
    f = FastSMC(scale_params(DecodingParams, "scale_profiled"), data=data,
                device=DEVICE)
    torch.cuda.reset_peak_memory_stats()
    res, launches = run_leg(
        kernels, "FastSMC scale (profiled)", DECODE_KERNELS,
        lambda: device_profile(lambda: f.run(verbose=False), KERNEL_GROUPS))
    res.update(roofline=f.roofline(), overflow_redos=f.stats[
        "overflow_redos"], max_memory_allocated=torch.cuda
        .max_memory_allocated(), launches=launches)
    log("[scale] profiled warm run (exact): " + json.dumps(res))
    return launches, res


# ---------------------------------------------------------------------------
# 17.-18. the mesh on one card, and two processes over gloo
# ---------------------------------------------------------------------------

def pair_set(path: str, n: int = 6) -> set:
    """The records' first ``n`` columns, as a set."""
    return {tuple(r[:n]) for r in read_records(path)}


def mesh_golden_leg(FastSMC, DecodingParams, kernels, mesh, tag: str,
                    want: str, caps=None) -> dict:
    """The example panel's FastSMC golden run on ``mesh`` (every cap
    started at ``caps`` where given): its decompressed output must have
    sha256 ``want`` (phase 4's)."""
    f = FastSMC(DecodingParams.fastsmc_defaults(
        EXAMPLE, DQ, os.path.join(OUT, f"example_{tag}"),
        use_known_seed=True), mesh=mesh)
    if caps:
        f._seg_cap = f._kept_cap = f._pps_cap = caps
    path, launches = run_leg(kernels, f"FastSMC golden ({tag})",
                             DECODE_KERNELS, lambda: f.run(verbose=False))
    same = decompressed_sha256(path) == want
    log(f"[mesh] golden on {mesh.size} shards ({tag}): output equal to "
        f"phase 4's byte for byte: {same}, {f.stats['overflow_redos']} "
        f"overflow redos, launches {launches}")
    if not same or (caps and f.stats["overflow_redos"] < 1):
        raise AssertionError(f"mesh golden leg ({tag}) failed")
    return launches


def mesh_scale_leg(FastSMC, DecodingParams, kernels, data, mesh, tag: str,
                   want: str, phase5: dict):
    """The exact FastSMC scale leg on ``mesh``: once with its flush groups
    after the first queued under the sync check, once under torch.profiler
    (wall, device idle share); both outputs must have phase 5's sha256
    ``want``, and torch's current device must be where it was. Returns
    (launches, the rows)."""
    current = torch.cuda.current_device()
    rows, launches = [], {}
    for i in range(2):
        f = FastSMC(scale_params(DecodingParams, f"scale_{tag}{i}"),
                    data=data, mesh=mesh)
        checked = check_no_sync(f) if i == 0 else None
        torch.cuda.reset_peak_memory_stats()
        if i == 0:
            t0 = time.perf_counter()
            path, n = run_leg(kernels, f"FastSMC scale ({tag})",
                              DECODE_KERNELS, lambda: f.run(verbose=False))
            row = dict(run="sync-checked", wall_s=time.perf_counter() - t0,
                       groups_queued_without_sync=checked["groups"])
        else:
            row, n = run_leg(kernels, f"FastSMC scale ({tag}, profiled)",
                             DECODE_KERNELS, lambda: device_profile(
                                 lambda: f.run(verbose=False),
                                 KERNEL_GROUPS))
            row["run"] = "profiled"
            path = f.params.ibd_output_path()
        for k, v in n.items():
            launches[k] = launches.get(k, 0) + v
        row.update(shards=mesh.size, tag=tag, records=f.n_segments,
                   overflow_redos=f.stats["overflow_redos"],
                   max_memory_allocated=torch.cuda.max_memory_allocated(),
                   roofline=f.roofline(), launches=n,
                   sha256=decompressed_sha256(path),
                   current_device=torch.cuda.current_device())
        log("[mesh] " + json.dumps(row))
        rows.append(row)
        os.remove(path)
        if row["sha256"] != want or row["current_device"] != current \
                or (checked is not None and checked["groups"] < 1):
            raise AssertionError(f"mesh scale leg ({tag}): {row}")
    log(f"[mesh] scale leg on {mesh.size} shards ({tag}): phase 5's sha256 "
        f"in both runs; wall {rows[0]['wall_s']:.3f} s (sync-checked) / "
        f"{rows[1]['wall_s']:.3f} s (profiled), device idle "
        f"{rows[1].get('device_idle_share')}; phase 5: wall "
        f"{phase5['fastsmc_wall_s']}, phase 14: idle "
        f"{phase5['fastsmc_idle']}")
    return launches, rows


def mesh_phase(FastSMC, ASMC, DecodingParams, kernels, scale_data,
               example, ref: dict) -> dict:
    """Phase 17: the mesh on this card (two and four shards on cuda:0) and,
    where the machine has more cards, over the real devices. ``ref`` holds
    the meshless legs' results: phase 4's and 5's sha256, phase 8's sums,
    phase 7's streams, phase 5's wall and phase 14's idle share. Returns
    the launches of every leg."""
    from fastsmc_tpu_torch.parallel import make_mesh
    launches = {}

    def add(n):
        for k, v in n.items():
            launches[k] = launches.get(k, 0) + v

    meshes = [("one card x2", make_mesh(devices=["cuda:0"] * 2), "mesh2")]
    real = torch.cuda.device_count()
    if real > 1:
        S = 1 << (min(real, 8).bit_length() - 1)
        meshes.append((f"{S} cards", make_mesh(S), f"cards{S}"))
    else:
        log("[mesh] one card: the mesh runs its shards on cuda:0 one after "
            "the other; scaling over devices is not measured")
    for S in (1, 2, 4):
        add(mesh_golden_leg(FastSMC, DecodingParams, kernels,
                            make_mesh(devices=["cuda:0"] * S), f"mesh{S}",
                            ref["golden_sha256"]))
    add(mesh_golden_leg(FastSMC, DecodingParams, kernels,
                        make_mesh(devices=["cuda:0"] * 4), "mesh4_caps8",
                        ref["golden_sha256"], caps=8))
    for label, mesh, tag in meshes:
        if tag != "mesh2":
            add(mesh_golden_leg(FastSMC, DecodingParams, kernels, mesh, tag,
                                ref["golden_sha256"]))
        add(mesh_scale_leg(FastSMC, DecodingParams, kernels, scale_data,
                           mesh, tag, ref["scale_sha256"], ref)[0])
        torch.cuda.empty_cache()
        n, sums, row = asmc_scale_leg(ASMC, DecodingParams, kernels,
                                      scale_data, mesh=mesh, tag=f"_{tag}")
        add(n)
        rel = max(float((np.abs(x - y) / np.maximum(np.abs(y), 1e-30))
                        .max()) for x, y in zip(sums, ref["asmc_sums"]))
        log(f"[mesh] ASMC scale leg on {label}: the four sum matrices within "
            f"relative {rel:.3g} of phase 8's (gate 1e-6), wall "
            f"{row['wall_s']:.3f} s")
        if rel > 1e-6:
            raise AssertionError(f"mesh ASMC scale leg ({tag}): rel {rel}")
        torch.cuda.empty_cache()
        n, _ = asmc_per_pair_leg(ASMC, DecodingParams, kernels, example,
                                 mesh=mesh, tag=f"_{tag}")
        add(n)
        same = all(decompressed_sha256(
            os.path.join(OUT, f"asmc_pp_{tag}.{kind}.gz"))
            == decompressed_sha256(os.path.join(OUT, f"asmc_pp.{kind}.gz"))
            for kind in ("perPairPosteriorMeans", "perPairMAP"))
        log(f"[mesh] ASMC per-pair leg on {label}: streams equal to phase "
            f"7's byte for byte: {same}")
        if not same:
            raise AssertionError(f"mesh per-pair leg ({tag}) failed")
    return launches


def multihost_worker(rank: int, port: int, out: str) -> None:
    """One process of phase 18: joins the gloo group on localhost, runs its
    tiles of the example panel (jobs=4) on cuda:0 and prints its paths,
    the world size and its kernel launches as JSON."""
    import torch.distributed as dist
    from fastsmc_tpu_torch import DecodingParams
    from fastsmc_tpu_torch.engine import kernels
    from fastsmc_tpu_torch.parallel import multihost
    if multihost.initialize(f"localhost:{port}", 2, rank) != rank:
        raise AssertionError("multihost worker: wrong rank")
    params = DecodingParams.fastsmc_defaults(
        EXAMPLE, DQ, os.path.join(out, "mh"), use_known_seed=True)
    paths = multihost.run_fastsmc_multihost(params, device="cuda:0")
    torch.cuda.synchronize()
    print(json.dumps({"rank": dist.get_rank(), "world":
                      dist.get_world_size(), "paths": paths,
                      "launches": dict(kernels.LAUNCHES)}), flush=True)
    dist.barrier()          # neither leaves while the other uses the store
    dist.destroy_process_group()


def multihost_phase(want_path: str) -> dict:
    """Phase 18: two processes of this script join one gloo group on
    localhost and decode their tiles of the example panel (jobs=4) on
    cuda:0; the merged output must cover the pair set (first 6 columns)
    of phase 4's single run, and each process must have launched the
    decode kernels. Returns the two processes' launches."""
    import socket

    from fastsmc_tpu_torch.parallel import merge_ibd_outputs
    out = os.path.join(OUT, "multihost")
    os.makedirs(out, exist_ok=True)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--multihost-worker",
         str(rank), str(port), out], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for rank in range(2)]
    results = []
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=300)
            if p.returncode != 0:
                raise AssertionError(f"multihost worker failed:\n{stdout}\n"
                                     f"{stderr[-4000:]}")
            results.append(json.loads(stdout.splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    paths = [q for r in results for q in r["paths"]]
    merged = merge_ibd_outputs(paths, os.path.join(out, "merged.ibd.gz"))
    got, want = pair_set(merged), pair_set(want_path)
    launches = {}
    for r in results:
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    log(f"[multihost] 2 processes over gloo: ranks "
        f"{[r['rank'] for r in results]}, world sizes "
        f"{[r['world'] for r in results]}, {len(paths)} tiles, merged pair "
        f"set equal to phase 4's single run: {got == want} ({len(got)} "
        f"pairs), {wall:.1f} s with the processes' start, launches "
        f"{[r['launches'] for r in results]}")
    if got != want or not want or any(r["world"] != 2 for r in results) \
            or len(paths) != 4 or any(
                min(r["launches"].get(k, 0) for k in DECODE_KERNELS) < 1
                for r in results):
        raise AssertionError("multihost phase failed")
    return launches


def build_log(info, KP: int, K: int) -> None:
    """ptxas' registers and spills of the instantiations this model runs."""
    tag, fn = f"_kernelILi{KP // 8}E", None
    for line in info.log.splitlines():
        if "Compiling entry function" in line:
            fn = line
        elif fn and (tag in fn or "reduce" in fn) \
                and ("registers" in line or "spill" in line):
            kind = next(k for k in ("forward", "backward", "reduce")
                        if k in fn)
            flags = [f == "1" for f in re.findall(
                r"Lb([01])E", fn.split(tag, 1)[-1].split("EEv")[0])]
            if kind == "backward":
                full, *flags = flags
                outs = "all outputs" if full else \
                    "posterior, threshold sums"
            if "ffma" in fn:
                kind += " (array, bf16, FFMA)"
            elif kind != "reduce":
                seq, approx = flags
                kind += (f" ({'sequence' if seq else 'array'}, "
                         f"{'bf16' if approx else 'exact'}"
                         + (f", {outs}" if kind == "backward" else "") + ")")
            log(f"[build] {kind} kernel, K={K}: {line.strip()}")
        elif fn and "alpha_wall" in fn \
                and ("registers" in line or "spill" in line):
            kind = "forward" if "forward" in fn else "backward"
            every, norm = re.findall(r"Lb([01])E", fn)[:2]
            log(f"[build] alpha-wall {kind} kernel (every site {every}, "
                f"block normalisation {norm}): {line.strip()}")


def variant_decoders(DecodingParams, kernels, data) -> dict:
    """GpuDecoder per (mode, profile) on one panel's tables."""
    from fastsmc_tpu_torch.engine.oracle import DecodeContext
    from fastsmc_tpu_torch.io.decoding_quantities import DecodingQuantities
    dq = DecodingQuantities.load(DQ)
    decs = {}
    for mode in ("array", "sequence"):
        params = scale_params(DecodingParams, "kernels")
        params.decoding_mode = mode
        ctx = DecodeContext.build(params.finalize(), data, dq)
        for profile in kernels.PROFILES:
            decs[mode, profile] = kernels.GpuDecoder(ctx, DEVICE, profile)
    return decs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ab-parent", metavar="DIR",
                    help="A/B the decode kernels against the sources of the "
                    "checkout at DIR")
    ap.add_argument("--ab-only", action="store_true",
                    help="with --ab-parent: stop after the build, the A/B "
                    "and the batch-invariance check")
    ap.add_argument("--fastsmc-parent", metavar="DIR",
                    help="first A/B the exact FastSMC scale leg against the "
                    "checkout at DIR (wall, device idle share, roofline)")
    ap.add_argument("--multihost-worker", nargs=3,
                    metavar=("RANK", "PORT", "OUT"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.ab_only and not args.ab_parent:
        ap.error("--ab-only needs --ab-parent")
    # 1. the card
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    if args.multihost_worker:
        rank, port, out = args.multihost_worker
        multihost_worker(int(rank), int(port), out)
        return 0
    log(f"[card] {card_line()}")
    log(f"[card] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} devices {torch.cuda.device_count()}")
    os.makedirs(OUT, exist_ok=True)

    from fastsmc_tpu_torch import ASMC, DecodingParams, FastSMC, native
    from fastsmc_tpu_torch.engine import _build, kernels
    from fastsmc_tpu_torch.io.haps import load_data
    from fastsmc_tpu_torch.probes.biobank import make_panel
    from fastsmc_tpu_torch.probes.f1 import f1_scores

    # 2. build: the CUDA sources, and the native host library (without it
    # the scale legs would run the pure-Python scan)
    info = _build.build()
    log(f"[build] {info.path.name} in {info.seconds:.1f} s")
    t0 = time.perf_counter()
    if native.get_lib() is None:
        raise AssertionError("the native host library did not build or load "
                             f"({native.library_path()})")
    log(f"[build] native host library {native.library_path().name} loaded "
        f"in {time.perf_counter() - t0:.1f} s")

    def scale_panel():
        t0 = time.perf_counter()
        data = make_panel(SCALE_HAPS, seed=0)
        log(f"[scale] panel {data.n_haps} haps x {data.sites} sites in "
            f"{time.perf_counter() - t0:.1f} s")
        return data

    scale_data = None
    if args.fastsmc_parent:
        scale_data = scale_panel()
        fastsmc_ab(args.fastsmc_parent, FastSMC, DecodingParams, scale_data)
        torch.cuda.empty_cache()

    # 3. kernels vs plain versions, on the tables of a 4,096-hap panel
    decs = variant_decoders(DecodingParams, kernels,
                            make_panel(4096, seed=1))
    dec = decs["array", "exact"]
    build_log(info, dec.tables.KP, dec.K)
    if args.ab_parent:
        ab_parent(args.ab_parent, decs, kernels, info)
        forward_sum_orders(decs, kernels)
        if args.ab_only:
            batch_invariance(decs, kernels)
            log("[a/b] --ab-only: stopped after the A/B")
            return 0
    kres = compare_kernels(dec, kernels)
    batch_invariance(decs, kernels)
    torch.cuda.empty_cache()
    # 10. the sequence-mode and fast/turbo instantiations
    kres.update(compare_variants(decs, kernels))
    time_fast_cap(decs, kernels, kres)
    del dec, decs
    torch.cuda.empty_cache()

    # 4.-9., 11.-13. the legs; launches summed over every leg's own run, and
    # kept per scale leg
    launches: dict = {}
    per_leg: dict = {}

    def add(counts, leg=None):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        if leg:
            per_leg[leg] = dict(counts)

    # 13. the alpha-wall probe
    aw_rows, n = alpha_wall_phase(kernels)
    kres.update(aw_rows)
    add(n, "alpha_wall_probe")
    torch.cuda.empty_cache()

    if scale_data is None:
        scale_data = scale_panel()
    example = load_data(DecodingParams.asmc(EXAMPLE, DQ, OUT, fastsmc=True,
                                            use_known_seed=True))
    n, golden_path = golden_leg(FastSMC, DecodingParams, kernels)
    add(n)
    n, exact_records, row = scale_leg(FastSMC, DecodingParams, kernels,
                                      scale_data)
    add(n, "fastsmc_scale")
    mesh_ref = dict(golden_sha256=decompressed_sha256(golden_path),
                    scale_sha256=row["sha256"],
                    fastsmc_wall_s=row["wall_s"])
    # 14.-15. the exact scale leg profiled, then stopped and resumed
    n, res = profile_fastsmc_leg(FastSMC, DecodingParams, kernels,
                                 scale_data)
    add(n)
    mesh_ref["fastsmc_idle"] = res.get("device_idle_share")
    add(resume_leg(FastSMC, DecodingParams, kernels, scale_data,
                   row["sha256"]))
    torch.cuda.empty_cache()
    add(asmc_golden_leg(ASMC, DecodingParams, kernels, example))
    n, exact_streams = asmc_per_pair_leg(ASMC, DecodingParams, kernels,
                                         example)
    add(n)
    n, exact_sums, _ = asmc_scale_leg(ASMC, DecodingParams, kernels,
                                      scale_data)
    add(n, "asmc_scale")
    mesh_ref["asmc_sums"] = exact_sums
    profile_asmc_leg(ASMC, DecodingParams, scale_data)
    add(no_hashing_leg(FastSMC, DecodingParams, kernels, example))
    # 11. sequence mode
    add(asmc_golden_leg(ASMC, DecodingParams, kernels, example, "sequence"))
    add(seq_golden_leg(FastSMC, DecodingParams, kernels))
    add(asmc_scale_leg(ASMC, DecodingParams, kernels, scale_data,
                       mode="sequence")[0], "asmc_scale_sequence")
    # 12. the fast/turbo profiles; the fast ASMC leg takes the batch cap its
    # bf16 alpha allows
    n, fast_sums, row = asmc_scale_leg(ASMC, DecodingParams, kernels,
                                       scale_data, profile="fast",
                                       batch_size=None)
    add(n, "asmc_scale_fast")
    errs = {f: float(np.abs(x - y).max()) / row["pairs"]
            for f, x, y in zip(SUMS, fast_sums, exact_sums)}
    log(f"[asmc-scale] fast against exact, max|diff| per pair "
        f"{json.dumps(errs)} (gate {PROFILE_SUM_ATOL})")
    if max(errs.values()) > PROFILE_SUM_ATOL:
        raise AssertionError(f"ASMC fast scale leg: {errs}")
    n, fast_streams = asmc_per_pair_leg(ASMC, DecodingParams, kernels,
                                        example, "fast")
    add(n)
    per_pair_profile_check(fast_streams, exact_streams)
    n, fast_records, _ = scale_leg(FastSMC, DecodingParams, kernels,
                                   scale_data, profile="fast")
    add(n, "fastsmc_scale_fast")
    t0 = time.perf_counter()
    f1 = f1_scores(exact_records, fast_records)
    log(f"[scale] fast against exact records: {json.dumps(f1)} "
        f"({time.perf_counter() - t0:.1f} s)")
    if f1["bp_f1"] < F1_MIN:
        raise AssertionError(f"FastSMC fast scale leg: bp-F1 {f1}")
    add(asmc_profiles_leg(ASMC, DecodingParams, kernels, example))
    add(fastsmc_profiles_leg(FastSMC, DecodingParams, kernels))
    # 16. the entry options against the JAX package's records
    add(options_leg(FastSMC, DecodingParams, kernels))
    torch.cuda.empty_cache()
    # 17. the mesh on this card; 18. two processes over gloo
    add(mesh_phase(FastSMC, ASMC, DecodingParams, kernels, scale_data,
                   example, mesh_ref), "mesh")
    add(multihost_phase(golden_path), "multihost")

    # the port imports nothing of JAX or of the JAX package; an A/B parent
    # from before the port owned its host modules imports fastsmc_tpu, so
    # --ab-parent exempts that check (and says so)
    banned = ("jax", "jaxlib") if args.ab_parent else \
        ("jax", "jaxlib", "fastsmc_tpu", "scripts")
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in banned)
    if loaded:
        raise AssertionError(f"the run imported {loaded}")
    if args.ab_parent:
        log("[imports] --ab-parent: the parent checkout may import "
            "fastsmc_tpu; only jax and jaxlib were checked")
    log("[launches] per scale leg: " + json.dumps(per_leg))
    sources = {  # LAUNCHES key prefix -> (source, the TPU kernel it replaces)
        "hmm_forward": ("hmm_forward.cu", "fastsmc_tpu/engine/kernels.py:96"),
        "hmm_backward": ("hmm_backward.cu",
                         "fastsmc_tpu/engine/kernels.py:185"),
        # the over-pairs sums in _make_bwd_kernel's body
        "hmm_block_reduce": ("hmm_reduce.cu",
                             "fastsmc_tpu/engine/kernels.py:267"),
        "alpha_wall_forward": ("alpha_wall.cu",
                               "scripts/alpha_wall_probe.py:74"),
        "alpha_wall_backward": ("alpha_wall.cu",
                                "scripts/alpha_wall_probe.py:137")}
    rows = []
    for name, res in kres.items():
        src, replaces = next(v for k, v in sources.items()
                             if name.startswith(k))
        row = dict(name=name, route="cuda",
                   source=f"fastsmc_tpu_torch/csrc/{src}", replaces=replaces,
                   launches=launches.get(name, 0), library_ms=None)
        row.update(res)
        row["launches_per_leg"] = {leg: n.get(name, 0)
                                   for leg, n in per_leg.items()}
        rows.append(row)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    incomplete = [r["name"] for r in rows if any(k not in r for k in keys)]
    if incomplete:
        raise AssertionError(f"kernel rows without {keys}: {incomplete}")
    idle = [r["name"] for r in rows if r["launches"] < 1]
    if idle:
        raise AssertionError(f"no leg launched {idle}")
    print(card_line())
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
