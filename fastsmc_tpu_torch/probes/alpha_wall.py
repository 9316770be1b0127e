"""The alpha-wall probe on the card: is the alpha round trip through device
memory the wall of a decode pass, or are the operator products?

Counterpart of ``scripts/alpha_wall_probe.py``. Two CUDA kernels
(``csrc/alpha_wall.cu``, in a library of their own, :data:`LIBRARY`)
replace its Pallas kernels ``make_fwd`` (:74-108) and ``make_bwd``
(:137-155), each with a plain PyTorch version here. Six
variants at the probe's shape (KC=128 state rows, KA=72 stored rows, S=8
sites a block, P=8,192 pairs, T=4,096 sites, G=64 operators):

  fwd_store       forward: product, emission, column normalisation; alpha
                  [T, KA, P] bf16 stored at every site
  fwd_nostore     the same products, alpha stored once per S-site block
  bwd_read        backward-shaped pass: reads alpha at every site, product,
                  combine, per-pair sum of the first 10 posterior rows
  bwd_noread      the same products, alpha read once per block
  fwd_norm_block  fwd_store normalising the carry once per block
  bwd_norm_block  bwd_read normalising the carry once per block

If ``store - nostore`` and ``read - noread`` are large shares of a pass,
the alpha round trip is the wall and checkpointing alpha pays; if they are
near 0, the products are.

One fault of the TPU probe is repaired, not copied: ``make_bwd`` never
initialises its VMEM carry, so its output is undefined (Pallas interpret
mode starts scratch as NaN). Here the backward carry starts at 1/KC, as the
decoder's backward pass starts beta at 1/K.

    python -m fastsmc_tpu_torch.probes.alpha_wall [--device cuda|cpu]

prints each variant's median time (CUDA events, at least 20 passes after a
warm-up) and what the alpha write and read cost, and writes the numbers to
``build/alpha_wall/alpha_wall.json`` (``--out``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
from ctypes import c_int as _I, c_void_p as _P
from typing import Optional

import numpy as np
import torch

from ..engine import kernels
from ..engine._build import Library, load_library

# the probe's own library, apart from the decode kernels'
LIBRARY = Library("libfastsmc_alpha_wall", ("alpha_wall.cu",),
                  ("hmm_common.cuh",), {
    # M, G, em, obs, isp, ops, alpha, T, P, KC, KA, S, store_every,
    # norm_block, device, stream
    "fastsmc_alpha_wall_forward": [_P, _I, _P, _P, _P, _P, _P, _I, _I, _I,
                                   _I, _I, _I, _I, _I, _P],
    # M, G, em, obs, alpha, ops, out, carry, carry_site, T, P, KC, KA, S,
    # read_every, norm_block, device, stream
    "fastsmc_alpha_wall_backward": [_P, _I, _P, _P, _P, _P, _P, _P, _I, _I,
                                    _I, _I, _I, _I, _I, _I, _I, _P]})

POST_ROWS = 10          # posterior rows the backward pass sums per pair
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_OUT = os.path.join(REPO, "build", "alpha_wall", "alpha_wall.json")


@dataclasses.dataclass(frozen=True)
class Shape:
    """The probe's shape (``scripts/alpha_wall_probe.py:42-44``; its
    docstring's T=8192 is stale, the code runs 4096)."""
    KC: int = 128        # state rows of the carry and the operators
    KA: int = 72         # rows of alpha stored and read
    S: int = 8           # sites a block
    P: int = 8192        # pairs
    T: int = 4096        # sites
    G: int = 64          # distinct operators


# name -> (pass, alpha every site, normalise once per block)
VARIANTS = {
    "fwd_store": ("fwd", True, False),
    "fwd_nostore": ("fwd", False, False),
    "bwd_read": ("bwd", True, False),
    "bwd_noread": ("bwd", False, False),
    "fwd_norm_block": ("fwd", True, True),
    "bwd_norm_block": ("bwd", True, True),
}


def make_inputs(shape: Shape = Shape(), device="cuda", seed: int = 0) -> dict:
    """The probe's inputs from ``numpy.random.default_rng(seed)`` in the
    script's order (:49-58): operators ``M`` [G, KC, KC] (bf16, rounded
    through f32), emission rows ``em`` [T, 3, KC], observations ``obs``
    [T, 2, P] of 0/1, ``isp`` [KC], operator indices ``ops`` [T] (int32),
    and ``alpha`` [T, KA, P] bf16: a tile of min(64, T) random sites
    repeated over the window, made on ``device``."""
    s = shape
    rng = np.random.default_rng(seed)
    M = rng.random((s.G, s.KC, s.KC)) * 0.02
    em = rng.random((s.T, 3, s.KC))
    obs = rng.integers(0, 2, (s.T, 2, s.P), dtype=np.int8)
    isp = rng.random((1, s.KC))
    ops = rng.integers(0, s.G, s.T)
    rows = min(64, s.T)
    if s.T % rows:
        raise ValueError(f"T={s.T} is not a multiple of {rows}")
    tile = rng.random((rows, s.KA, s.P), dtype=np.float32)
    dev = torch.device(device)

    def f32(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)

    return dict(
        M=f32(M).to(torch.bfloat16), em=f32(em),
        obs=torch.from_numpy(obs).to(dev).float(), isp=f32(isp.reshape(-1)),
        ops=torch.from_numpy(ops.astype(np.int32)).to(dev),
        alpha=f32(tile).to(torch.bfloat16).repeat(s.T // rows, 1, 1))


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def forward_reference(M, em, obs, isp, ops, store_every: bool = True,
                      norm_block: bool = False, S: int = 8,
                      KA: int = 72) -> torch.Tensor:
    """``make_fwd(store_every, norm_block)``: alpha bf16 ``[T, KA, P]``
    (``store_every``) or ``[T/S, KA, P]``. Products of bf16-rounded
    operands in f32 (TF32 off)."""
    T, _, P = obs.shape
    Mf = M.float()
    ops = ops.tolist()
    alpha = torch.empty((T if store_every else T // S, KA, P),
                        dtype=torch.bfloat16, device=obs.device)
    c = None
    for t in range(T):
        e = kernels._emission(em[t], obs[t])
        c = isp[:, None] * e if t == 0 else \
            (Mf[ops[t]] @ kernels._bf16(c)) * e
        if not norm_block or t % S == S - 1:
            c = c / c.sum(dim=0, keepdim=True)
        if store_every:
            alpha[t] = c[:KA]
        elif t % S == S - 1:
            alpha[t // S] = c[:KA]
    return alpha


def backward_reference(M, em, obs, alpha, ops, read_every: bool = True,
                       norm_block: bool = False, S: int = 8,
                       carry_site: Optional[int] = None):
    """``make_bwd(read_every, norm_block)`` with the carry started at 1/KC:
    ``out`` f32 ``[T, 1, P]``, the sum of the first 10 rows of each site's
    normalised posterior. ``alpha`` is ``[T, KA, P]`` (``read_every``) or
    ``[T/S, KA, P]``. With ``carry_site``, returns ``(out, carry)``: the raw
    carry f32 ``[KC, P]`` after that site (the output is renormalised per
    column, so only the carry shows where the pass normalises)."""
    T, _, P = obs.shape
    KC = M.shape[-1]
    Mf = M.float()
    ops = ops.tolist()
    out = torch.empty((T, 1, P), dtype=torch.float32, device=obs.device)
    carry = torch.full((KC, P), 1.0 / KC, dtype=torch.float32,
                       device=obs.device)
    kept = None
    for r in range(T - 1, -1, -1):
        e = kernels._emission(em[r], obs[r])
        c = Mf[ops[r]] @ kernels._bf16(carry * e)
        carry = c if norm_block and r % S != 0 else \
            c / c.sum(dim=0, keepdim=True)
        if r == carry_site:
            kept = carry.clone()
        a = alpha[r if read_every else r // S].float()
        post = a * (c if norm_block else carry)[:a.shape[0]]
        post = post / post.sum(dim=0, keepdim=True)
        out[r, 0] = post[:POST_ROWS].sum(dim=0)
    return out if carry_site is None else (out, kept)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _check_inputs(M, em, obs, ops, S):
    if obs.device.type != "cuda":
        raise ValueError(f"no kernel for tensors on {obs.device}")
    T, _, P = obs.shape
    G, KC, _ = M.shape
    kernels._check("M", M, torch.bfloat16, (G, KC, KC))
    kernels._check("em", em, torch.float32, (T, 3, KC))
    kernels._check("obs", obs, torch.float32, (T, 2, P))
    kernels._check("ops", ops, torch.int32, (T,))
    if any(x.device != obs.device for x in (M, em, ops)):
        raise ValueError("kernel inputs lie on different devices")
    if S <= 0 or T % S:
        raise ValueError(f"S={S} must divide T={T}")
    return T, P, G, KC


def forward(M, em, obs, isp, ops, store_every: bool = True,
            norm_block: bool = False, S: int = 8,
            KA: int = 72) -> torch.Tensor:
    """The probe's forward pass: the CUDA kernel for CUDA tensors,
    :func:`forward_reference` for CPU tensors."""
    if obs.device.type == "cpu":
        return forward_reference(M, em, obs, isp, ops, store_every,
                                 norm_block, S, KA)
    T, P, G, KC = _check_inputs(M, em, obs, ops, S)
    kernels._check("isp", isp, torch.float32, (KC,))
    alpha = torch.empty((T if store_every else T // S, KA, P),
                        dtype=torch.bfloat16, device=obs.device)
    rc = load_library(LIBRARY).fastsmc_alpha_wall_forward(
        M.data_ptr(), G, em.data_ptr(), obs.data_ptr(), isp.data_ptr(),
        ops.data_ptr(), alpha.data_ptr(), T, P, KC, KA, S, int(store_every),
        int(norm_block), obs.device.index or 0,
        torch.cuda.current_stream(obs.device).cuda_stream)
    kernels._raise_on(rc, "alpha_wall_forward")
    kernels.LAUNCHES["alpha_wall_forward"] += 1
    return alpha


def backward(M, em, obs, alpha, ops, read_every: bool = True,
             norm_block: bool = False, S: int = 8,
             carry_site: Optional[int] = None):
    """The probe's backward-shaped pass: the CUDA kernel for CUDA tensors,
    :func:`backward_reference` for CPU tensors; ``(out, carry)`` with
    ``carry_site``."""
    if obs.device.type == "cpu":
        return backward_reference(M, em, obs, alpha, ops, read_every,
                                  norm_block, S, carry_site)
    T, P, G, KC = _check_inputs(M, em, obs, ops, S)
    if carry_site is not None and not 0 <= carry_site < T:
        raise ValueError(f"carry_site={carry_site} outside [0, {T})")
    KA = alpha.shape[1]
    kernels._check("alpha", alpha, torch.bfloat16,
                   (T if read_every else T // S, KA, P))
    out = torch.empty((T, 1, P), dtype=torch.float32, device=obs.device)
    carry = None if carry_site is None else torch.empty(
        (KC, P), dtype=torch.float32, device=obs.device)
    rc = load_library(LIBRARY).fastsmc_alpha_wall_backward(
        M.data_ptr(), G, em.data_ptr(), obs.data_ptr(), alpha.data_ptr(),
        ops.data_ptr(), out.data_ptr(),
        None if carry is None else carry.data_ptr(),
        0 if carry_site is None else carry_site, T, P, KC, KA, S,
        int(read_every), int(norm_block), obs.device.index or 0,
        torch.cuda.current_stream(obs.device).cuda_stream)
    kernels._raise_on(rc, "alpha_wall_backward")
    kernels.LAUNCHES["alpha_wall_backward"] += 1
    return out if carry is None else (out, carry)


def max_errors(got, want, chunk: int = 256) -> tuple:
    """(largest |got - want|, largest |got - want| / |want|) over the
    elements of two raw outputs, in chunks of sites to bound the f32
    copies. Every value the probe computes is a sum of positive products,
    so the relative difference is defined everywhere and a wrong scale (a
    normalisation at the wrong site or by the wrong sum) shows in it."""
    abs_err = rel_err = 0.0
    for t in range(0, got.shape[0], chunk):
        x = got[t:t + chunk].float()
        y = want[t:t + chunk].float()
        d = (x - y).abs()
        abs_err = max(abs_err, d.max().item())
        rel_err = max(rel_err, (d / y.abs()).max().item())
    return abs_err, rel_err


def run_variant(name: str, inp: dict, shape: Shape, plain: bool = False,
                carry_site: Optional[int] = None):
    """One pass of variant ``name`` on the inputs of :func:`make_inputs`:
    its wrapper, or with ``plain`` its plain version; a backward variant
    with ``carry_site`` also returns its raw carry after that site."""
    kind, every, norm_block = VARIANTS[name]
    if kind == "fwd":
        fn = forward_reference if plain else forward
        return fn(inp["M"], inp["em"], inp["obs"], inp["isp"], inp["ops"],
                  every, norm_block, shape.S, shape.KA)
    alpha = inp["alpha"] if every else inp["alpha"][:shape.T // shape.S]
    fn = backward_reference if plain else backward
    return fn(inp["M"], inp["em"], inp["obs"], alpha, inp["ops"], every,
              norm_block, shape.S, carry_site)


# ---------------------------------------------------------------------------
# the probe
# ---------------------------------------------------------------------------

def _median_ms(fn, reps: int, cuda: bool) -> list:
    """Per-pass times in ms after one warm-up pass: CUDA events on the
    card, the host clock on the CPU."""
    fn()
    times = []
    for _ in range(reps):
        if cuda:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            times.append(1e3 * (time.perf_counter() - t0))
    return times


def card() -> str:
    """``name, power.limit`` of the card as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def probe(shape: Shape = Shape(), device="cuda", reps: int = 20,
          seed: int = 0, log=print) -> dict:
    """Time the six variants (median of ``reps`` passes after a warm-up)
    and what the alpha write and read cost. Returns the numbers."""
    dev = kernels.resolve_device(device)
    cuda = dev.type == "cuda"
    if reps < 1:
        raise ValueError("reps must be >= 1")
    inp = make_inputs(shape, dev, seed)
    res = {"device": torch.cuda.get_device_name(dev) if cuda else "cpu",
           "card": card() if cuda else None,
           "timer": "CUDA events" if cuda else "host clock",
           "shape": dataclasses.asdict(shape), "reps": reps, "ms": {},
           "ms_all": {}}
    for name in VARIANTS:
        times = _median_ms(lambda: run_variant(name, inp, shape), reps, cuda)
        ms = float(np.median(times))
        res["ms"][name] = ms
        res["ms_all"][name] = times
        log(f"{name}: {ms:.2f} ms per [T={shape.T}, P={shape.P}] pass")
    alpha_gb = shape.T * shape.KA * shape.P * 2 / 1e9
    res["alpha_GB_per_pass"] = alpha_gb
    ms = res["ms"]
    for what, pas, every, once in (("write", "fwd", "fwd_store",
                                    "fwd_nostore"),
                                   ("read", "bwd", "bwd_read",
                                    "bwd_noread")):
        d = ms[every] - ms[once]
        res[f"{what}_cost_ms"] = d
        # bytes the every-site variant moves beyond the once-a-block one
        gbps = alpha_gb * (1 - 1 / shape.S) / (d / 1e3) if d > 0 else None
        res[f"{what}_GB_per_s"] = gbps
        if d > 0.05 * ms[every]:
            log(f"alpha {what.upper()} costs {d:.2f} ms "
                f"({100 * d / ms[every]:.0f}% of {pas}) -> effective "
                f"{gbps:.0f} GB/s")
        else:
            log(f"alpha {what} ~free: {pas} pass is bound by its products "
                f"({d:+.2f} ms, {100 * d / ms[every]:+.1f}% of {pas})")
    return res


def main(argv=None, shape: Shape = Shape()) -> dict:
    """The probe at ``shape`` (the script's own unless a caller passes a
    smaller one, as the CPU tests do)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without CUDA) or cpu (the "
                    "plain versions)")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help="JSON output (default build/alpha_wall/"
                    "alpha_wall.json)")
    args = ap.parse_args(argv)
    res = probe(shape, args.device, args.reps)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(res, fh, indent=2)
    print(f"ALPHA_WALL_PROBE_OK -> {args.out}", flush=True)
    return res


if __name__ == "__main__":
    main(sys.argv[1:])
