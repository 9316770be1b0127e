"""The least time the card could take for a decode: the table of peaks and
the operations and bytes of the two decode kernels, from their shapes.

A frozen copy of ``chip_smoke.decode_bound``: FLOP at the real K, each
input byte read once and each output byte written once, the exact
forward's products as 3xTF32 (three TF32 products for each float32 one,
against the TF32 peak), the exact backward's as float32 on the FP32 pipe,
and bf16 operands against the bf16 tensor-core peak whatever unit runs
them.
"""

from __future__ import annotations

# NVIDIA H100 SXM, dense, at its 700 W limit (NVIDIA's data sheet)
MEM_BW = 3.35e12                                      # bytes/s
PEAK = {"f32": 67e12, "bf16": 989e12, "tf32": 495e12}  # FLOP/s


def bound(nbytes: float, flop: float, kind: str) -> dict:
    """``ms``: the larger of the bytes' time at MEM_BW and the operations'
    at the peak of ``kind``; ``op_ms``: the latter alone."""
    mem_ms = 1e3 * nbytes / MEM_BW
    op_ms = 1e3 * flop / PEAK[kind]
    return {"ms": max(mem_ms, op_ms), "op_ms": op_ms,
            "by": "bytes" if mem_ms >= op_ms else "operations"}


def decode_bound(kernel: str, T: int, P: int, K: int, G: int, seq: bool,
                 profile: str, outs: dict = None) -> dict:
    """Bound of the forward (``kernel == "forward"``) or the
    backward+reduction kernel on a T-site window of P pairs at K real
    states and G operators. ``outs`` names the backward's outputs (keys
    ``posterior``, ``threshold_sums``, ``per_pair_mean``, ``per_pair_map``,
    ``posterior_sums``, ``major_minor_sums``, true where written)."""
    outs = outs or {}
    approx = profile != "exact"
    tf32x3 = kernel == "forward" and not approx
    ab = 2 if approx else 4
    nbytes = 4 * (2 * T * P + 3 * T * K + (T * K if seq else 0)) \
        + G * K * K * (2 if profile == "turbo" else 8 if tf32x3 else 4) \
        + T * K * P * ab
    if kernel != "forward":
        o = {k: int(bool(outs.get(k))) for k in (
            "posterior", "threshold_sums", "per_pair_mean", "per_pair_map",
            "posterior_sums", "major_minor_sums")}
        nbytes += 4 * (T * K * P * o["posterior"]
                       + T * P * (o["threshold_sums"] + o["per_pair_mean"]
                                  + o["per_pair_map"])
                       + T * K * (o["posterior_sums"]
                                  + 3 * o["major_minor_sums"]))
    flop = 2 * (T - 1) * P * K * K * (2 if seq else 1)
    if tf32x3:
        return bound(nbytes, 3 * flop, "tf32")
    return bound(nbytes, flop, "bf16" if approx else "f32")
