"""Device decode tables: the model state every decode window reads.

Counterpart of the table set-up in ``fastsmc_tpu/engine/kernels.py``
(``PallasDecoder.__init__`` :342-385 and ``_tables()``), array and sequence
mode. The TPU pads the state axis to 128 lanes; here it is padded only to a
multiple of 8, which is what the kernels' 8-warp row split needs (K=69 ->
72).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .dense import build_dense_operators
from .oracle import DecodeContext

MAX_STATES = 128   # the kernels hold at most 16 state rows per warp


def tf32_split(M: torch.Tensor):
    """``(hi, lo)`` of f32 ``M``: ``hi`` is ``M`` rounded to TF32 (10
    mantissa bits, to nearest, ties away from zero: ``cvt.rna.tf32.f32``),
    ``lo`` is ``M - hi`` (exact in f32) rounded the same way; both f32 with
    the low 13 mantissa bits zero, and ``hi + lo`` is ``M`` within 2^-22
    relative. The forward kernel's exact profile reads its operators as
    this pair (3xTF32)."""
    def rna(x):
        b = x.contiguous().view(torch.int32)
        return ((b + 0x1000) & -0x2000).view(torch.float32)

    hi = rna(M.float())
    return hi, rna(M.float() - hi)


def tile_operators(M: torch.Tensor) -> torch.Tensor:
    """The operators ``M`` ``[G, KP, KP]`` (f32 or bf16) as the forward
    kernel's bf16 array branch reads them: each value rounded to bf16 (to
    nearest even; a bf16 table's values as they are), held as f32, and each
    operator transposed, ``[G, j, k]``, so that a warp's row groups read
    consecutive words. The fast profile's f32 table and the turbo profile's
    bf16 table of the same operators give the same bits."""
    return M.to(torch.bfloat16).float().transpose(-2, -1).contiguous()


def padded_states(K: int) -> int:
    """State rows the kernels compute: K rounded up to a multiple of 8."""
    if not 0 < K <= MAX_STATES:
        raise ValueError(f"states={K} outside 1..{MAX_STATES}")
    return (K + 7) // 8 * 8


@dataclasses.dataclass
class DecodeTables:
    K: int                    # real hidden states
    Mf: torch.Tensor          # [G, KP, KP] dense forward operators
    Mb: torch.Tensor          # [G, KP, KP] dense backward operators
    gap_op: torch.Tensor      # int64 [L-1] operator row of gap (g, g+1)
    identity_op: int          # operator row of a zero genetic distance
    em: torch.Tensor          # f32 [L, 3, KP] em1, em0minus1, em2minus0
    isp: torch.Tensor         # f32 [KP] initial state probabilities
    exp_times: torch.Tensor   # f32 [KP] expected coalescence times
    hap_bits: torch.Tensor    # uint8 [H, L] folded haplotypes
    scaling_skip: int = 1     # normalise where site % skip == 0
    # sequence mode only (kernels.py:363-369): the forward and backward
    # seq-gap operators of gap (g, g+1), the rate operator of each site, and
    # the homozygous emissions of each gap (1.0 in the padded states)
    seq_op: Optional[torch.Tensor] = None      # int64 [L-1]
    seq_op_bwd: Optional[torch.Tensor] = None  # int64 [L-1]
    rate_op: Optional[torch.Tensor] = None     # int64 [L]
    homoz: Optional[torch.Tensor] = None       # f32 [L-1, KP]
    # f32 operators only: Mf's TF32 split (tf32_split), the forward
    # kernel's exact-profile operators
    Mf_hi: Optional[torch.Tensor] = None       # f32 [G, KP, KP]
    Mf_lo: Optional[torch.Tensor] = None       # f32 [G, KP, KP]

    @property
    def split(self):
        """``(Mf_hi, Mf_lo)``, the forward kernel's exact-profile operators;
        None for bf16 operators."""
        return None if self.Mf_hi is None else (self.Mf_hi, self.Mf_lo)

    @property
    def KP(self) -> int:
        return self.Mf.shape[-1]

    @property
    def L(self) -> int:
        return self.em.shape[0]

    @property
    def device(self) -> torch.device:
        return self.Mf.device

    @property
    def sequence(self) -> bool:
        return self.seq_op is not None

    def set_expected_times(self, times) -> None:
        """Replace ``exp_times[:K]`` (the times the ``per_pair_mean`` output
        weights the posterior by, e.g. from ASMC's
        ``--expectedCoalTimesFile``); padded states keep 0."""
        times = np.asarray(times, np.float32).reshape(-1)
        if len(times) != self.K:
            raise ValueError(f"{len(times)} expected times for {self.K} "
                             "states")
        e = torch.zeros(self.KP, dtype=torch.float32, device=self.device)
        e[:self.K] = torch.from_numpy(times).to(self.device)
        self.exp_times = e

    @classmethod
    def from_context(cls, ctx: DecodeContext, device,
                     op_dtype=torch.float32) -> "DecodeTables":
        """Build the tables from a host :class:`DecodeContext`; the
        operators are stored as ``op_dtype`` (bf16 for the turbo
        profile, rounded to nearest even)."""
        dq = ctx.dq
        K = dq.states
        KP = padded_states(K)
        seq = ctx.params.decoding_sequence
        zero_row = int(dq.gen_dist_index(np.float32(0.0)))
        used = [np.asarray(ctx.gap_idx), np.asarray([zero_row])]
        if seq:
            used += [np.asarray(ctx.seq_gap_idx),
                     np.asarray(ctx.seq_gap_idx_bwd), np.asarray(ctx.rate_idx)]
        used = np.unique(np.concatenate(used))
        remap = np.full(len(dq.gen_dists), -1, np.int32)
        remap[used] = np.arange(len(used), dtype=np.int32)
        Tf, Tb = build_dense_operators(dq.D[used], dq.B[used], dq.U[used],
                                       dq.RR[used], dq.column_ratios)
        Mf = np.zeros((len(used), KP, KP), np.float32)
        Mb = np.zeros((len(used), KP, KP), np.float32)
        Mf[:, :K, :K] = Tf
        Mb[:, :K, :K] = Tb
        e = ctx.emissions
        em = np.zeros((ctx.data.sites, 3, KP), np.float32)
        em[:, 0, :K] = e.em1
        em[:, 1, :K] = e.em0minus1
        em[:, 2, :K] = e.em2minus0
        isp = np.zeros(KP, np.float32)
        isp[:K] = dq.initial_state_prob
        expt = np.zeros(KP, np.float32)
        expt[:K] = dq.expected_times
        seq_tabs = None
        if seq:
            hz = np.ones((ctx.data.sites - 1, KP), np.float32)
            hz[:, :K] = dq.homozygous_emissions[ctx.homoz_idx]
            seq_tabs = dict(seq_op=remap[np.asarray(ctx.seq_gap_idx)],
                            seq_op_bwd=remap[np.asarray(ctx.seq_gap_idx_bwd)],
                            rate_op=remap[np.asarray(ctx.rate_idx)],
                            homoz=hz)
        return cls._upload(K, Mf, Mb, remap[np.asarray(ctx.gap_idx)],
                           int(remap[zero_row]), em, isp, expt,
                           ctx.data.hap_bits, ctx.scaling_skip, device,
                           op_dtype, seq_tabs)

    @classmethod
    def from_numpy(cls, d: dict, K: int, device) -> "DecodeTables":
        """Take the JAX ``PallasDecoder``'s tables as numpy arrays (keys of
        its ``_tables()`` plus ``gap_op``, ``identity_op``, ``hap_bits``,
        optionally ``scaling_skip``, and in sequence mode ``seq_op``,
        ``seq_op_bwd`` and ``rate_op``) and strip their 128-lane padding
        down to :func:`padded_states`. bf16 operators (the turbo profile's)
        stay bf16."""
        KP = padded_states(K)
        Mf, Mb = np.asarray(d["Mf"]), np.asarray(d["Mb"])
        op_dtype = torch.float32
        if Mf.dtype != np.float32:
            # ml_dtypes' bfloat16: every value is exact in f32
            op_dtype = torch.bfloat16
            Mf, Mb = Mf.astype(np.float32), Mb.astype(np.float32)
        seq_tabs = None
        if "homoz" in d:
            seq_tabs = dict(seq_op=d["seq_op"], seq_op_bwd=d["seq_op_bwd"],
                            rate_op=d["rate_op"],
                            homoz=np.asarray(d["homoz"])[:, 0, :KP])
        return cls._upload(
            K, Mf[:, :KP, :KP], Mb[:, :KP, :KP], np.asarray(d["gap_op"]),
            int(d["identity_op"]), np.asarray(d["em"])[:, :, :KP],
            np.asarray(d["isp"]).reshape(-1)[:KP],
            np.asarray(d["exp"]).reshape(-1)[:KP], np.asarray(d["hap_bits"]),
            int(d.get("scaling_skip", 1)), device, op_dtype, seq_tabs)

    @classmethod
    def _upload(cls, K, Mf, Mb, gap_op, identity_op, em, isp, expt,
                hap_bits, scaling_skip, device, op_dtype=torch.float32,
                seq_tabs: Optional[dict] = None) -> "DecodeTables":
        def f32(x):
            return torch.tensor(np.asarray(x, np.float32), device=device)

        def i64(x):
            return torch.tensor(np.asarray(x, np.int64), device=device)

        extra = {}
        if seq_tabs is not None:
            extra = dict(seq_op=i64(seq_tabs["seq_op"]),
                         seq_op_bwd=i64(seq_tabs["seq_op_bwd"]),
                         rate_op=i64(seq_tabs["rate_op"]),
                         homoz=f32(seq_tabs["homoz"]))
        Mf_t = f32(Mf).to(op_dtype)
        if op_dtype == torch.float32:
            extra["Mf_hi"], extra["Mf_lo"] = tf32_split(Mf_t)
        return cls(K=K, Mf=Mf_t, Mb=f32(Mb).to(op_dtype),
                   gap_op=i64(gap_op), identity_op=identity_op, em=f32(em),
                   isp=f32(isp), exp_times=f32(expt),
                   hap_bits=torch.tensor(np.asarray(hap_bits, np.uint8),
                                         device=device),
                   scaling_skip=int(scaling_skip), **extra)
