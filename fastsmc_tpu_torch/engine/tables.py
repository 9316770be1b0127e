"""Device decode tables: the model state every decode window reads.

Counterpart of the table set-up in ``fastsmc_tpu/engine/kernels.py``
(``PallasDecoder.__init__`` and ``_tables()``), array mode. The TPU pads
the state axis to 128 lanes; here it is padded only to a multiple of 8,
which is what the kernels' 8-warp row split needs (K=69 -> 72).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from fastsmc_tpu.engine.dense import build_dense_operators
from fastsmc_tpu.engine.oracle import DecodeContext

MAX_STATES = 128   # the kernels hold at most 16 state rows per warp


def padded_states(K: int) -> int:
    """State rows the kernels compute: K rounded up to a multiple of 8."""
    if not 0 < K <= MAX_STATES:
        raise ValueError(f"states={K} outside 1..{MAX_STATES}")
    return (K + 7) // 8 * 8


@dataclasses.dataclass
class DecodeTables:
    K: int                    # real hidden states
    Mf: torch.Tensor          # f32 [G, KP, KP] dense forward operators
    Mb: torch.Tensor          # f32 [G, KP, KP] dense backward operators
    gap_op: torch.Tensor      # int64 [L-1] operator row of gap (g, g+1)
    identity_op: int          # operator row of a zero genetic distance
    em: torch.Tensor          # f32 [L, 3, KP] em1, em0minus1, em2minus0
    isp: torch.Tensor         # f32 [KP] initial state probabilities
    exp_times: torch.Tensor   # f32 [KP] expected coalescence times
    hap_bits: torch.Tensor    # uint8 [H, L] folded haplotypes
    scaling_skip: int = 1     # normalise where site % skip == 0

    @property
    def KP(self) -> int:
        return self.Mf.shape[-1]

    @property
    def L(self) -> int:
        return self.em.shape[0]

    @property
    def device(self) -> torch.device:
        return self.Mf.device

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
    def from_context(cls, ctx: DecodeContext, device) -> "DecodeTables":
        """Build the tables from a host :class:`DecodeContext`."""
        if ctx.params.decoding_sequence:
            raise NotImplementedError("sequence mode is not ported yet")
        dq = ctx.dq
        K = dq.states
        KP = padded_states(K)
        zero_row = int(dq.gen_dist_index(np.float32(0.0)))
        used = np.unique(np.concatenate([np.asarray(ctx.gap_idx),
                                         np.asarray([zero_row])]))
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
        return cls._upload(K, Mf, Mb, remap[np.asarray(ctx.gap_idx)],
                           int(remap[zero_row]), em, isp, expt,
                           ctx.data.hap_bits, ctx.scaling_skip, device)

    @classmethod
    def from_numpy(cls, d: dict, K: int, device) -> "DecodeTables":
        """Take the JAX ``PallasDecoder``'s tables as numpy arrays (keys of
        its ``_tables()`` plus ``gap_op``, ``identity_op``, ``hap_bits``
        and optionally ``scaling_skip``) and strip their 128-lane padding
        down to :func:`padded_states`."""
        KP = padded_states(K)
        return cls._upload(
            K, np.asarray(d["Mf"])[:, :KP, :KP],
            np.asarray(d["Mb"])[:, :KP, :KP], np.asarray(d["gap_op"]),
            int(d["identity_op"]), np.asarray(d["em"])[:, :, :KP],
            np.asarray(d["isp"]).reshape(-1)[:KP],
            np.asarray(d["exp"]).reshape(-1)[:KP], np.asarray(d["hap_bits"]),
            int(d.get("scaling_skip", 1)), device)

    @classmethod
    def _upload(cls, K, Mf, Mb, gap_op, identity_op, em, isp, expt,
                hap_bits, scaling_skip, device) -> "DecodeTables":
        def f32(x):
            return torch.tensor(np.asarray(x, np.float32), device=device)
        return cls(K=K, Mf=f32(Mf), Mb=f32(Mb),
                   gap_op=torch.tensor(np.asarray(gap_op, np.int64),
                                       device=device),
                   identity_op=identity_op, em=f32(em), isp=f32(isp),
                   exp_times=f32(expt),
                   hap_bits=torch.tensor(np.asarray(hap_bits, np.uint8),
                                         device=device),
                   scaling_skip=int(scaling_skip))
