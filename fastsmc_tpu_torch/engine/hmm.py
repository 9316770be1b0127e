"""Batched forward-backward decoder in plain PyTorch: the specification.

Counterpart of ``fastsmc_tpu/engine/hmm.py`` (``BatchedDecoder``, array and
sequence mode): a per-site Python loop of ``M[op] @ carry``, the emission
``em1 + em0minus1*obsIsZero + em2minus0*obsIsHomMinor`` (HMM.cpp:827-828)
and normalisation under the scaling-skip mask; in sequence mode each site
is a homozygous half-step and a marker step (HMM.cpp:760-770, 915-925). It
runs on any device, in float32 whatever the decode profile, and is what the
kernels' tests check against; the pipeline never runs it.
"""

from __future__ import annotations

from typing import Optional

import torch

from .oracle import DecodeContext
from .tables import DecodeTables


def bucket_len(n: int, min_bucket: int = 64) -> int:
    """Round a window length up to a power-of-two multiple of
    ``min_bucket`` (the JAX package's shape buckets; kept so decode
    windows, and so outputs, match it)."""
    b = min_bucket
    while b < n:
        b *= 2
    return b


def _normalize(x: torch.Tensor, mask) -> torch.Tensor:
    s = x.sum(dim=0, keepdim=True)
    return x * torch.where(torch.as_tensor(mask, device=x.device),
                           1.0 / s, torch.ones_like(s))


class BatchedDecoder:
    """Posterior ``[T, K, P]`` for hap pairs over a decode window."""

    def __init__(self, ctx: DecodeContext, device):
        t = DecodeTables.from_context(ctx, device)
        K = t.K
        self.tables = t
        self.K, self.L = K, t.L
        self.Tf = t.Mf[:, :K, :K]
        self.Tb = t.Mb[:, :K, :K]
        self.em = t.em[:, :, :K]
        self.isp = t.isp[:K]
        self.sequence = t.sequence

    def decode_pairs(self, hap_a, hap_b, t0: int = 0,
                     t_len: Optional[int] = None) -> torch.Tensor:
        t = self.tables
        dev = t.device
        T = self.L - t0 if t_len is None else int(t_len)
        real = min(T, self.L - t0)
        pad = T - real
        ident = torch.full((pad,), t.identity_op, dtype=torch.int64,
                           device=dev)

        def pad_ops(x):
            return torch.cat([x[t0:t0 + real - 1], ident])       # [T-1]

        ops = pad_ops(t.gap_op)
        if self.sequence:
            # hmm.py:219-232: padded gaps take identity operators and
            # all-ones homozygous emissions
            sop, sop_b = pad_ops(t.seq_op), pad_ops(t.seq_op_bwd)
            rop = torch.cat([t.rate_op[t0:t0 + real], ident])      # [T]
            hem = torch.cat([t.homoz[t0:t0 + real - 1, :self.K],
                             torch.ones((pad, self.K), device=dev)])
        mask = (torch.arange(t0, t0 + T, device=dev)
                % t.scaling_skip) == 0
        em = self.em[t0:t0 + real]
        em_pad = torch.zeros((pad, 3, self.K), device=dev)
        em_pad[:, 0] = 1.0
        em = torch.cat([em, em_pad])                              # [T, 3, K]

        ha = torch.as_tensor(hap_a, dtype=torch.int64, device=dev)
        hb = torch.as_tensor(hap_b, dtype=torch.int64, device=dev)
        a = t.hap_bits[ha, t0:t0 + real]
        b = t.hap_bits[hb, t0:t0 + real]
        xor = torch.nn.functional.pad((a ^ b).float(), (0, pad), value=1.0)
        hom = torch.nn.functional.pad((a & b).float(), (0, pad), value=0.0)
        oz = (1.0 - xor).T                                        # [T, P]
        oh = hom.T

        def emission(i):
            return (em[i, 0][:, None] + em[i, 1][:, None] * oz[i][None, :]
                    + em[i, 2][:, None] * oh[i][None, :])

        alpha = [_normalize(self.isp[:, None] * emission(0), True)]
        for i in range(1, T):
            if self.sequence:
                mid = hem[i - 1][:, None] * (self.Tf[sop[i - 1]] @ alpha[-1])
                nxt = emission(i) * (self.Tf[rop[i]] @ mid)
            else:
                nxt = emission(i) * (self.Tf[ops[i - 1]] @ alpha[-1])
            alpha.append(_normalize(nxt, mask[i]))
        beta = [torch.full_like(alpha[0], 1.0 / self.K)]
        for i in range(T - 2, -1, -1):
            if self.sequence:
                mid = self.Tb[sop_b[i]] @ (beta[-1] * hem[i][:, None])
                prev = self.Tb[rop[i]] @ (mid * emission(i + 1))
            else:
                prev = self.Tb[ops[i]] @ (beta[-1] * emission(i + 1))
            beta.append(_normalize(prev, mask[i]))
        post = torch.stack(alpha) * torch.stack(beta[::-1])
        return post / post.sum(dim=1, keepdim=True)
