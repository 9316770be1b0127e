"""Forward-backward over every site of a panel for a block of pairs, in
plain PyTorch: the posterior over the K time intervals at each site.

One Python step a site, one K x K product a step (ASMC's recursions
HMM.cpp:1464-1721 as dense operators), the carry normalised at every site.
``precision`` is "float64", "float32" (TF32 off) or "tf32": the float32
decode with both operands of every transition product rounded to TF32
(10 mantissa bits), which is what a TF32 matrix unit reads; the benchmark's
control.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from .model import Model

PRECISIONS = ("float64", "float32", "tf32")


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to 10 mantissa bits (to nearest, ties away)."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & -0x2000).view(torch.float32)


@contextlib.contextmanager
def exact_matmul():
    """float32 products in float32: TF32 off for the duration."""
    m, c = torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


class Decoder:
    """The model on ``device`` at ``precision``; ``bits`` is the folded
    panel, uint8 [haplotypes, sites] (a tensor on ``device``)."""

    def __init__(self, model: Model, bits: torch.Tensor, precision: str):
        if precision not in PRECISIONS:
            raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
        self.device = bits.device
        self.dtype = torch.float64 if precision == "float64" \
            else torch.float32
        self.tf32 = precision == "tf32"
        t = dict(dtype=self.dtype, device=self.device)
        rnd = to_tf32 if self.tf32 else (lambda x: x)
        self.Tf = rnd(torch.tensor(model.Tf, **t))
        self.Tb = rnd(torch.tensor(model.Tb, **t))
        self.gap = model.gap.tolist()
        # [L, K, 3]: column c is P(observation class c | state)
        self.em = torch.tensor(model.emission, **t).transpose(1, 2) \
            .contiguous()
        self.isp = torch.tensor(model.isp, **t)
        self.K = model.K
        self.bits = bits

    def classes(self, h1, h2) -> torch.Tensor:
        """int64 [L, P] observation class of each pair at each site:
        0 the two differ, 1 both carry the major allele, 2 both the minor."""
        a = self.bits[torch.as_tensor(h1, device=self.device).long()]
        b = self.bits[torch.as_tensor(h2, device=self.device).long()]
        cls = torch.where(a != b, 0, torch.where(a == 1, 2, 1))
        return cls.T.contiguous()

    def _mm(self, M: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return M @ (to_tf32(x) if self.tf32 else x)

    def posterior(self, h1, h2) -> tuple:
        """(post [L, K, P] normalised over states at every site, the
        classes [L, P]) of the pairs ``(h1[p], h2[p])``."""
        with torch.inference_mode(), exact_matmul():
            cls = self.classes(h1, h2)
            L, P = cls.shape
            em = self.em
            alpha = torch.empty((L, self.K, P), dtype=self.dtype,
                                device=self.device)
            c = self.isp[:, None] * em[0].index_select(1, cls[0])
            alpha[0] = c / c.sum(0)
            for t in range(1, L):
                c = self._mm(self.Tf[self.gap[t - 1]], alpha[t - 1])
                c *= em[t].index_select(1, cls[t])
                alpha[t] = c / c.sum(0)
            beta = torch.full((self.K, P), 1.0 / self.K, dtype=self.dtype,
                              device=self.device)
            for t in range(L - 2, -1, -1):
                v = beta * em[t + 1].index_select(1, cls[t + 1])
                c = self._mm(self.Tb[self.gap[t]], v)
                beta = c / c.sum(0)
                alpha[t] *= beta
            alpha /= alpha.sum(1, keepdim=True)
            return alpha, cls


def class_sums(dec: Decoder, h1: np.ndarray, h2: np.ndarray, block: int,
               site_chunk: int = 256) -> np.ndarray:
    """float64 [L, 3, K]: the posterior summed over the pairs whose
    observation at the site is of each class, blocks of ``block`` pairs at
    a time; the sums over pairs are taken in float64."""
    total = None
    for p0 in range(0, len(h1), block):
        post, cls = dec.posterior(h1[p0:p0 + block], h2[p0:p0 + block])
        with torch.inference_mode():
            part = torch.cat([
                torch.bmm(post[s:s + site_chunk].double(),
                          torch.nn.functional.one_hot(
                              cls[s:s + site_chunk], 3).double())
                for s in range(0, post.shape[0], site_chunk)])  # [L, K, 3]
        del post, cls
        part = part.transpose(1, 2).cpu().numpy()
        total = part if total is None else total + part
    return total
