"""Run extraction on the device, in plain PyTorch.

Counterpart of the device half of ``fastsmc_tpu/engine/segments.py``
(XLA functions there, not Pallas kernels): the per-column window mask,
the 4-level threshold classification (HMM.cpp:1226-1308), run bounds,
kept-run selection, run scores, per-run posterior-state sums and ages.

PyTorch runs eagerly with dynamic shapes, so the JAX package's static caps
(raw/kept/pps caps, the packed row, the bounded chunk loop and the
overflow redo) have no counterpart: extraction returns exactly the kept
runs. The two host helpers, ``state_threshold`` and
``probability_threshold``, are copies of that module's.
"""

from __future__ import annotations

import numpy as np
import torch

_NONE = 4          # level of a site below every threshold
_CHUNK_ELEMS = 1 << 24


def state_threshold(discretization: np.ndarray, time: int, states: int) -> int:
    """HMM::getStateThreshold (HMM.cpp:504-513)."""
    r = 0
    while r < states and discretization[r] < float(time):
        r += 1
    return r


def probability_threshold(initial_state_prob: np.ndarray, st: int) -> float:
    """HMM.cpp:96-99: cumulative initial-state mass below the threshold
    (sequential float32 sum like the reference)."""
    s = np.float32(0.0)
    for x in initial_state_prob[:st]:
        s = np.float32(s + np.float32(x))
    return float(s)


def level_thresholds(prob_threshold: float):
    """p, 10p, 100p, 1000p, each rounded in float32 as the JAX package
    computes them (``jnp.float32(10.0) * p``)."""
    p = np.float32(prob_threshold)
    return tuple(float(np.float32(m) * p) for m in (1.0, 10.0, 100.0, 1000.0))


def mask_window(th: torch.Tensor, w0, w1) -> torch.Tensor:
    """th [T, P] with -1 outside each column's [w0_p, w1_p) window
    (segments.py:436-453): runs then clip to each candidate's own window."""
    dev = th.device
    w0 = torch.as_tensor(np.asarray(w0), dtype=torch.int64, device=dev)
    w1 = torch.as_tensor(np.asarray(w1), dtype=torch.int64, device=dev)
    pos = torch.arange(th.shape[0], device=dev)[:, None]
    inside = (pos >= w0[None, :]) & (pos < w1[None, :])
    return torch.where(inside, th, -1.0)


def boundaries_runs(th: torch.Tensor, s0: int, s1: int,
                    prob_threshold: float):
    """Every run of constant level inside [s0, s1), pair-major then by
    start (segments.py:143-194 without its cap): returns int64 tensors
    ``(pair, a, b, level)``; ``b`` is inclusive, and ``s1 - 1`` on a
    pair's last run."""
    T, P = th.shape
    lvl = torch.full(th.shape, _NONE, dtype=torch.int8, device=th.device)
    for thr in level_thresholds(prob_threshold):
        lvl -= (th >= thr).to(torch.int8)
    pos = torch.arange(T, device=th.device)
    lvl[(pos < s0) | (pos >= s1)] = _NONE
    lvl_t = lvl.T.contiguous()                              # [P, T]
    chg = torch.ones_like(lvl_t, dtype=torch.bool)
    chg[:, 0] = lvl_t[:, 0] != _NONE
    chg[:, 1:] = lvl_t[:, 1:] != lvl_t[:, :-1]
    idx = torch.nonzero(chg.reshape(-1)).reshape(-1)        # ascending
    pair = idx // T
    a = idx % T
    nxt = torch.cat([idx[1:], idx.new_full((1,), T * P)])
    b = torch.where(nxt // T == pair, nxt % T - 1, s1 - 1)
    return pair, a, b, lvl_t.reshape(-1)[idx].to(torch.int64)


def run_scores(th: torch.Tensor, pair, a, b) -> torch.Tensor:
    """Sum of th over [a_i, b_i] in column pair_i, per run: an f32
    indicator product over the window (segments.py:197-223), in chunks."""
    T = th.shape[0]
    pos = torch.arange(T, device=th.device)
    step = max(1, _CHUNK_ELEMS // T)
    out = [((pos >= a[i:i + step, None]) & (pos <= b[i:i + step, None])
            ).float().mul_(th[:, pair[i:i + step]].T).sum(dim=1)
           for i in range(0, len(pair), step)]
    return torch.cat(out) if out else th.new_zeros(0)


def extract_kept_runs(th: torch.Tensor, s0: int, s1: int,
                      prob_threshold: float):
    """Kept (level < 4) runs and their scores (segments.py:339-381):
    ``(pair, a, b, score_sum)``, pair-major, exactly the kept runs."""
    pair, a, b, lv = boundaries_runs(th, s0, s1, prob_threshold)
    keep = lv != _NONE
    pair, a, b = pair[keep], a[keep], b[keep]
    return pair, a, b, run_scores(th, pair, a, b)


def run_pps(post: torch.Tensor, pair, a, b) -> torch.Tensor:
    """Per-run, per-state posterior sums [n, K] over each run's [a, b] in
    column ``pair`` (segments.py:277-317): an f32 indicator einsum over
    the window, in chunks of runs."""
    T, K = post.shape[0], post.shape[1]
    pos = torch.arange(T, device=post.device)
    step = max(1, 4 * _CHUNK_ELEMS // (T * K))
    out = []
    for i in range(0, len(pair), step):
        ind = ((pos >= a[i:i + step, None])
               & (pos <= b[i:i + step, None])).float()       # [C, T]
        post_g = post.index_select(2, pair[i:i + step])      # [T, K, C]
        out.append(torch.einsum("it,tki->ik", ind, post_g))
    return torch.cat(out) if out else post.new_zeros((0, K))


def run_ages(pps: torch.Tensor, expected_times: torch.Tensor,
             initial_state_prob: torch.Tensor, age_threshold: int
             ) -> torch.Tensor:
    """Per-run posterior-mean and MAP ages [2, n] from [n, K] posterior
    state sums (segments.py:320-336; HMM.cpp:1087-1107)."""
    ppa = pps[:, :age_threshold]
    norm = 1.0 / ppa.sum(dim=1)
    pm = (norm[:, None] * ppa
          * expected_times[None, :age_threshold]).sum(dim=1)
    ratio = ppa / initial_state_prob[None, :age_threshold]
    mp = expected_times[ratio.argmax(dim=1)]
    return torch.stack([pm, mp])
