"""Run extraction on the device, in plain PyTorch.

Counterpart of the device half of ``fastsmc_tpu/engine/segments.py``
(XLA functions there, not Pallas kernels): the per-column window mask,
the 4-level threshold classification (HMM.cpp:1226-1308), run bounds,
kept-run selection, run scores, per-run posterior-state sums and ages.

The pipeline's path is :func:`extract_packed`: every shape depends only on
the caps, the compactions are a cumsum and a sorted search, and nothing
waits for the device, so a whole flush group is queued before its packed
rows are copied to the host. A count over its cap asks the caller to redo
the batch at grown caps (the JAX package's overflow redo). Run scores and
per-run state sums are differences of float64 prefix sums over sites, so
a run's value depends on its own sites alone: never on the cap, on where
the run falls in its row, or on the other runs, and a redo gives the same
bits. :func:`boundaries_runs` and :func:`extract_kept_runs` return exactly
the kept runs with no cap; they are the plain version the tests hold the
capped extraction to, and wait for the device (``torch.nonzero``). The two
host helpers, ``state_threshold`` and ``probability_threshold``, the
host unpack of a packed row and the merge of a mesh's per-shard rows are
copies of that module's.
"""

from __future__ import annotations

import numpy as np
import torch

_NONE = 4          # level of a site below every threshold
# pairs whose [T+1, A, pairs] float64 state prefix sums :func:`run_pps`
# builds at a time: about this many elements
_PREFIX_ELEMS = 1 << 26


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
    (segments.py:436-453): runs then clip to each candidate's own window.
    ``w0``/``w1`` are int tensors on th's device or host arrays."""
    dev = th.device
    w0 = torch.as_tensor(w0, device=dev)
    w1 = torch.as_tensor(w1, device=dev)
    pos = torch.arange(th.shape[0], device=dev)[:, None]
    inside = (pos >= w0[None, :]) & (pos < w1[None, :])
    return torch.where(inside, th, -1.0)


def levels(th: torch.Tensor, s0: int, s1: int,
           prob_threshold: float) -> torch.Tensor:
    """int8 [P, T], pair-major: 0..3 the level of each site, 4 below every
    threshold and outside [s0, s1)."""
    lvl = torch.full(th.shape, _NONE, dtype=torch.int8, device=th.device)
    for thr in level_thresholds(prob_threshold):
        lvl -= (th >= thr).to(torch.int8)
    pos = torch.arange(th.shape[0], device=th.device)[:, None]
    lvl = torch.where((pos >= s0) & (pos < s1), lvl, _NONE)
    return lvl.T.contiguous()


def _changes(lvl_t: torch.Tensor) -> torch.Tensor:
    """bool [P*T]: where a column's level differs from the site before
    (from 4 at site 0); the flat index is pair * T + site."""
    prev = torch.cat([torch.full_like(lvl_t[:, :1], _NONE), lvl_t[:, :-1]],
                     dim=1)
    return (lvl_t != prev).reshape(-1)


def _run_bounds(idx: torch.Tensor, T: int, P: int, s1: int):
    """``(pair, a, b)`` of the runs starting at the ascending flat
    boundaries ``idx`` (pair * T + site; T*P past the last): a run ends
    before the next boundary of its pair, or at ``s1 - 1``."""
    nxt = torch.cat([idx[1:], idx.new_full((1,), T * P)])
    pair = idx // T
    return pair, idx % T, torch.where(nxt // T == pair, nxt % T - 1, s1 - 1)


def boundaries_runs(th: torch.Tensor, s0: int, s1: int,
                    prob_threshold: float):
    """Every run of constant level inside [s0, s1), pair-major then by
    start (segments.py:143-194 without its cap): returns int64 tensors
    ``(pair, a, b, level)``; ``b`` is inclusive, and ``s1 - 1`` on a
    pair's last run. The plain version: waits for the device."""
    T, P = th.shape
    lvl_t = levels(th, s0, s1, prob_threshold)
    idx = torch.nonzero(_changes(lvl_t)).reshape(-1)        # ascending
    return (*_run_bounds(idx, T, P, s1),
            lvl_t.reshape(-1)[idx].to(torch.int64))


def run_scores(th: torch.Tensor, pair, a, b) -> torch.Tensor:
    """f32 sum of th over [a_i, b_i] in column pair_i, per run
    (segments.py:197-223): the difference of two float64 prefix sums over
    sites, rounded once. Runs with ``b < a`` (fill) score 0."""
    T, P = th.shape
    cs = torch.zeros((T + 1, P), dtype=torch.float64, device=th.device)
    torch.cumsum(th, 0, dtype=torch.float64, out=cs[1:])
    pr = pair.clamp(0, P - 1)
    return (cs[b + 1, pr] - cs[a, pr]).float()


def extract_kept_runs(th: torch.Tensor, s0: int, s1: int,
                      prob_threshold: float):
    """Kept (level < 4) runs and their scores (segments.py:339-381):
    ``(pair, a, b, score_sum)``, pair-major, exactly the kept runs. The
    plain version of :func:`extract_packed`: waits for the device."""
    pair, a, b, lv = boundaries_runs(th, s0, s1, prob_threshold)
    keep = lv != _NONE
    pair, a, b = pair[keep], a[keep], b[keep]
    return pair, a, b, run_scores(th, pair, a, b)


def run_pps(post: torch.Tensor, pair, a, b) -> torch.Tensor:
    """Per-run, per-state posterior sums [n, A] over each run's [a, b] in
    column ``pair`` of ``post`` [T, A, P] (segments.py:277-317): float64
    prefix sums over sites, differenced and rounded once to f32, built for
    a block of pairs at a time; fill runs (``b < a``) give 0."""
    T, A, P = post.shape
    out = post.new_zeros((pair.shape[0], A))
    block = max(1, min(P, _PREFIX_ELEMS // ((T + 1) * A)))
    for p0 in range(0, P, block):
        w = min(block, P - p0)
        cs = post.new_empty((T + 1, A, w), dtype=torch.float64)
        cs[0] = 0.0
        torch.cumsum(post[:, :, p0:p0 + w], 0, dtype=torch.float64,
                     out=cs[1:])
        local = (pair - p0).clamp(0, w - 1)
        sums = (cs[b + 1, :, local] - cs[a, :, local]).float()
        inside = (pair >= p0) & (pair < p0 + w)
        out = torch.where(inside[:, None], sums, out)
    return out


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


# ---------------------------------------------------------------------------
# capped extraction: shapes set by the caps, no host sync
# ---------------------------------------------------------------------------

def compact(flags: torch.Tensor, size: int):
    """Ascending indices of the set entries of ``flags`` [N], the first
    ``size`` of them, and their count: ``(idx int32 [size], n int32 0-d)``;
    slots past the count hold N. A cumsum and a sorted search, so nothing
    waits for the device (``torch.nonzero`` would)."""
    cum = torch.cumsum(flags, 0, dtype=torch.int32)
    want = torch.arange(1, size + 1, dtype=torch.int32, device=flags.device)
    return torch.searchsorted(cum, want, out_int32=True), cum[-1]


def _boundaries_runs_capped(th: torch.Tensor, s0: int, s1: int,
                           prob_threshold: float, cap: int):
    """The first ``cap`` level boundaries (segments.py:143-194): ``(idx,
    lv, n_raw, pair, a, b)``, int32 [cap] each but ``lv`` (int8) and the
    0-d count ``n_raw``. Slots past the count have idx == T*P, pair == P
    and lv == 4; with n_raw > cap the last run's end is wrong and the
    caller redoes the batch at a grown cap."""
    T, P = th.shape
    lvl_t = levels(th, s0, s1, prob_threshold)
    idx, n_raw = compact(_changes(lvl_t), cap)
    lv = torch.where(idx < T * P,
                     lvl_t.reshape(-1)[idx.clamp(max=T * P - 1)], _NONE)
    return (idx, lv, n_raw, *_run_bounds(idx, T, P, s1))


def extract_packed(th: torch.Tensor, s0: int, s1: int, prob_threshold: float,
                   cap: int, posterior=None, pps_cap: int = 0, kcap: int = 0):
    """Kept runs of ``th`` [T, P] inside [s0, s1) packed into one int32
    row (segments.py:339-430): ``[start (pair*T + a), b (inclusive),
    score bits, n_kept, n_raw]``, length 3*kcap + 2; ``cap`` bounds the
    raw boundary pass, ``kcap`` (default ``cap``, at most ``cap``) the kept
    runs. With ``posterior`` ([T, A, P]) also the per-run state sums
    [min(pps_cap, kcap), A] of the first kept runs (rows past n_kept are
    zero). Slots past n_kept hold start == T*P, b == -1, score 0. n_raw >
    cap or n_kept > kcap (or over the pps rows) means truncation: unpack
    with :func:`unpack_extract_rows` and redo at grown caps."""
    T, P = th.shape
    if T * P >= 1 << 28:
        raise ValueError(f"T*P = {T * P} >= 2**28 overflows the packed "
                         "boundary encoding")
    kcap = kcap or cap
    if cap <= 0 or not 0 < kcap <= cap:
        raise ValueError(f"cap={cap}/kcap={kcap}: need 0 < kcap <= cap")
    if posterior is not None and pps_cap <= 0:
        raise ValueError(f"pps_cap={pps_cap} must be positive")
    idx, lv, n_raw, pair, a, b = _boundaries_runs_capped(
        th, s0, s1, prob_threshold, cap)
    # slots past n_raw have lv == 4, so the kept flags need no count guard
    kidx, n_kept = compact(lv != _NONE, kcap)
    valid = kidx < cap
    sel = kidx.clamp(max=cap - 1)
    kstart = torch.where(valid, idx[sel], T * P)
    kpair = torch.where(valid, pair[sel], P)
    ka = torch.where(valid, a[sel], 0)
    kb = torch.where(valid, b[sel], -1)
    score = run_scores(th, kpair, ka, kb)
    packed = torch.cat([kstart, kb, score.view(torch.int32),
                        n_kept.reshape(1), n_raw.reshape(1)])
    if posterior is None:
        return packed, None
    n = min(pps_cap, kcap)
    return packed, run_pps(posterior, kpair[:n], ka[:n], kb[:n])


def stack_rows(rows) -> torch.Tensor:
    """A flush group's packed rows or age rows as one tensor, for one
    device-to-host copy (segments.py:459-467)."""
    return torch.stack(list(rows))


def unpack_extract_rows(packed_row: np.ndarray, kcap: int):
    """Host unpack of one :func:`extract_packed` row (segments.py:470-482):
    ``(start [kcap] int32 (pair*T + a), b [kcap] int32, score [kcap] f32,
    n_kept, n_raw)``. ``n_kept > kcap``, or ``n_raw`` over the raw cap the
    row was extracted with, means truncation: redo at grown caps."""
    start = packed_row[:kcap]
    b = packed_row[kcap:2 * kcap]
    score = packed_row[2 * kcap:3 * kcap].view(np.float32)
    return (start, b, score, int(packed_row[3 * kcap]),
            int(packed_row[3 * kcap + 1]))


def merge_packed_shards(mat: np.ndarray, T: int, P_local: int):
    """Host merge of a mesh's per-shard packed rows ``mat`` [S, 3*kcap+2]
    (``ShardedDecoder.decode_extract_packed``; segments.py:485-511). Shard
    s holds its local pairs of the s-th contiguous slice of the pair axis:
    its run starts offset by ``s * P_local * T`` and concatenated in shard
    order are the meshless extraction's pair-major stream. Returns
    ``(start int64, b, score, ns_kept, ns_raw)`` with per-shard counts: a
    shard's ``ns_kept[s] > kcap`` (or ``ns_raw[s]`` over the raw cap)
    means its row was truncated and the batch is redone at grown caps."""
    kcap = (mat.shape[1] - 2) // 3
    parts, ns_kept, ns_raw = [], [], []
    for s in range(mat.shape[0]):
        start, b, score, nk, nr = unpack_extract_rows(mat[s], kcap)
        ns_kept.append(nk)
        ns_raw.append(nr)
        k = min(nk, kcap)
        parts.append((start[:k].astype(np.int64) + s * P_local * T, b[:k],
                      score[:k]))
    return (*(np.concatenate([p[i] for p in parts]) for i in range(3)),
            ns_kept, ns_raw)


def runs_from_packed(start: np.ndarray, b: np.ndarray, score: np.ndarray,
                     T: int):
    """(pair, a, b, score) with window-relative positions from an unpacked,
    count-sliced row (segments.py:514-521)."""
    return start // T, start % T, b, score
