"""FastSMC's IBD records of one pair from its posterior, in NumPy, and the
comparison of a program's records with them.

A pair's record is a maximal run of sites with the same level, below the
last: the level of a site counts how many of p, 10p, 100p and 1000p the
posterior mass of the states younger than the time threshold reaches,
where p is the prior mass of those states (HMM.cpp:96-99, 1226-1308). Its
score is that mass averaged over the run; its mean age is the posterior
mean time of the run's summed posterior over the states below the age
threshold, and its MAP age the expected time of the state where that sum
most exceeds the prior (HMM.cpp:1087-1107).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Rule:
    """What turns a posterior into records."""
    state_threshold: int          # states younger than the time threshold
    age_threshold: int            # states the ages are taken over
    thresholds: np.ndarray        # p, 10p, 100p, 1000p
    expected_times: np.ndarray    # [K]
    prior: np.ndarray             # [K] initial state probabilities


def make_rule(discretization, isp, expected_times, time: int,
              conditional_ages: bool) -> Rule:
    """The record rule for a time threshold of ``time`` generations. The
    threshold p is the prior mass summed in float32 in state order, and
    each multiple of it rounded to float32, as the program's format is."""
    K = len(isp)
    st = 0
    while st < K and discretization[st] < float(time):
        st += 1
    p = np.float32(0.0)
    for x in np.asarray(isp, np.float32)[:st]:
        p = np.float32(p + x)
    thr = np.asarray([np.float32(m) * p for m in (1.0, 10.0, 100.0, 1000.0)],
                     np.float64)
    return Rule(st, st if conditional_ages else K, thr,
                np.asarray(expected_times, np.float64),
                np.asarray(isp, np.float64))


def runs(post: np.ndarray, rule: Rule):
    """Records of one pair from its posterior ``post`` [L, K]:
    ``(a, b, score, mean_age, map_age, th)`` with int arrays ``a``, ``b``
    (inclusive sites), float arrays of the rest, and ``th`` [L], the mass
    below the time threshold at each site."""
    a, b, score, th, pps = _runs(post, rule)
    return (a, b, score, mean_age(pps, rule), map_age(pps, rule), th)


def _runs(post: np.ndarray, rule: Rule):
    """``(a, b, score, th, pps)``: the records' sites and scores, the mass
    below the time threshold, and each record's posterior summed over its
    sites, per state below the age threshold [n, A]."""
    th = post[:, :rule.state_threshold].sum(axis=1)
    level = 4 - (th[:, None] >= rule.thresholds[None, :]).sum(axis=1)
    change = np.flatnonzero(np.diff(level)) + 1
    starts = np.concatenate([[0], change])
    ends = np.concatenate([change - 1, [len(th) - 1]])
    keep = level[starts] < 4
    a, b = starts[keep], ends[keep]
    cs = np.concatenate([[0.0], np.cumsum(th)])
    score = (cs[b + 1] - cs[a]) / (b - a + 1)
    A = rule.age_threshold
    cp = np.concatenate([np.zeros((1, A)),
                         np.cumsum(post[:, :A], axis=0)])
    return a, b, score, th, cp[b + 1] - cp[a]


def mean_age(pps: np.ndarray, rule: Rule) -> np.ndarray:
    A = pps.shape[1]
    return (pps / pps.sum(axis=1, keepdims=True)
            * rule.expected_times[None, :A]).sum(axis=1)


def map_ratio(pps: np.ndarray, rule: Rule) -> np.ndarray:
    """Each state's summed posterior over its prior [n, A]: the MAP age
    is the expected time of the largest."""
    return pps / rule.prior[None, :pps.shape[1]]


def map_age(pps: np.ndarray, rule: Rule) -> np.ndarray:
    return rule.expected_times[map_ratio(pps, rule).argmax(axis=1)]


def _boundaries(a: np.ndarray, b: np.ndarray, L: int) -> set:
    """Sites where a level change meets a record: each record's first
    site and the site after its last."""
    return set(a.tolist()) | {x + 1 for x in b.tolist() if x + 1 < L}


def compare_pair(got: dict, post: np.ndarray, rule: Rule) -> dict:
    """Gaps between one pair's records as the program wrote them (``got``:
    arrays ``a``, ``b``, ``score``, ``mean_age``) and those of the
    reference posterior ``post`` [L, K]:

    * ``boundary_gap``: at each site where a record starts or ends in one
      and not the other, how near the reference's mass at the site or the
      one before lies to a threshold (relative); the largest, 0 if none.
      A decode as exact as the reference disagrees only at such near-ties.
    * ``score_rel``, ``age_rel``: the largest relative gap of the score and
      of the mean age over the records both have.
    * ``map_gap``: over the records both have, where the MAP age names
      another state than the reference's, how far that state's ratio of
      summed posterior to prior lies below the largest (relative); 0 if
      none, 1 where the age is no state's expected time. A decode as exact
      as the reference disagrees only at near-ties.
    """
    L = post.shape[0]
    a, b, score, th, pps = _runs(post, rule)
    ages = mean_age(pps, rule)
    ratio = map_ratio(pps, rule)
    times = rule.expected_times[:ratio.shape[1]]
    out = dict(boundary_gap=0.0, score_rel=0.0, age_rel=0.0, map_gap=0.0,
               records=len(a), matched=0)
    miss = _boundaries(a, b, L) ^ _boundaries(got["a"], got["b"], L)
    for t in miss:
        s = np.asarray([x for x in (t - 1, t) if 0 <= x < L])
        near = np.abs(th[s][:, None] / rule.thresholds[None, :] - 1.0).min()
        out["boundary_gap"] = max(out["boundary_gap"], float(near))
    ref = {(int(x), int(y)): i for i, (x, y) in enumerate(zip(a, b))}
    for j, key in enumerate(zip(got["a"].tolist(), got["b"].tolist())):
        i = ref.get(key)
        if i is None:
            continue
        out["matched"] += 1
        out["score_rel"] = max(out["score_rel"], abs(
            got["score"][j] / score[i] - 1.0))
        out["age_rel"] = max(out["age_rel"], abs(
            got["mean_age"][j] / ages[i] - 1.0))
        out["map_gap"] = max(out["map_gap"], _map_gap(
            got["map_age"][j], ratio[i], times))
    return out


def _map_gap(age: float, ratio: np.ndarray, times: np.ndarray) -> float:
    k = int(np.abs(times / age - 1.0).argmin())
    if abs(times[k] / age - 1.0) > 1e-6:       # %.7g of a state's time
        return 1.0
    return float(1.0 - ratio[k] / ratio.max())
