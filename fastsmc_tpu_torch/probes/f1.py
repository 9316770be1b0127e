"""Interval F1 of two IBD record files.

A copy of ``scripts/f1_vs_reference.py``'s ``f1_scores`` and its helpers
(:221-300): the port scores one profile's records against another's with
it.
"""

import gzip
from collections import defaultdict


def read_segments(path):
    """{pair_key: [(start, end bp)]} with pair key orientation-normalized."""
    out = defaultdict(list)
    with gzip.open(path, "rt") as f:
        for line in f:
            c = line.rstrip("\n").split("\t")
            k1 = (c[0], c[1], c[2])
            k2 = (c[3], c[4], c[5])
            key = (k1, k2) if k1 <= k2 else (k2, k1)
            out[key].append((int(c[7]), int(c[8])))
    return out


def merge_intervals(iv):
    iv = sorted(iv)
    out = [list(iv[0])]
    for s, e in iv[1:]:
        if s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def overlap_len(a, b):
    """Total intersection of two merged interval lists."""
    i = j = tot = 0
    while i < len(a) and j < len(b):
        s = max(a[i][0], b[j][0])
        e = min(a[i][1], b[j][1])
        if s <= e:
            tot += e - s + 1
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return tot


def f1_scores(golden_path, ours_path):
    """Base-pair-level precision/recall/F1 over per-pair merged intervals,
    and segment-level P/R/F1 at >= 50 % overlap, of the records at
    ``ours_path`` against those at ``golden_path`` (``.ibd.gz``)."""
    gold = read_segments(golden_path)
    ours = read_segments(ours_path)

    # base-pair level over merged per-pair intervals
    g_tot = o_tot = inter = 0
    for key in set(gold) | set(ours):
        gm = merge_intervals(gold[key]) if key in gold else []
        om = merge_intervals(ours[key]) if key in ours else []
        g_tot += sum(e - s + 1 for s, e in gm)
        o_tot += sum(e - s + 1 for s, e in om)
        if gm and om:
            inter += overlap_len(gm, om)
    bp_p = inter / o_tot if o_tot else 0.0
    bp_r = inter / g_tot if g_tot else 0.0
    bp_f1 = 2 * bp_p * bp_r / (bp_p + bp_r) if bp_p + bp_r else 0.0

    # segment level: matched iff some segment of the same pair covers >=50%
    def matched(segs_a, segs_b):
        n = 0
        for key, lst in segs_a.items():
            other = segs_b.get(key)
            if not other:
                continue
            om = merge_intervals(other)
            for s, e in lst:
                if overlap_len([[s, e]], om) >= 0.5 * (e - s + 1):
                    n += 1
        return n

    n_gold = sum(len(v) for v in gold.values())
    n_ours = sum(len(v) for v in ours.values())
    seg_r = matched(gold, ours) / n_gold if n_gold else 0.0
    seg_p = matched(ours, gold) / n_ours if n_ours else 0.0
    seg_f1 = 2 * seg_p * seg_r / (seg_p + seg_r) if seg_p + seg_r else 0.0
    return {
        "golden_segments": n_gold, "our_segments": n_ours,
        "bp_precision": round(bp_p, 4), "bp_recall": round(bp_r, 4),
        "bp_f1": round(bp_f1, 4),
        "seg_precision": round(seg_p, 4), "seg_recall": round(seg_r, 4),
        "seg_f1": round(seg_f1, 4),
    }
