"""Whether what the window produced is right: each entry's outputs against
the plain reference in ``gpubench/reference``, and the control that must
fail the same comparison.

ASMC: one job of the window, drawn from the seed; its four sums files as
written, against the reference's sums of every pair of that job. The
number is ``sums_gap``, the largest gap at any site and state of any file,
over the job's pairs: a gap in the mean posterior of a pair.

FastSMC: one job of the window, drawn from the seed, and pairs of it drawn
from the seed; every record the program wrote for those pairs against the
records of the reference's posterior (``reference.ibd.compare_pair``).
"""

from __future__ import annotations

import gzip

import numpy as np

from .reference import hmm, ibd
from .reference.jobs import job_range, pairs


# ---------------------------------------------------------------------------
# ASMC: sums over the job's pairs
# ---------------------------------------------------------------------------

def asmc_files(params: dict) -> dict:
    """The sums files a job writes, by name: suffix of the output root."""
    out = {}
    if params.get("do_posterior_sums"):
        out["sums"] = ".sumOverPairs.gz"
    if params.get("do_major_minor_posterior_sums"):
        out.update(sums00=".00.sumOverPairs.gz", sums01=".01.sumOverPairs.gz",
                   sums11=".11.sumOverPairs.gz")
    return out


def asmc_reference(pan, model, jobs: int, job: int, precision: str,
                   block: int, names) -> dict:
    """The matrices [sites, K] of the files ``names`` for job ``job`` of
    ``jobs``, as the files hold them: the posterior summed over the job's
    pairs; by class of the pair's observation at the site for the three
    major/minor files, whose both-major and both-minor matrices trade
    places at sites folded to the minor allele (main.cpp:126-165)."""
    s, e = job_range(pan.haplotypes // 2, jobs, job)
    h1, h2 = pairs(np.arange(s, e))
    dec = hmm.Decoder(model, pan.bits, precision)
    cs = hmm.class_sums(dec, h1, h2, block)        # [L, 3, K]
    f = pan.flipped[:, None]
    every = dict(sums=cs.sum(axis=1), sums01=cs[:, 0],
                 sums00=np.where(f, cs[:, 2], cs[:, 1]),
                 sums11=np.where(f, cs[:, 1], cs[:, 2]))
    return {k: every[k] for k in names}


def as_written(mat: np.ndarray) -> np.ndarray:
    """float32 values as the sums writer prints them (``%.6g``)."""
    flat = [float("%.6g" % v) for v in np.asarray(mat, np.float32).ravel()]
    return np.asarray(flat).reshape(mat.shape)


def read_matrix(path: str) -> np.ndarray:
    with gzip.open(path, "rt") as f:
        return np.loadtxt(f, delimiter="\t", ndmin=2)


def asmc_gaps(got: dict, want: dict, n_pairs: int) -> dict:
    gap = 0.0
    for k, w in want.items():
        g = got[k]
        if g.shape != w.shape:
            return {"sums_gap": float("inf")}
        gap = max(gap, float(np.abs(g - w).max()))
    return {"sums_gap": gap / n_pairs}


def check_asmc(cell, pan, model, job: dict, jobs: int, rng) -> dict:
    chk = cell.config["check"]
    want = asmc_reference(pan, model, jobs, job["job"], chk["precision"],
                          int(chk["block_pairs"]), job["files"])
    got = {k: read_matrix(p) for k, p in job["files"].items()}
    return asmc_gaps(got, want, job["pairs"])


def control_asmc(cell, pan, model, jobs: int, job: int, rng=None) -> dict:
    """The reference at the control's precision in the program's place."""
    chk = cell.config["check"]
    names = asmc_files(cell.config["params"])
    want = asmc_reference(pan, model, jobs, job, chk["precision"],
                          int(chk["block_pairs"]), names)
    got = asmc_reference(pan, model, jobs, job, chk["control"],
                         int(chk["block_pairs"]), names)
    s, e = job_range(pan.haplotypes // 2, jobs, job)
    return asmc_gaps({k: as_written(v) for k, v in got.items()}, want, e - s)


# ---------------------------------------------------------------------------
# FastSMC: the records of sampled pairs
# ---------------------------------------------------------------------------

NUMBERS = ("boundary_gap", "score_rel", "age_rel", "map_gap")


def sample_pairs(n_ind: int, jobs: int, job: int, n: int, rng):
    """``n`` pairs of the job drawn from ``rng``, without repeats."""
    s, e = job_range(n_ind, jobs, job)
    flat = s + np.sort(rng.choice(e - s, size=min(n, e - s), replace=False))
    return pairs(flat)


def _hap_key(h: int) -> tuple:
    return (f"f{h >> 1}".encode(), str(1 + (h & 1)).encode())


def read_records(path: str, h1, h2, positions: np.ndarray) -> dict:
    """The records of the pairs ``(h1[i], h2[i])`` in the ``.ibd.gz`` at
    ``path``, whose sites are at the physical ``positions``: per pair
    index i, arrays ``a``, ``b`` (sites), ``score``, ``mean_age`` and
    ``map_age``."""
    keys = {(*_hap_key(int(x)), *_hap_key(int(y))): i
            for i, (x, y) in enumerate(zip(h1, h2))}
    rows = {}
    with gzip.open(path, "rb") as f:
        for line in f:
            p = line.split(b"\t")
            i = keys.get((p[0], p[2], p[3], p[5]))
            if i is not None:
                rows.setdefault(i, []).append(
                    (int(p[7]), int(p[8]), float(p[10]), float(p[11]),
                     float(p[12])))
    return {i: _columns(r, positions) for i, r in rows.items()}


def _columns(rows, positions: np.ndarray) -> dict:
    r = np.asarray(rows, np.float64).reshape(-1, 5)
    site = np.searchsorted(positions, r[:, :2].astype(np.int64))
    return dict(a=site[:, 0], b=site[:, 1], score=r[:, 2],
                mean_age=r[:, 3], map_age=r[:, 4])


NO_RECORDS = _columns([], np.zeros(0, np.int64))


def record_rule(cell, model) -> ibd.Rule:
    p = cell.config["params"]
    return ibd.make_rule(model.discretization, model.isp,
                         model.expected_times, int(p["time"]),
                         not p.get("no_conditional_age_estimates", False))


def fastsmc_gaps(got: dict, h1, h2, pan, model, rule, precision: str,
                 block: int) -> dict:
    """The largest of each of ``NUMBERS`` over the pairs, with the counts
    of pairs and records compared."""
    dec = hmm.Decoder(model, pan.bits, precision)
    out = dict.fromkeys(NUMBERS, 0.0)
    out.update(pairs=len(h1), records=0, matched=0)
    for p0 in range(0, len(h1), block):
        post, _ = dec.posterior(h1[p0:p0 + block], h2[p0:p0 + block])
        post = post.permute(2, 0, 1).double().cpu().numpy()
        for i in range(post.shape[0]):
            r = ibd.compare_pair(got.get(p0 + i, NO_RECORDS), post[i], rule)
            for k in NUMBERS:
                out[k] = max(out[k], r[k])
            out["records"] += r["records"]
            out["matched"] += r["matched"]
        del post
    return out


def check_fastsmc(cell, pan, model, job: dict, jobs: int, rng) -> dict:
    chk = cell.config["check"]
    h1, h2 = sample_pairs(pan.haplotypes // 2, jobs, job["job"],
                          int(chk["pairs"]), rng)
    got = read_records(job["files"]["ibd"], h1, h2, pan.physical_positions)
    return fastsmc_gaps(got, h1, h2, pan, model, record_rule(cell, model),
                        chk["precision"], int(chk["block_pairs"]))


def control_fastsmc(cell, pan, model, jobs: int, job: int, rng) -> dict:
    """The reference at the control's precision in the program's place:
    its records, with the values the program's writer would print."""
    chk = cell.config["check"]
    rule = record_rule(cell, model)
    h1, h2 = sample_pairs(pan.haplotypes // 2, jobs, job, int(chk["pairs"]),
                          rng)
    dec = hmm.Decoder(model, pan.bits, chk["control"])
    got = {}
    block = int(chk["block_pairs"])
    for p0 in range(0, len(h1), block):
        post, _ = dec.posterior(h1[p0:p0 + block], h2[p0:p0 + block])
        post = post.permute(2, 0, 1).double().cpu().numpy()
        for i in range(post.shape[0]):
            a, b, score, mean_age, map_age, _ = ibd.runs(post[i], rule)
            got[p0 + i] = dict(a=a, b=b, score=_g7(score),
                               mean_age=_g7(mean_age), map_age=_g7(map_age))
    return fastsmc_gaps(got, h1, h2, pan, model, rule, chk["precision"],
                        block)


def _g7(x) -> np.ndarray:
    return np.asarray([float("%.7g" % v) for v in np.float32(x)])


CHECKS = {"asmc": check_asmc, "fastsmc": check_fastsmc}
CONTROLS = {"asmc": control_asmc, "fastsmc": control_fastsmc}
