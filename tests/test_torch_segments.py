"""Run extraction in PyTorch against the JAX package's device extraction
(segments.extract_packed at a cap large enough never to truncate,
run_pps_jax, run_ages_jax), on seeded threshold-sum matrices whose values
sit at and next to the four level thresholds.

Run bounds and counts must be identical; scores agree to rtol 1e-6 and
per-run state sums to atol 1e-6 (f32 sums in another order); the
posterior-mean age to rtol 1e-5; the MAP age must be equal. The
pipeline's two phases (count_runs, then compact_runs at the caps
sized_caps gives) must count exactly the plain version's runs and give
its runs, scores and state sums bit for bit; below its counts a
compaction keeps its first runs and reports the true counts."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastsmc_tpu.engine import segments as jseg

from fastsmc_tpu_torch.engine import segments as seg

PROB = float(np.float32(7.3e-4))


def _th(seed, T, P):
    """[T, P] f32 with sticky levels: values drawn from the thresholds,
    their f32 neighbours, zero and uniform noise."""
    rng = np.random.default_rng(seed)
    lv = np.array(seg.level_thresholds(PROB), np.float32)
    vals = np.concatenate([lv, np.nextafter(lv, 0), np.nextafter(lv, 1),
                           [0.0, 0.5, 1.0]]).astype(np.float32)
    th = np.empty((T, P), np.float32)
    cur = rng.choice(vals, P)
    for t in range(T):
        redraw = rng.random(P) < 0.35
        cur = np.where(redraw, rng.choice(vals, P), cur)
        noise = rng.random(P) < 0.1
        th[t] = np.where(noise, rng.random(P).astype(np.float32), cur)
    return th


def _windows(seed, T, P):
    rng = np.random.default_rng(seed + 1)
    w0 = rng.integers(0, T // 2, P).astype(np.int32)
    w1 = (w0 + rng.integers(1, T, P)).clip(max=T).astype(np.int32)
    return w0, w1


CASES = [(1, 64, 16, 0, 64), (2, 64, 16, 3, 59), (3, 128, 8, 10, 128),
         (4, 256, 32, 0, 200)]


def _jax_runs(th, s0, s1, w0, w1):
    T, P = th.shape
    thm = jseg.mask_window(jnp.asarray(th), w0, w1)
    cap = (T * P + 255) // 256 * 256
    packed, _ = jseg.extract_packed(thm, s0, s1, PROB, cap)
    start, b, score, n_kept, n_raw = jseg.unpack_extract_rows(
        np.asarray(packed), cap)
    assert n_raw <= cap
    k = n_kept
    return start[:k] // T, start[:k] % T, b[:k], score[:k], n_kept, thm


@pytest.mark.parametrize("seed,T,P,s0,s1", CASES)
def test_extract_kept_runs_match_jax(seed, T, P, s0, s1):
    th = _th(seed, T, P)
    w0, w1 = _windows(seed, T, P)
    jp, ja, jb, jscore, n_kept, thm = _jax_runs(th, s0, s1, w0, w1)
    tm = seg.mask_window(torch.from_numpy(th), w0, w1)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(thm))
    pair, a, b, score = seg.extract_kept_runs(tm, s0, s1, PROB)
    assert len(pair) == n_kept > 0
    np.testing.assert_array_equal(pair.numpy(), jp)
    np.testing.assert_array_equal(a.numpy(), ja)
    np.testing.assert_array_equal(b.numpy(), jb)
    np.testing.assert_allclose(score.numpy(), jscore, rtol=1e-6)


@pytest.mark.parametrize("seed,T,P,s0,s1", CASES)
def test_raw_runs_cover_window(seed, T, P, s0, s1):
    """Every site of [s0, s1) lies in exactly one raw run of its column,
    and levels classify against p, 10p, 100p, 1000p in f32."""
    th = _th(seed, T, P)
    pair, a, b, lv = seg.boundaries_runs(torch.from_numpy(th), s0, s1, PROB)
    p = np.float32(PROB)
    want = (4 - (th >= p).astype(int) - (th >= np.float32(10) * p)
            - (th >= np.float32(100) * p) - (th >= np.float32(1000) * p))
    cover = np.zeros((T, P), int)
    for q, x, y, v in zip(pair.numpy(), a.numpy(), b.numpy(), lv.numpy()):
        cover[x:y + 1, q] += 1
        assert (want[x:y + 1, q] == v).all() or v == 4
    assert (cover[s0:s1] <= 1).all()
    kept = want[s0:s1] != 4
    assert (cover[s0:s1][kept] == 1).all()


@pytest.mark.parametrize("age_threshold", [11, 69])
@pytest.mark.parametrize("seed,T,P,s0,s1", CASES[:3])
def test_run_pps_and_ages_match_jax(n300_dq, seed, T, P, s0, s1,
                                    age_threshold):
    th = _th(seed, T, P)
    w0, w1 = _windows(seed, T, P)
    jp, ja, jb, _, n, _ = _jax_runs(th, s0, s1, w0, w1)
    K = n300_dq.states
    rng = np.random.default_rng(seed + 2)
    post = rng.random((T, K, P)).astype(np.float32) ** 4
    post /= post.sum(axis=1, keepdims=True)
    pps_cap = (n + 255) // 256 * 256
    jpps = jseg.run_pps_jax(jnp.asarray(post), jnp.asarray(jp, jnp.int32),
                            jnp.asarray(ja, jnp.int32),
                            jnp.asarray(jb, jnp.int32), pps_cap, n=n)
    exp = np.asarray(n300_dq.expected_times, np.float32)
    isp = np.asarray(n300_dq.initial_state_prob, np.float32)
    jages = np.asarray(jseg.run_ages_jax(jpps, jnp.asarray(exp),
                                         jnp.asarray(isp), age_threshold))

    pps = seg.run_pps(torch.from_numpy(post), torch.tensor(jp).long(),
                      torch.tensor(ja).long(), torch.tensor(jb).long())
    np.testing.assert_allclose(pps.numpy(), np.asarray(jpps)[:n], rtol=0,
                               atol=1e-6)
    ages = seg.run_ages(pps, torch.from_numpy(exp), torch.from_numpy(isp),
                        age_threshold).numpy()
    np.testing.assert_allclose(ages[0], jages[0, :n], rtol=1e-5)
    np.testing.assert_array_equal(ages[1], jages[1, :n])


def test_no_runs_gives_empty_outputs():
    th = torch.zeros((64, 4))
    pair, a, b, score = seg.extract_kept_runs(th, 0, 64, PROB)
    assert len(pair) == len(score) == 0
    pps = seg.run_pps(torch.zeros((64, 5, 4)), pair, a, b)
    assert pps.shape == (0, 5)
    assert seg.run_ages(pps, torch.ones(5), torch.ones(5), 3).shape == (2, 0)


def _packed_runs(packed, kcap, T):
    start, b, score, nk, nr = seg.unpack_extract_rows(packed.numpy(), kcap)
    k = min(nk, kcap)
    pair, a, b, score = seg.runs_from_packed(start[:k], b[:k], score[:k], T)
    return pair, a, b, score, nk, nr


def _masked(seed, T, P, windowed=True):
    th = torch.from_numpy(_th(seed, T, P))
    if not windowed:
        return th
    w0, w1 = _windows(seed, T, P)
    return seg.mask_window(th, torch.from_numpy(w0), torch.from_numpy(w1))


def _plain(tm, s0, s1):
    """The uncapped plain version's kept runs and scores, and the raw
    boundary count."""
    runs = tuple(x.numpy() for x in seg.extract_kept_runs(tm, s0, s1, PROB))
    return runs, len(seg.boundaries_runs(tm, s0, s1, PROB)[0])


@pytest.mark.parametrize("windowed", [True, False], ids=["windows", "whole"])
@pytest.mark.parametrize("seed,T,P,s0,s1", CASES)
def test_count_phase_counts_the_plain_runs(seed, T, P, s0, s1, windowed):
    """count_runs' n_raw and n_kept are the lengths of boundaries_runs and
    extract_kept_runs, in one int32 tensor; its levels and flags are the
    plain version's."""
    tm = _masked(seed, T, P, windowed)
    (pair, *_), n_raw = _plain(tm, s0, s1)
    rc = seg.count_runs(tm, s0, s1, PROB)
    assert rc.counts.dtype == torch.int32 and rc.counts.shape == (2,)
    assert rc.counts.tolist() == [n_raw, len(pair)] and len(pair) > 0
    lvl_t = seg.levels(tm, s0, s1, PROB)
    assert torch.equal(rc.lvl_t, lvl_t)
    assert torch.equal(rc.flags, seg._changes(lvl_t))


@pytest.mark.parametrize("windowed", [True, False], ids=["windows", "whole"])
@pytest.mark.parametrize("seed,T,P,s0,s1", CASES)
def test_sized_compaction_holds_every_run(seed, T, P, s0, s1, windowed):
    """At the caps sized from its counts the compaction returns exactly the
    plain version's kept runs and scores, and run_pps' rows, with no
    truncation; the caps are the counts rounded up to a multiple of 256."""
    tm = _masked(seed, T, P, windowed)
    (pair, a, b, score), n_raw = _plain(tm, s0, s1)
    n = len(pair)
    rng = np.random.default_rng(seed + 3)
    post = torch.from_numpy(rng.random((T, 5, P)).astype(np.float32))
    want_pps = seg.run_pps(post, *(torch.from_numpy(x) for x in (pair, a, b)))
    rc = seg.count_runs(tm, s0, s1, PROB)
    cap, kcap = seg.sized_caps([tuple(rc.counts.tolist())])
    assert (cap, kcap) == (-(-n_raw // 256) * 256, -(-n // 256) * 256)
    packed, pps = seg.compact_runs(tm, s1, rc, cap, kcap, post)
    assert packed.shape == (3 * kcap + 2,) and pps.shape == (kcap, 5)
    got = _packed_runs(packed, kcap, T)
    assert got[4:] == (n, n_raw)
    for x, y in zip(got[:4], (pair, a, b, score)):
        np.testing.assert_array_equal(x, y)
    assert torch.equal(pps[:n], want_pps) and not pps[n:].any()


@pytest.mark.parametrize("S", [2, 4])
def test_mesh_caps_are_the_largest_shards_count(S):
    """A CPU mesh's shards (contiguous slices of the pair axis) each count
    their own runs; the caps are sized from the largest shard's counts,
    every shard's row holds all its runs at them, and the merged rows are
    the meshless extraction's."""
    seed, T, P, s0, s1 = 4, 256, 32, 0, 200
    tm = _masked(seed, T, P)
    (pair, a, b, score), n_raw = _plain(tm, s0, s1)
    Pl = P // S
    shards = [tm[:, s * Pl:(s + 1) * Pl] for s in range(S)]
    rcs = [seg.count_runs(x, s0, s1, PROB) for x in shards]
    counts = [tuple(rc.counts.tolist()) for rc in rcs]
    assert len(set(counts)) > 1 and sum(c[0] for c in counts) == n_raw
    cap, kcap = seg.sized_caps(counts)
    assert (cap, kcap) == seg.sized_caps([(max(c[0] for c in counts),
                                           max(c[1] for c in counts))])
    mat = np.stack([seg.compact_runs(x, s1, rc, cap, kcap)[0].numpy()
                    for x, rc in zip(shards, rcs)])
    start, bb, sc, ns_kept, ns_raw = seg.merge_packed_shards(mat, T, Pl)
    assert list(zip(ns_raw, ns_kept)) == counts
    np.testing.assert_array_equal(start // T, pair)
    np.testing.assert_array_equal(start % T, a)
    np.testing.assert_array_equal(bb, b)
    np.testing.assert_array_equal(sc, score)


@pytest.mark.parametrize("seed,T,P,s0,s1", CASES)
def test_capped_extraction_matches_plain(seed, T, P, s0, s1):
    """The compaction at caps at or above the counts (exactly the counts,
    every site a boundary, a few over) gives the plain version's runs,
    scores and state sums bit for bit."""
    tm = _masked(seed, T, P)
    (pair, a, b, score), n_raw = _plain(tm, s0, s1)
    n = len(pair)
    rng = np.random.default_rng(seed + 3)
    post = torch.from_numpy(rng.random((T, 5, P)).astype(np.float32))
    want_pps = seg.run_pps(post, *(torch.from_numpy(x) for x in (pair, a, b)))
    rc = seg.count_runs(tm, s0, s1, PROB)
    for cap, kcap in ((n_raw, n), (T * P, T * P), (n_raw + 3, n + 7)):
        packed, pps = seg.compact_runs(tm, s1, rc, cap, kcap, post)
        assert packed.dtype == torch.int32
        assert packed.shape == (3 * kcap + 2,)
        got = _packed_runs(packed, kcap, T)
        assert got[4:] == (n, n_raw)
        for x, y in zip(got[:4], (pair, a, b, score)):
            np.testing.assert_array_equal(x, y)
        assert pps.shape == (kcap, 5)
        assert torch.equal(pps[:n], want_pps) and not pps[n:].any()


@pytest.mark.parametrize("seed,T,P,s0,s1", CASES)
def test_capped_extraction_reports_overflow(seed, T, P, s0, s1):
    """Below its count a pass keeps its first runs and the row holds the
    true counts: a kept cap below the count keeps the first kcap runs
    exactly and reports the true kept count; a raw cap below the count
    reports the true raw count. (The pipeline's caps, from sized_caps,
    are never below the counts.)"""
    th = torch.from_numpy(_th(seed, T, P))
    (pair, a, b, score), n_raw = _plain(th, s0, s1)
    n = len(pair)
    rc = seg.count_runs(th, s0, s1, PROB)
    kcap = n // 2
    packed, _ = seg.compact_runs(th, s1, rc, n_raw, kcap)
    got = _packed_runs(packed, kcap, T)
    assert got[4:] == (n, n_raw) and n > kcap
    for x, y in zip(got[:4], (pair, a, b, score)):
        np.testing.assert_array_equal(x, y[:kcap])
    packed, _ = seg.compact_runs(th, s1, rc, n_raw // 2, n_raw // 2)
    assert _packed_runs(packed, n_raw // 2, T)[5] == n_raw
