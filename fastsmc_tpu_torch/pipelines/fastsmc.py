"""FastSMC pipeline on the GPU: hashing, batched validation, IBD output.

Counterpart of ``fastsmc_tpu/pipelines/fastsmc.py`` in array mode, exact
profile, with the reference's record columns. In hashing mode the
GERMLINE2 scan runs natively on a producer thread; each candidate is
bucketed into the smallest aligned power-of-two window holding its 0.5
cM-padded match; a full bucket is one batch. Without hashing every pair of
the job's slice of the flat pair enumeration is a candidate, decoded over
the whole chromosome in batches of ``batch_size``. Either way a batch is
decoded by the two CUDA kernels, run-extracted on the card, copied to the
host and written. Record order equals the JAX package's.
"""

from __future__ import annotations

import os
import time
from typing import List, Optional

import numpy as np

from fastsmc_tpu.config import DecodingParams
from fastsmc_tpu.engine.oracle import DecodeContext
from fastsmc_tpu.hashing.germline import HashingScan
from fastsmc_tpu.io import writers
from fastsmc_tpu.io.decoding_quantities import DecodingQuantities
from fastsmc_tpu.io.haps import Data, load_data
from fastsmc_tpu.utils.timer import PhaseTimer

from ..engine import segments as seg
from ..engine.hmm import bucket_len
from ..engine.kernels import GpuDecoder, resolve_device
from ..writers import IbdTextWriter
from .asmc import job_pair_range, pairs_from_flat_indices

# batches decoded before their runs are copied to the host and written
FLUSH_GROUP = 8


# The four pad helpers are copies of fastsmc_tpu/pipelines/fastsmc.py:35-81:
# that module imports JAX, so they cannot be imported from it.

def get_from_position(genetic_positions: np.ndarray, from_pos: int,
                      cm_dist: float = 0.5) -> int:
    """HmmUtils.cpp:153-164 (0.5 cM pre-padding)."""
    cum = 0.0
    g = genetic_positions
    while cum < cm_dist and from_pos > 0:
        from_pos -= 1
        cum += (g[from_pos + 1] - g[from_pos]) * 100.0
    return from_pos


def get_to_position(genetic_positions: np.ndarray, to_pos: int,
                    cm_dist: float = 0.5) -> int:
    """HmmUtils.cpp:166-177 (0.5 cM post-padding)."""
    cum = 0.0
    g = genetic_positions
    n = len(g)
    while cum < cm_dist and to_pos + 1 < n:
        to_pos += 1
        cum += (g[to_pos] - g[to_pos - 1]) * 100.0
    return min(to_pos + 1, n)


def pad_from_positions(genetic_positions: np.ndarray, from_pos: np.ndarray,
                       cm_dist: float = 0.5) -> np.ndarray:
    """Vectorized :func:`get_from_position` over a candidate array: the
    largest j with (g[from] - g[j]) * 100 >= cm_dist, else 0."""
    g = genetic_positions
    target = g[from_pos] - cm_dist / 100.0
    j = np.searchsorted(g, target, side="right") - 1
    return np.maximum(np.minimum(j, from_pos), 0).astype(np.int64)


def pad_to_positions(genetic_positions: np.ndarray, to_pos: np.ndarray,
                     cm_dist: float = 0.5) -> np.ndarray:
    """Vectorized :func:`get_to_position`: min(j + 1, n) for the smallest
    j >= to with (g[j] - g[to]) * 100 >= cm_dist, else n - 1."""
    g = genetic_positions
    n = len(g)
    tp = np.minimum(to_pos, n - 1)
    target = g[tp] + cm_dist / 100.0
    j = np.searchsorted(g, target, side="left")
    j = np.minimum(np.maximum(j, tp), n - 1)
    return np.minimum(j + 1, n).astype(np.int64)


class FastSMC:
    """End-to-end FastSMC run for one job on one CUDA device, with or
    without hashing."""

    def __init__(self, params: DecodingParams,
                 data: Optional[Data] = None,
                 dq: Optional[DecodingQuantities] = None,
                 device="cuda",
                 hashing_backend: str = "host",
                 decode_profile: str = "exact",
                 mesh=None,
                 sort_batches: int = 0,
                 bucket_sites: Optional[int] = None):
        """Arguments as the JAX package's ``FastSMC``; everything off the
        main path raises ``NotImplementedError`` until it is ported.
        ``device`` is where the tables live and the kernels run: "cuda"
        (raises without CUDA) or "cpu" (the plain versions, for tests)."""
        off_path = {
            "hashing_backend != 'host'": hashing_backend != "host",
            "decode_profile != 'exact'": decode_profile != "exact",
            "mesh": mesh is not None,
            "sort_batches": bool(sort_batches),
            "bucket_sites=0": bucket_sites == 0,
            "permissive_window": params.permissive_window,
            "sequence mode": params.decoding_mode == "sequence",
        }
        unported = [k for k, v in off_path.items() if v]
        if unported:
            raise NotImplementedError(f"not ported yet: {unported}")
        device = resolve_device(device)
        params.fastsmc = True
        self.params = params
        self.data = data if data is not None else load_data(params)
        self.dq = dq if dq is not None else DecodingQuantities.load(
            params.decoding_quant_file)
        self.ctx = DecodeContext.build(params, self.data, self.dq)
        self.decoder = GpuDecoder(self.ctx, device)

        K = self.dq.states
        self.state_threshold = seg.state_threshold(
            self.dq.discretization, params.time, K)
        self.prob_threshold = seg.probability_threshold(
            self.dq.initial_state_prob, self.state_threshold)
        self.age_threshold = K if params.no_conditional_age_estimates \
            else self.state_threshold

        self._writer = None
        self.timer = PhaseTimer()
        self._cpt = 0
        self.n_segments = 0
        self._batch_idx = 0
        self._drains_since_ckpt = 0
        self._group: List[dict] = []
        # decode memory guard of the JAX package (fastsmc.py:236-247),
        # kept as it is: the split shapes programs, never outputs
        self._pad_floor = 256
        self._post_budget = 8 << 20
        self._alpha_budget = 16 << 20
        self._gp32 = np.float32(self.data.genetic_positions)
        self.bucket_sites = 64 if bucket_sites is None else bucket_sites
        self._buckets: dict = {}        # region -> list of column tuples
        self._bucket_n: dict = {}       # region -> buffered count
        self.stats = {"decoded_site_pairs": 0, "union_site_pairs": 0,
                      "cand_site_pairs": 0, "flushes": 0}

    # ------------------------------------------------------------------
    def _open_writer(self, append: bool = False):
        p = self.params
        path = p.ibd_output_path()
        if p.bin_out:
            self._writer = writers.IbdBinaryWriter(
                path, self.data.fam_id_list, self.data.iid_list,
                self.data.chr_number, p.output_ibd_segment_length,
                p.do_per_pair_posterior_mean, p.do_per_pair_map,
                append=append)
        else:
            self._writer = IbdTextWriter(
                path, self.data.fam_id_list, self.data.iid_list,
                self.data.chr_number, append=append)
        return path

    # ------------------------------------------------------------------
    # candidate intake and canonical-window buckets (fastsmc.py:292-408)
    # ------------------------------------------------------------------
    def _on_match(self, id1: int, id2: int, from_pos: int, to_pos: int):
        self._on_matches_array(
            np.asarray([id1], np.int32), np.asarray([id2], np.int32),
            np.asarray([from_pos], np.int64), np.asarray([to_pos], np.int64))

    def _on_matches_array(self, id1, id2, from_pos, to_pos):
        self._cpt += len(id1)
        self._bucket_push(np.asarray(id1, np.int32),
                          np.asarray(id2, np.int32),
                          np.asarray(from_pos, np.int64),
                          np.asarray(to_pos, np.int64))

    def _canonical_windows(self, frm, to):
        """Canonical decode window per candidate: the smallest aligned
        power-of-two block [o, o + 2^k) (alignment 2^(k-1)) containing
        the candidate's 0.5 cM-PADDED window. Returns (k, o) arrays."""
        g = self.data.genetic_positions
        frm_p = pad_from_positions(g, frm)
        t2_p = pad_to_positions(g, to)
        ln = np.maximum(t2_p - frm_p, 1)
        k = np.frexp(ln.astype(np.float64))[1]        # ceil log2
        k = np.maximum(k, max(int(self.bucket_sites).bit_length() - 1, 6))
        o = (frm_p >> (k - 1)) << (k - 1)
        fits = o + (np.int64(1) << k) >= t2_p
        k = np.where(fits, k, k + 1)                  # at most one bump
        o = (frm_p >> (k - 1)) << (k - 1)
        return k.astype(np.int64), o.astype(np.int64)

    def _bucket_push(self, id1, id2, frm, to):
        """Assign each candidate its canonical window; a bucket that holds
        batch_size candidates flushes at once. A candidate's output then
        depends only on (pair, canonical window), never on batch size,
        arrival order or batch composition."""
        bs = self.params.batch_size
        kk, oo = self._canonical_windows(frm, to)
        key = (kk << 48) | oo
        order = np.argsort(key, kind="stable")
        keys, starts = np.unique(key[order], return_index=True)
        for i, k in enumerate(keys):
            sl = order[starts[i]:
                       starts[i + 1] if i + 1 < len(keys) else None]
            k = int(k)
            self._buckets.setdefault(k, []).append(
                (id1[sl], id2[sl], frm[sl], to[sl]))
            n = self._bucket_n.get(k, 0) + len(sl)
            while n >= bs:
                cols = [np.concatenate([c_[j] for c_ in self._buckets[k]])
                        for j in range(4)]
                self._flush_bucket([c[:bs] for c in cols], k)
                self._buckets[k] = [tuple(c[bs:] for c in cols)]
                n -= bs
            self._bucket_n[k] = n

    def _flush_bucket(self, cols, key: int):
        """Flush one canonical-window batch: decode bounds come from the
        bucket key, not from the members' min/max."""
        k = key >> 48
        o = key & ((1 << 48) - 1)
        self._flush_entry(cols[0].astype(np.int32), cols[1].astype(np.int32),
                          cols[2], cols[3], self.params.batch_size,
                          int(o), int(min(o + (1 << k), self.data.sites)))

    def _drain_buckets(self):
        """End-of-scan flush: each remaining bucket tail flushes as its own
        (partial) batch, in key order."""
        for key in sorted(self._buckets):
            cols = [np.concatenate([c_[j] for c_ in self._buckets[key]])
                    for j in range(4)]
            if len(cols[0]):
                self._flush_bucket(cols, key)
        self._buckets.clear()
        self._bucket_n.clear()

    # ------------------------------------------------------------------
    def _flush_entry(self, h1, h2, fr, to, pad_to: int, frm: int, t2: int):
        """One batch over the decode window [frm, t2) (fastsmc.py:467-563):
        pad shrink, pair split under the memory guard, per-candidate scan
        windows, then queue it for the group dispatch."""
        n = len(h1)
        p = self.params
        g = self.data.genetic_positions
        start_batch = int(fr.min())
        end_batch = int(to.max())
        t_len = bucket_len(t2 - frm)
        need_ages = p.do_per_pair_posterior_mean or p.do_per_pair_map

        while pad_to > max(self._pad_floor, 1024) and n <= pad_to // 2:
            pad_to //= 2
        budget = self._post_budget if need_ages else self._alpha_budget
        if pad_to > self._pad_floor and n > 1 and t_len * pad_to > budget:
            k = (n + 1) // 2
            self._flush_entry(h1[:k], h2[:k], fr[:k], to[:k], pad_to // 2,
                              frm, t2)
            self._flush_entry(h1[k:], h2[k:], fr[k:], to[k:], pad_to // 2,
                              frm, t2)
            return
        self._batch_idx += 1

        # each candidate scans its own padded window (the reference's
        # flagged less-permissive option; config.permissive_window)
        w0r = np.clip(pad_from_positions(g, fr) - frm, 0, t_len
                      ).astype(np.int32)
        w1r = np.clip(pad_to_positions(g, to) - frm, 0, t_len
                      ).astype(np.int32)
        if n < pad_to:
            # pad to a fixed batch width with copies of the last candidate;
            # their runs are dropped at emit time
            fill = pad_to - n
            h1 = np.concatenate([h1, np.full(fill, h1[-1], np.int32)])
            h2 = np.concatenate([h2, np.full(fill, h2[-1], np.int32)])
            w0r = np.concatenate([w0r, np.full(fill, w0r[-1], np.int32)])
            w1r = np.concatenate([w1r, np.full(fill, w1r[-1], np.int32)])

        self.stats["flushes"] += 1
        self.stats["union_site_pairs"] += (end_batch - start_batch) * n
        self.stats["cand_site_pairs"] += int((to - fr).sum())
        self._group.append(dict(
            hap1=h1, hap2=h2, n=n, frm=frm, t_len=t_len, s0=0, s1=t2 - frm,
            w0=w0r, w1=w1r, P=pad_to, need_ages=need_ages,
            idx=self._batch_idx))
        if len(self._group) >= FLUSH_GROUP:
            self._dispatch_group()

    # ------------------------------------------------------------------
    # group dispatch and drain (fastsmc.py:569-741), on one CUDA stream
    # ------------------------------------------------------------------
    def _dispatch_group(self):
        if not self._group:
            return
        entries = self._group
        self._group = []
        self.stats["decoded_site_pairs"] += \
            sum(e["t_len"] * e["P"] for e in entries)
        with self.timer.phase("decode"):
            results = [self.decoder.decode_extract(
                e["hap1"], e["hap2"], e["frm"], e["t_len"],
                self.state_threshold, e["s0"], e["s1"], self.prob_threshold,
                self.age_threshold, self.dq.initial_state_prob,
                need_ages=e["need_ages"], w0=e["w0"], w1=e["w1"])
                for e in entries]
        self._drain_group(entries, results)

    def _drain_group(self, entries, results):
        with self.timer.phase("segments"):
            host = [[None if x is None else x.cpu().numpy() for x in r]
                    for r in results]
        with self.timer.phase("outputPerPair"):
            for e, (pair, a, b, score, ages) in zip(entries, host):
                self._emit_runs(e, pair, a, b, score, ages)
        # checkpoint every 16th drain (fastsmc.py:729-741); run() closes
        # the output without one
        self._drains_since_ckpt += 1
        if self._drains_since_ckpt >= 16:
            self._drains_since_ckpt = 0
            self._write_progress(entries[-1]["idx"])

    def _emit_runs(self, e, pair, a, b, score_sum, ages=None):
        """Write one batch's kept runs (window-relative a/b); ``ages`` is
        [2, n_kept] (posterior mean, MAP) aligned with the runs."""
        p = self.params
        keep = pair < e["n"]
        pair, a, b = pair[keep], a[keep], b[keep]
        score_sum = score_sum[keep]
        start = a + e["frm"]
        end = b + e["frm"]
        h1 = e["hap1"][pair]
        h2 = e["hap2"][pair]
        length = None
        if p.output_ibd_segment_length:
            gp32 = self._gp32
            length = np.float32(100.0) * (gp32[end] - gp32[start])
        score = score_sum.astype(np.float64) / (end - start + 1)
        post_est = map_est = None
        if ages is not None:
            if p.do_per_pair_posterior_mean:
                post_est = ages[0][keep]
            if p.do_per_pair_map:
                map_est = ages[1][keep]
        phys = self.data.physical_positions
        self._writer.write_block(h1 >> 1, 1 + (h1 & 1), h2 >> 1,
                                 1 + (h2 & 1), phys[start], phys[end],
                                 length, score, post_est, map_est)
        self.n_segments += len(pair)

    def _write_progress(self, done_idx: int):
        """Checkpoint (fastsmc.py:872-899): close the current gzip member
        so the file is valid up to here, record (finished batches,
        segments, byte offset), and reopen in append mode."""
        out = self.params.ibd_output_path()
        self._writer.close()
        # read after close(): it drains the writer thread's queue
        fmt_s = getattr(self._writer, "fmt_s", 0.0)
        deflate_s = getattr(self._writer, "deflate_s", 0.0)
        offset = os.path.getsize(out)
        path = out + ".progress"
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(f"{done_idx} {self.n_segments} {offset}\n")
        os.replace(tmp, path)
        self._open_writer(append=True)
        self._writer.fmt_s = fmt_s
        self._writer.deflate_s = deflate_s

    # ------------------------------------------------------------------
    def _run_no_hashing(self):
        """Every pair of the job's slice of the flat pair enumeration
        (HMM.cpp:310-364), decoded over the whole chromosome in batches of
        ``batch_size`` (fastsmc.py:1001-1042); the pairs come from the
        closed-form flat-index inversion, one batch at a time."""
        p = self.params
        L = self.data.sites
        start, end = job_pair_range(self.data.n_ind, p)
        for ofs in range(start, end, p.batch_size):
            h1, h2 = pairs_from_flat_indices(
                np.arange(ofs, min(ofs + p.batch_size, end)), p.within_only)
            n = len(h1)
            self._cpt += n
            self.stats["cand_site_pairs"] += L * n
            self._batch_idx += 1
            self._group.append(dict(
                hap1=h1.astype(np.int32), hap2=h2.astype(np.int32), n=n,
                frm=0, t_len=bucket_len(L), s0=0, s1=L, w0=None, w1=None,
                P=n, need_ages=(p.do_per_pair_posterior_mean
                                or p.do_per_pair_map),
                idx=self._batch_idx))
            if len(self._group) >= FLUSH_GROUP:
                self._dispatch_group()

    # ------------------------------------------------------------------
    def run(self, verbose: bool = True, resume: bool = False) -> str:
        """Full pipeline (fastsmc.py:1045-1110); returns the output path."""
        if resume:
            raise NotImplementedError("not ported yet: resume")
        t0 = time.time()
        self.timer = PhaseTimer()
        progress = self.params.ibd_output_path() + ".progress"
        path = self._open_writer()
        if self.params.hashing:
            with self.timer.phase("identification"):
                scan = HashingScan(self.params, self.data, self._on_match)
                scan.array_callback = self._on_matches_array
                scan.run(verbose=verbose)
            self._drain_buckets()
        else:
            self._run_no_hashing()
        self._dispatch_group()
        self._writer.close()
        if os.path.exists(progress):
            os.remove(progress)
        if verbose:
            print(f"[fastsmc] {self.n_segments} segments "
                  f"({self._cpt} candidates) in {time.time() - t0:.2f}s "
                  f"-> {path}")
            st = self.stats
            if st["cand_site_pairs"]:
                dr = st["decoded_site_pairs"] / st["cand_site_pairs"]
                ur = st["union_site_pairs"] / st["cand_site_pairs"]
                print(f"[fastsmc] window waste: decoded/candidate "
                      f"site-pairs = {dr:.2f}x (union/candidate = {ur:.2f}x, "
                      f"{st['flushes']} flushes)")
            self.timer.report()
        return path
