"""GERMLINE2-style identification stage (hashing engine).

Faithful reimplementation of the reference identification scan
(ASMC_SRC/SRC/FastSMC.cpp:118-235 and ASMC_SRC/SRC/HASHING/*):

  * 64-SNP words of *raw* (unfolded) alleles are the hash values
    (Individuals.hpp:58-62: the packed bits themselves);
  * per word: seed buckets (word -> hap list), enumerate colliding pairs,
    recursive sub-hashing when a bucket exceeds ``max_seeds``
    (SeedHash.hpp:56-93), triangular job-window pair filter
    (SeedHash.hpp:103-129);
  * matches extend word-by-word with a ``gap`` tolerance; matches not
    extended past ``w - gap`` flush to the validation callback if they span
    at least ``min_m`` cM (ExtendHash.hpp:85-98, Match.hpp:42-52);
  * low-complexity words (distinct seeds / haps <= ``skip``) bulk-extend all
    active matches (FastSMC.cpp:212-219);
  * the word read-ahead window caps sub-hash lookahead exactly like the
    reference ring buffer: when processing word w the reader has buffered
    words < min(total_words, w + read_ahead) (FastSMC.cpp:144-200).

The pair stream this produces is byte-for-byte the same *set* as the
reference; emission order is deterministic (Python dict insertion order
rather than boost::unordered_map hash order — the reference's own order is
implementation-defined).

The port's copy of ``fastsmc_tpu/hashing/germline.py``. This module is the
parity oracle; a C++ port of the same loop lives in ``native/`` for large
panels.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..config import DecodingParams
from ..io.haps import Data, JobWindows
from ..utils.timer import SpanRecorder

# callback signature: (hap_id1, hap_id2, from_pos, to_pos_inclusive)
MatchCallback = Callable[[int, int, int, int], None]
# the producer thread's span: a chunk of words scanned
SCAN = "fastsmc.scan"


@dataclasses.dataclass
class _Match:
    w0: int
    w1: int
    gaps: int = 0


def cm_between(w1: int, w2: int, genetic_positions: np.ndarray,
               word_size: int) -> float:
    """HASHING/Utils.cpp:22-34."""
    start = word_size * w1
    end = min(word_size * w2 + word_size - 1, len(genetic_positions) - 1)
    return 100.0 * (np.float32(genetic_positions[end])
                    - np.float32(genetic_positions[start]))


class HashingScan:
    """One streaming identification pass over a panel.

    The producer thread's scan time goes to ``spans`` as SCAN spans, whose
    parent is the span open where :meth:`run` was called."""

    def __init__(self, params: DecodingParams, data: Data,
                 callback: MatchCallback,
                 spans: Optional[SpanRecorder] = None):
        self.params = params
        self.data = data
        self.callback = callback
        self.windows = data.windows
        self.tot_pairs = 0
        self.spans = spans if spans is not None else SpanRecorder()

        # raw (pre-folding) alleles for this job's haps: folded ^ flipped
        raw = data.hap_bits ^ data.site_was_flipped[None, :].astype(np.uint8)

        # MAF filter on raw '1' counts over ALL haps (FastSMC.cpp:156-166).
        # The derived counts are pre-fold when fold didn't flip; reconstruct:
        dac_raw = np.where(data.site_was_flipped,
                           data.total_samples_count - data.derived_allele_counts,
                           data.derived_allele_counts)
        if params.min_maf > 0:
            maf = dac_raw / data.total_samples_count
            keep = ~((maf < params.min_maf) | (maf > 1 - params.min_maf))
            raw = raw[:, keep]
            self.site_index = np.flatnonzero(keep)
        else:
            self.site_index = None  # identity mapping

        ws = params.hashing_word_size
        n_sites = raw.shape[1]
        self.total_words = n_sites // ws
        self.word_size = ws
        # pack words as uint64 hashes: bit s of word w = site w*ws + s
        usable = raw[:, :self.total_words * ws]
        bits = usable.reshape(raw.shape[0], self.total_words, ws // 8, 8)
        b = np.packbits(bits, axis=-1, bitorder="little")
        self.words = b.reshape(raw.shape[0], self.total_words, 8) \
            .view(np.uint64).reshape(raw.shape[0], self.total_words)

        # idNum per hashing "individual" (FastSMC.cpp:95-103): global hap id
        # in haploid mode; duplicated 2*sample id in diploid mode
        n_ind = data.n_ind
        all_samples = np.flatnonzero(
            [self.windows.sample_in_job(d) for d in range(data.sample_size)]
        ) if self.windows is not None else np.arange(data.sample_size)
        ids = []
        for s in all_samples:
            if params.haploid:
                ids.extend([2 * s, 2 * s + 1])
            else:
                ids.extend([2 * s, 2 * s])
        self.id_num = np.asarray(ids, dtype=np.int64)
        self.num = len(ids)  # number of hashing units (haps)

        self._extend: Dict[int, _Match] = {}

    # -- ExtendHash (ExtendHash.hpp:52-116) -----------------------------
    def _pair_to_location(self, i: int, j: int) -> int:
        if not self.params.haploid:
            i = (i - (i % 2)) // 2
            j = (j - (j % 2)) // 2
        return j * self.num + i if i > j else i * self.num + j

    def _location_to_pair(self, loc: int) -> Tuple[int, int]:
        if self.params.haploid:
            second = loc % self.num
            first = (loc - second) // self.num
        else:
            second = 2 * (loc % self.num)
            first = 2 * ((loc - second // 2) // self.num)
        return first, second

    def _extend_pair(self, i: int, j: int, w: int, current_word: int) -> None:
        # ExtendHash.hpp:75-81: a new match starts at the CURRENT word (even
        # when discovered via sub-hash at w+1) and extends to w.
        loc = self._pair_to_location(i, j)
        m = self._extend.get(loc)
        if m is None:
            self._extend[loc] = _Match(w0=current_word, w1=max(w, 0))
        else:
            m.w1 = max(w, m.w1)

    def _print_match(self, loc: int, m: _Match) -> None:
        p1, p2 = self._location_to_pair(loc)
        gpos = self.data.genetic_positions
        if self.site_index is not None:
            # NOTE: reference quirk — cmBetween indexes the FULL position
            # array with word indices of the MAF-filtered stream
            # (FastSMC.cpp:129 passes mData.geneticPositions). Mirrored as-is.
            pass
        mlen = cm_between(m.w0, m.w1, gpos, self.word_size)
        if mlen >= self.params.min_m:
            frm = m.w0 * self.word_size
            to = m.w1 * self.word_size + self.word_size - 1
            self.callback(p1, p2, frm, to)

    def _clear_pairs_prior_to(self, w: int, current_word: int) -> None:
        dead = []
        for loc, m in self._extend.items():
            if m.w1 < w:
                self._print_match(loc, m)
                dead.append(loc)
            elif m.w1 < current_word:
                m.gaps += 1
        for loc in dead:
            del self._extend[loc]

    def _extend_all_pairs_to(self, w: int) -> None:
        for m in self._extend.values():
            m.w1 = w

    def _clear_all_pairs(self) -> None:
        for loc, m in self._extend.items():
            self._print_match(loc, m)
        self._extend.clear()

    # -- SeedHash (SeedHash.hpp:41-135) ---------------------------------
    def _extend_all_pairs(self, bucket_members: Dict[int, List[int]], w: int,
                          read_words: int, current_word: int) -> int:
        p = self.params
        wnd = self.windows
        tot = 0
        for members in bucket_members.values():
            if (p.max_seeds != 0 and len(members) > p.max_seeds
                    and w + 1 < read_words):
                # recursive sub-hash on the next word
                sub: Dict[int, List[int]] = {}
                for i in members:
                    h = int(self.words[i, w + 1])
                    sub.setdefault(h, []).append(i)
                tot += self._extend_all_pairs(sub, w + 1, read_words,
                                              current_word)
                continue
            n = len(members)
            for a in range(n):
                for b in range(a + 1, n):
                    ind_i = max(members[a], members[b])
                    ind_j = min(members[a], members[b])
                    if self._pair_in_window(ind_i, ind_j):
                        self._extend_pair(ind_j, ind_i, w, current_word)
                        tot += 1
        return tot

    def _pair_in_window(self, ind_i: int, ind_j: int) -> bool:
        """Triangular window filter (SeedHash.hpp:103-129)."""
        wnd = self.windows
        if wnd is None:
            return True
        id_i = int(self.id_num[ind_i])
        id_j = int(self.id_num[ind_j])
        ws, w_i, w_j = wnd.window_size, wnd.w_i, wnd.w_j
        if wnd.job_ind == wnd.jobs:
            if id_i >= (w_i - 1) * ws and id_j >= (w_j - 1) * ws:
                return id_j < (w_j - 1) * ws + (id_i - (w_i - 1) * ws)
            return False
        if ((w_i - 1) * ws <= id_i < w_i * ws
                and (w_j - 1) * ws <= id_j < w_j * ws):
            if wnd.is_j_above_diag:
                return id_j < (w_j - 1) * ws + (id_i - (w_i - 1) * ws)
            return id_j >= (w_j - 1) * ws + (id_i - (w_i - 1) * ws)
        return False

    @property
    def scan_thread_s(self) -> float:
        """The producer thread's scan seconds (host roofline accounting)."""
        return self.spans.total_s(SCAN)

    # -- main loop (FastSMC.cpp:144-235) --------------------------------
    def run(self, verbose: bool = False, use_native: bool = True,
            overlap: bool = True, chunk_words: int = 0) -> None:
        """``overlap=True`` (default, requires the native library and an
        ``array_callback``) runs the scan in word-range chunks on a
        producer thread — ctypes releases the GIL inside the C scan, so
        identification(chunk k+1) runs concurrently with the callback's
        validation work for chunk k. The reference gets this overlap for
        free across job processes (FastSMC.cpp:144-227 per job); here it
        hides the scan behind the device decode on one host. The chunked
        stream is identical (matches + order) to the single-shot scan, so
        batches and resume checkpoints are unchanged."""
        p = self.params
        arr_cb = getattr(self, "array_callback", None)
        kwargs = dict(
            haploid=p.haploid, windows=self.windows, min_m=p.min_m,
            genetic_positions=self.data.genetic_positions.astype(np.float32),
            word_size=self.word_size, read_ahead=p.const_read_ahead,
            gap=p.gap, max_seeds=p.max_seeds, skip=p.skip)
        if use_native and overlap and arr_cb is not None:
            if self._run_overlapped(arr_cb, chunk_words, kwargs):
                return
        if use_native:
            from .. import native
            res = native.hash_scan(self.words, self.id_num, **kwargs)
            if res is not None:
                id1, id2, frm, to = res
                if arr_cb is not None:
                    # bulk ingestion: one call for the whole candidate
                    # stream (a biobank chromosome has millions of
                    # candidates; per-candidate Python calls cost more
                    # than the device decode)
                    arr_cb(np.asarray(id1), np.asarray(id2),
                           np.asarray(frm), np.asarray(to))
                    return
                for a, b, f, t in zip(id1, id2, frm, to):
                    self.callback(int(a), int(b), int(f), int(t))
                return
        self._run_python(verbose)

    def _run_overlapped(self, arr_cb, chunk_words: int, kwargs) -> bool:
        """Producer-thread chunked native scan; False if unavailable."""
        from .. import native
        sc = native.NativeScan.create(self.words, self.id_num, **kwargs)
        if sc is None:
            return False
        import queue
        import threading
        tw = self.total_words
        cw = chunk_words or max(64, -(-tw // 32))
        q: "queue.Queue" = queue.Queue(maxsize=4)
        stop = threading.Event()

        def _put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.5)
                    return True
                except queue.Full:
                    continue
            return False

        parent = self.spans.current()

        def producer():
            try:
                for w0 in range(0, tw, cw):
                    with self.spans.span(SCAN, parent):
                        sc.scan_words(w0, min(w0 + cw, tw))
                        chunk = sc.take()
                    if len(chunk[0]) and not _put(chunk):
                        return
                with self.spans.span(SCAN, parent):
                    sc.finish()
                    chunk = sc.take()
                if len(chunk[0]):
                    if not _put(chunk):
                        return
                _put(None)
            except BaseException as e:          # surface in the consumer
                _put(e)

        th = threading.Thread(target=producer, name="fastsmc-scan",
                              daemon=True)
        th.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                arr_cb(*item)
        finally:
            stop.set()
            th.join()
            sc.destroy()
        return True

    def _run_python(self, verbose: bool = False) -> None:
        p = self.params
        n_haps = self.words.shape[0]
        for w in range(self.total_words):
            read_words = min(self.total_words, w + p.const_read_ahead)
            # seed: bucket by word hash
            buckets: Dict[int, List[int]] = {}
            col = self.words[:, w]
            for i in range(n_haps):
                buckets.setdefault(int(col[i]), []).append(i)

            cur_seeds = len(buckets)
            if cur_seeds / n_haps > p.skip:
                self.tot_pairs += self._extend_all_pairs(
                    buckets, w, read_words, w)
                self._clear_pairs_prior_to(w - p.gap, w)
            else:
                if verbose:
                    print(f"low complexity word - {cur_seeds} - skipping")
                self._extend_all_pairs_to(w)

        self._clear_all_pairs()
