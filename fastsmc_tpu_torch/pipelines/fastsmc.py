"""FastSMC pipeline on the GPU: hashing, batched validation, IBD output.

Counterpart of ``fastsmc_tpu/pipelines/fastsmc.py`` in array and sequence
mode, on the exact, fast and turbo profiles, with the reference's record
columns and entry options (the device hashing scan excepted). In
hashing mode the GERMLINE2 scan runs natively on a producer thread; each
candidate is bucketed into the smallest aligned power-of-two window holding
its 0.5 cM-padded match, and a full bucket is one batch (or, with
``bucket_sites=0``, batches form in arrival order, optionally sorted, over
their members' padded union). Without hashing every pair of the job's slice
of the flat pair enumeration is a candidate, decoded over the whole
chromosome in batches of ``batch_size``.

A flush group of batches is queued on the card without waiting for it:
per batch the two CUDA kernels, the window mask and run extraction against
capped buffers; then one stacked copy of the packed rows (and age rows) to
pinned host memory and one CUDA event a device. The host then drains the
previous group (waits on its events, unpacks, writes) while this one runs.
A batch whose runs overflow a cap is redone at grown caps, with the same
bytes a large enough cap would have given. With a mesh
(``parallel.sharding``) each batch is split over its shards, which extract
their own runs; the per-shard rows are merged at the drain, and any shard
over a cap redoes the batch. Record order equals the JAX package's.
"""

from __future__ import annotations

import os
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import DecodingParams
from ..engine import segments as seg
from ..engine.hmm import bucket_len
from ..engine.kernels import GpuDecoder, resolve_device, stage
from ..engine.oracle import DecodeContext
from ..hashing.germline import HashingScan
from ..io import writers
from ..io.decoding_quantities import DecodingQuantities
from ..io.haps import Data, load_data
from ..parallel.sharding import ShardedDecoder, on_device
from ..utils.timer import PhaseTimer
from .asmc import job_pair_range, pairs_from_flat_indices

# batches a flush group holds when the caller gives no flush_group
DEFAULT_FLUSH_GROUP = 8
# drains between two checkpoints (the .progress sidecar)
CHECKPOINT_DRAINS = 16


# The four pad helpers are copies of fastsmc_tpu/pipelines/fastsmc.py:35-81.

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
    """End-to-end FastSMC run for one job on one CUDA device or a mesh of
    devices, with or without hashing."""

    def __init__(self, params: DecodingParams,
                 data: Optional[Data] = None,
                 dq: Optional[DecodingQuantities] = None,
                 device=None,
                 hashing_backend: str = "host",
                 decode_profile: str = "exact",
                 mesh=None,
                 sort_batches: int = 0,
                 flush_group: int = 0,
                 bucket_sites: Optional[int] = None):
        """Arguments as the JAX package's ``FastSMC``: ``decode_profile``
        is "exact", "fast" or "turbo"; ``sort_batches`` buffers that many
        arrival-order batches and sorts them by region, length class and
        start; ``bucket_sites`` floors the canonical window (None: 64, or
        0 with ``sort_batches > 1``; 0: arrival-order batches over their
        members' padded union); ``flush_group`` is the number of batches
        queued before the previous group is drained (0: 8). ``device`` is
        where the tables live and the kernels run: "cuda" (the default;
        raises without CUDA) or "cpu" (the plain versions, for tests).
        ``mesh`` (``parallel.sharding.make_mesh``) shards every batch over
        its devices, which then rule: ``batch_size`` must be a multiple of
        its size, and a ``device`` that names another device raises
        ``ValueError``. ``hashing_backend="device"`` raises
        ``NotImplementedError``."""
        if hashing_backend == "device":
            raise NotImplementedError(
                "hashing_backend='device' (the sort-based scan of "
                "fastsmc_tpu/hashing/vectorized.py) is not ported by design: "
                "the native GERMLINE2 scan, hashing_backend='host', is the "
                "production design")
        if hashing_backend != "host":
            raise ValueError(f"unknown hashing backend {hashing_backend!r}")
        if mesh is not None:
            if device is not None:
                mesh.check_device(device)
            if params.batch_size % mesh.size:
                raise ValueError(f"batch_size {params.batch_size} must be a "
                                 f"multiple of the mesh size {mesh.size}")
        else:
            device = resolve_device("cuda" if device is None else device)
        if bucket_sites is None:
            bucket_sites = 0 if sort_batches > 1 else 64
        if bucket_sites and sort_batches > 1:
            raise ValueError("bucket_sites and sort_batches are mutually "
                             "exclusive candidate orderings")
        params.fastsmc = True
        self.params = params
        self.data = data if data is not None else load_data(params)
        self.dq = dq if dq is not None else DecodingQuantities.load(
            params.decoding_quant_file)
        self.ctx = DecodeContext.build(params, self.data, self.dq)
        if mesh is None:
            self.decoder = GpuDecoder(self.ctx, device, decode_profile)
            self._devices = [device]
            self._shards = 1
        else:
            self.decoder = ShardedDecoder(self.ctx, mesh, decode_profile)
            self._devices = list(dict.fromkeys(mesh.devices))
            self._shards = self.decoder.n_extract_shards

        K = self.dq.states
        self.state_threshold = seg.state_threshold(
            self.dq.discretization, params.time, K)
        self.prob_threshold = seg.probability_threshold(
            self.dq.initial_state_prob, self.state_threshold)
        self.age_threshold = K if params.no_conditional_age_estimates \
            else self.state_threshold
        self.need_ages = (params.do_per_pair_posterior_mean
                          or params.do_per_pair_map)

        self._writer = None
        self.timer = PhaseTimer()
        bs = params.batch_size
        self._bh1 = np.zeros(bs, dtype=np.int32)
        self._bh2 = np.zeros(bs, dtype=np.int32)
        self._from = np.zeros(bs, dtype=np.int64)
        self._to = np.full(bs, self.data.sites, dtype=np.int64)
        self._bn = 0
        self._cpt = 0
        self.n_segments = 0
        # resume replays the candidate stream and skips flushed batches
        self._batch_idx = 0
        self._resume_skip = 0
        self._drains_since_ckpt = 0
        self._scan_thread_s = 0.0
        # extraction caps (fastsmc.py:205-235), grown sticky on overflow:
        # the raw boundary pass, the kept runs, the per-run age rows. With
        # ages an overflow re-decodes the batch, so the raw cap starts at
        # the batch width
        self._seg_cap = bucket_len(max(4096, bs), 256) if self.need_ages \
            else 4096
        self._kept_cap = 4096
        self._pps_cap = 8192
        self.flush_group = flush_group or DEFAULT_FLUSH_GROUP
        self._group: List[dict] = []
        self._gpending: Optional[dict] = None
        # decode memory guard of the JAX package (fastsmc.py:232-247),
        # kept as it is: where it splits a batch decides the order of the
        # records; a bf16 alpha (fast/turbo) takes twice the elements. The
        # floor keeps 256 pairs a shard
        self._pad_floor = 256 * self._shards
        self._post_budget = 8 << 20
        self._alpha_budget = (32 << 20) \
            if self.decoder.alpha_dtype.itemsize == 2 else (16 << 20)
        self._gp32 = np.float32(self.data.genetic_positions)
        self.sort_batches = sort_batches
        self._sort_buf: List[Tuple[np.ndarray, ...]] = []
        self._sort_n = 0
        self.bucket_sites = bucket_sites
        self._buckets: dict = {}        # region -> list of column tuples
        self._bucket_n: dict = {}       # region -> buffered count
        # window waste, and the host terms of roofline()
        self.stats = {"decoded_site_pairs": 0, "union_site_pairs": 0,
                      "cand_site_pairs": 0, "flushes": 0,
                      "overflow_redos": 0, "d2h_bytes": 0,
                      "drain_wait_s": 0.0, "drain_host_s": 0.0,
                      "batcher_s": 0.0, "ckpt_s": 0.0}

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
            self._writer = writers.IbdTextWriter(
                path, self.data.fam_id_list, self.data.iid_list,
                self.data.chr_number, append=append)
        return path

    # ------------------------------------------------------------------
    # candidate intake (fastsmc.py:292-465)
    # ------------------------------------------------------------------
    def _on_match(self, id1: int, id2: int, from_pos: int, to_pos: int):
        self._on_matches_array(
            np.asarray([id1], np.int32), np.asarray([id2], np.int32),
            np.asarray([from_pos], np.int64), np.asarray([to_pos], np.int64))

    def _on_matches_array(self, id1, id2, from_pos, to_pos):
        self._cpt += len(id1)
        if self.bucket_sites:
            self._bucket_push(np.asarray(id1, np.int32),
                              np.asarray(id2, np.int32),
                              np.asarray(from_pos, np.int64),
                              np.asarray(to_pos, np.int64))
            return
        if self.sort_batches > 1:
            self._sort_buf.append((np.asarray(from_pos, np.int64),
                                   np.asarray(to_pos, np.int64),
                                   np.asarray(id1, np.int32),
                                   np.asarray(id2, np.int32)))
            self._sort_n += len(id1)
            if self._sort_n >= self.sort_batches * self.params.batch_size:
                self._drain_sort_buf(final=False)
            return
        self._push_arrays(id1, id2, from_pos, to_pos)

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
        arrival order or batch composition. ``batcher_s`` times the
        bookkeeping, not the flushes."""
        bs = self.params.batch_size
        t0 = time.perf_counter()
        t_flush = 0.0
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
                tf = time.perf_counter()
                self._flush_bucket([c[:bs] for c in cols], k)
                t_flush += time.perf_counter() - tf
                self._buckets[k] = [tuple(c[bs:] for c in cols)]
                n -= bs
            self._bucket_n[k] = n
        self.stats["batcher_s"] += time.perf_counter() - t0 - t_flush

    def _flush_bucket(self, cols, key: int):
        """Flush one canonical-window batch: decode bounds come from the
        bucket key, not from the members' min/max."""
        k = key >> 48
        o = key & ((1 << 48) - 1)
        self._flush_entry(cols[0].astype(np.int32), cols[1].astype(np.int32),
                          cols[2], cols[3], self.params.batch_size,
                          bounds=(int(o),
                                  int(min(o + (1 << k), self.data.sites))))

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

    def _push_arrays(self, id1, id2, from_pos, to_pos):
        """Arrival-order batches of batch_size candidates."""
        bs = self.params.batch_size
        i, n = 0, len(id1)
        while i < n:
            take = min(bs - self._bn, n - i)
            sl = slice(self._bn, self._bn + take)
            self._bh1[sl] = id1[i:i + take]
            self._bh2[sl] = id2[i:i + take]
            self._from[sl] = from_pos[i:i + take]
            self._to[sl] = to_pos[i:i + take]
            self._bn += take
            i += take
            if self._bn == bs:
                self._flush(self._bn)

    def _drain_sort_buf(self, final: bool):
        """Sort the buffered candidates by genomic region (from // 512),
        window-length class and start, and push full batches; keep a
        partial batch buffered unless ``final`` (fastsmc.py:425-455; the
        stable order keeps the stream deterministic for resume)."""
        frm = np.concatenate([c[0] for c in self._sort_buf])
        to = np.concatenate([c[1] for c in self._sort_buf])
        id1 = np.concatenate([c[2] for c in self._sort_buf])
        id2 = np.concatenate([c[3] for c in self._sort_buf])
        wl = np.maximum(to - frm, 1)
        cls = np.frexp(wl.astype(np.float64))[1]   # ceil log2 length class
        order = np.lexsort((to, frm, cls, frm // 512))
        bs = self.params.batch_size
        keep = 0 if final else len(order) % bs
        emit = order[:len(order) - keep] if keep else order
        rest = order[len(order) - keep:] if keep else order[:0]
        self._sort_buf = [(frm[rest], to[rest], id1[rest], id2[rest])] \
            if keep else []
        self._sort_n = keep
        self._push_arrays(id1[emit], id2[emit], frm[emit], to[emit])

    def _flush(self, n: int):
        if n == 0:
            return
        h1 = self._bh1[:n].copy()
        h2 = self._bh2[:n].copy()
        fr = self._from[:n].copy()
        to = self._to[:n].copy()
        self._bn = 0
        self._flush_entry(h1, h2, fr, to, self.params.batch_size)

    # ------------------------------------------------------------------
    def _flush_entry(self, h1, h2, fr, to, pad_to: int, bounds=None):
        """One batch (fastsmc.py:467-563): decode bounds from ``bounds``
        (a canonical window) or the members' padded union; pad shrink and
        pair split under the memory guard; on resume, skip the batches the
        checkpoint names; scan windows; then queue it for the group."""
        n = len(h1)
        p = self.params
        g = self.data.genetic_positions
        start_batch = int(fr.min())
        end_batch = int(to.max())
        if bounds is not None:
            frm, t2 = bounds
        else:
            frm = get_from_position(g, start_batch)
            t2 = get_to_position(g, end_batch)
        t_len = bucket_len(t2 - frm)

        while pad_to > max(self._pad_floor, 1024) and n <= pad_to // 2:
            pad_to //= 2
        budget = self._post_budget if self.need_ages else self._alpha_budget
        if pad_to > self._pad_floor and n > 1 and t_len * pad_to > budget:
            k = (n + 1) // 2
            self._flush_entry(h1[:k], h2[:k], fr[:k], to[:k], pad_to // 2,
                              bounds)
            self._flush_entry(h1[k:], h2[k:], fr[k:], to[k:], pad_to // 2,
                              bounds)
            return

        if self._batch_idx < self._resume_skip:
            self._batch_idx += 1
            return
        self._batch_idx += 1

        # scan windows: the batch union (permissive) or each candidate's
        # own padded window (the default, config.permissive_window)
        if p.permissive_window:
            w0r = w1r = None
            s0r, s1r = start_batch - frm, end_batch - frm
        else:
            w0r = np.clip(pad_from_positions(g, fr) - frm, 0, t_len
                          ).astype(np.int32)
            w1r = np.clip(pad_to_positions(g, to) - frm, 0, t_len
                          ).astype(np.int32)
            s0r, s1r = 0, t2 - frm
        if n < pad_to:
            # pad to a fixed batch width with copies of the last candidate;
            # their runs are dropped at emit time
            fill = pad_to - n
            h1 = np.concatenate([h1, np.full(fill, h1[-1], np.int32)])
            h2 = np.concatenate([h2, np.full(fill, h2[-1], np.int32)])
            if w0r is not None:
                w0r = np.concatenate([w0r, np.full(fill, w0r[-1], np.int32)])
                w1r = np.concatenate([w1r, np.full(fill, w1r[-1], np.int32)])

        self.stats["flushes"] += 1
        self.stats["union_site_pairs"] += (end_batch - start_batch) * n
        self.stats["cand_site_pairs"] += int((to - fr).sum())
        self._queue_entry(dict(hap1=h1, hap2=h2, n=n, frm=frm, t_len=t_len,
                               s0=s0r, s1=s1r, w0=w0r, w1=w1r, P=pad_to))

    def _queue_entry(self, e: dict):
        e["idx"] = self._batch_idx
        self._group.append(e)
        if len(self._group) >= self.flush_group:
            self._dispatch_group()

    # ------------------------------------------------------------------
    # grouped dispatch and drain (fastsmc.py:569-803)
    # ------------------------------------------------------------------
    def _dispatch_group(self):
        """Queue the group on the card, then drain the previous one while
        it runs."""
        if not self._group:
            return
        entries, self._group = self._group, []
        self.stats["decoded_site_pairs"] += \
            sum(e["t_len"] * e["P"] for e in entries)
        with self.timer.phase("decode"):
            pending = self._queue_group(entries)
        self._drain_group()
        self._gpending = pending

    def _stage(self, x):
        """Host array ``x`` on the decoder's device(s), with its pinned
        source(s) (``kernels.stage``; per shard with a mesh)."""
        if isinstance(self.decoder, ShardedDecoder):
            return self.decoder.stage(x)
        return stage(x, self._devices[0])

    def _queue_group(self, entries: List[dict]) -> dict:
        """Every entry's decode and capped extraction, the stacked packed
        (and age) rows copied to pinned host buffers, and one event a device
        after them; nothing here waits for a card. The pair and window
        arrays go up through pinned tensors, which the entries keep until
        the drain."""
        kcap = min(self._kept_cap, self._seg_cap)
        packs, ages = [], []
        for e in entries:
            e["dev"] = [(None, None) if e[k] is None else self._stage(e[k])
                        for k in ("hap1", "hap2", "w0", "w1")]
            packed, ages_rows, th = self._decode(e, self._seg_cap, kcap)
            # without ages a redo re-extracts from the threshold sums
            e["th"] = None if self.need_ages else th
            packs.append(packed)
            ages.append(ages_rows)
        res = dict(entries=entries, caps=(self._seg_cap, kcap),
                   packed=_to_host(seg.stack_rows(packs)),
                   ages=_to_host(seg.stack_rows(ages))
                   if self.need_ages else None, events=[])
        for dev in self._devices:
            if dev.type == "cuda":
                with on_device(dev):
                    res["events"].append(torch.cuda.Event())
                    res["events"][-1].record()
        return res

    def _decode(self, e: dict, cap: int, kcap: int):
        ha, hb, w0, w1 = (x for x, _ in e["dev"])
        return self.decoder.decode_extract_packed(
            ha, hb, e["frm"], e["t_len"], self.state_threshold, e["s0"],
            e["s1"], self.prob_threshold, cap, self._pps_cap,
            self.age_threshold, need_ages=self.need_ages, w0=w0, w1=w1,
            kcap=kcap)

    @staticmethod
    def _unpack_entry(packed_i: np.ndarray, e: dict):
        """(start, b, score) of one entry's packed row, flat or per shard
        ([S, 3*kcap+2], merged), sliced to its kept runs, and the kept and
        raw counts of each row (fastsmc.py:625-639)."""
        if packed_i.ndim == 2:
            return seg.merge_packed_shards(packed_i, e["t_len"],
                                           e["P"] // packed_i.shape[0])
        kcap = (len(packed_i) - 2) // 3
        start, b, score, nk, nr = seg.unpack_extract_rows(packed_i, kcap)
        k = min(nk, kcap)
        return start[:k], b[:k], score[:k], [nk], [nr]

    @staticmethod
    def _merge_entry_ages(ages_i: np.ndarray, ns_kept) -> np.ndarray:
        """[2, n_kept] age rows aligned with the kept runs, from a flat
        [2, capp] or per-shard [S, 2, capp] row (fastsmc.py:641-651)."""
        capp = ages_i.shape[-1]
        if ages_i.ndim == 3:
            return np.concatenate([a[:, :min(n, capp)]
                                   for a, n in zip(ages_i, ns_kept)], axis=1)
        return ages_i[:, :min(ns_kept[0], capp)]

    def _grow_caps(self, n_raw: int, n_kept: int):
        while self._seg_cap < n_raw:
            self._seg_cap *= 2
        while self._kept_cap < n_kept:
            self._kept_cap *= 2
        while self.need_ages and self._pps_cap < n_kept:
            self._pps_cap *= 2
        # the raw pass bounds what can be kept
        self._seg_cap = max(self._seg_cap, self._kept_cap)

    def _drain_group(self):
        """Wait for the pending group's event, unpack its rows, redo the
        entries that overflowed a cap, write its records, and checkpoint
        every CHECKPOINT_DRAINS drains."""
        if self._gpending is None:
            return
        res, self._gpending = self._gpending, None
        entries = res["entries"]
        st = self.stats
        with self.timer.phase("segments"):
            t0 = time.perf_counter()
            wait0 = st["drain_wait_s"]
            for event in res["events"]:
                event.synchronize()
            st["drain_wait_s"] += time.perf_counter() - t0
            packed = res["packed"].numpy()
            ages = None if res["ages"] is None else res["ages"].numpy()
            st["d2h_bytes"] += packed.nbytes + (0 if ages is None
                                                else ages.nbytes)
            raw_cap, kcap = res["caps"]
            out = []
            for i, e in enumerate(entries):
                start, b, score, ns_kept, ns_raw = self._unpack_entry(
                    packed[i], e)
                nk, nr = max(ns_kept), max(ns_raw)
                if nr > raw_cap or nk > kcap \
                        or (ages is not None and nk > ages.shape[-1]):
                    st["overflow_redos"] += 1
                    self._grow_caps(nr, nk)
                    out.append(self._redo_entry(e))
                    continue
                out.append((seg.runs_from_packed(start, b, score,
                                                 e["t_len"]),
                            None if ages is None
                            else self._merge_entry_ages(ages[i], ns_kept)))
            st["drain_host_s"] += (time.perf_counter() - t0
                                   - (st["drain_wait_s"] - wait0))
        with self.timer.phase("outputPerPair"):
            for e, (runs, ages_e) in zip(entries, out):
                self._emit_runs(e, *runs, ages=ages_e)
        # the checkpoint names only batches whose records reached the
        # writer; run() closes the output without one
        self._drains_since_ckpt += 1
        if self._drains_since_ckpt >= CHECKPOINT_DRAINS:
            self._drains_since_ckpt = 0
            self._write_progress(entries[-1]["idx"])

    def _redo_entry(self, e: dict):
        """The entry again at the grown caps, through the same path as a
        normal batch (fastsmc.py:743-803): with ages a new decode (the
        posterior was a temporary), without ages a new extraction from the
        saved threshold sums; repeated until nothing overflows. Returns
        ((pair, a, b, score), ages or None) as the drain does, so the
        bytes equal those of a large enough first cap."""
        st = self.stats
        while True:
            raw_cap = self._seg_cap
            kcap = min(self._kept_cap, raw_cap)
            if self.need_ages:
                packed_d, ages_d, _ = self._decode(e, raw_cap, kcap)
            else:
                # one flat row from the whole batch's threshold sums, also
                # with a mesh: the same runs in the same order
                th = e["th"] if e["w0"] is None \
                    else seg.mask_window(e["th"], e["w0"], e["w1"])
                packed_d, _ = seg.extract_packed(
                    th, e["s0"], e["s1"], self.prob_threshold, raw_cap,
                    kcap=kcap)
                ages_d = None
            t_w = time.perf_counter()
            packed = packed_d.cpu().numpy()
            ages = None if ages_d is None else ages_d.cpu().numpy()
            st["drain_wait_s"] += time.perf_counter() - t_w
            st["d2h_bytes"] += packed.nbytes + (0 if ages is None
                                                else ages.nbytes)
            start, b, score, ns_kept, ns_raw = self._unpack_entry(packed, e)
            nk, nr = max(ns_kept), max(ns_raw)
            if nr <= raw_cap and nk <= kcap \
                    and (ages is None or nk <= ages.shape[-1]):
                break
            self._grow_caps(nr, nk)
        return (seg.runs_from_packed(start, b, score, e["t_len"]),
                None if ages is None
                else self._merge_entry_ages(ages, ns_kept))

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
        segments, byte offset), and reopen in append mode, carrying the
        writer's counters; the time goes to ``ckpt_s``."""
        t0 = time.perf_counter()
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
        self.stats["ckpt_s"] += time.perf_counter() - t0

    def roofline(self) -> dict:
        """Host terms of a finished run (fastsmc.py:980-996): megabytes
        copied from the card, the drain's wait on the card and its own host
        time, the batcher's and the checkpoints' host time, the writer's
        format and deflate time and the scan thread's time, in seconds."""
        st = self.stats
        w = self._writer
        return {
            "d2h_mb": st["d2h_bytes"] / 1e6,
            "drain_wait_s": st["drain_wait_s"],
            "drain_host_s": st["drain_host_s"],
            "batcher_s": st["batcher_s"],
            "ckpt_s": st["ckpt_s"],
            "writer_fmt_s": getattr(w, "fmt_s", 0.0),
            "writer_deflate_s": getattr(w, "deflate_s", 0.0),
            "scan_thread_s": self._scan_thread_s,
        }

    # ------------------------------------------------------------------
    def _run_no_hashing(self):
        """Every pair of the job's slice of the flat pair enumeration
        (HMM.cpp:310-364), decoded over the whole chromosome in batches of
        ``batch_size`` through the same groups (fastsmc.py:1001-1042); the
        pairs come from the closed-form flat-index inversion, one batch at
        a time. With a mesh a short last batch is padded to a multiple of
        its size with copies of its last pair, whose runs are dropped."""
        p = self.params
        L = self.data.sites
        start, end = job_pair_range(self.data.n_ind, p)
        for ofs in range(start, end, p.batch_size):
            n = min(ofs + p.batch_size, end) - ofs
            self._cpt += n
            self.stats["cand_site_pairs"] += L * n
            if self._batch_idx < self._resume_skip:
                self._batch_idx += 1
                continue
            self._batch_idx += 1
            h1, h2 = pairs_from_flat_indices(np.arange(ofs, ofs + n),
                                             p.within_only)
            fill = -n % self._shards
            h1, h2 = (np.concatenate([h.astype(np.int32),
                                      np.full(fill, h[-1], np.int32)])
                      for h in (h1, h2))
            self._queue_entry(dict(
                hap1=h1, hap2=h2, n=n, frm=0, t_len=bucket_len(L), s0=0,
                s1=L, w0=None, w1=None, P=n + fill))

    # ------------------------------------------------------------------
    def run(self, verbose: bool = True, resume: bool = False) -> str:
        """Full pipeline (fastsmc.py:1045-1110); returns the output path.
        With ``resume=True`` a run killed after a checkpoint continues:
        the output is cut back to the ``.progress`` sidecar's offset, the
        deterministic candidate stream is replayed and the batches the
        sidecar names are skipped."""
        t0 = time.time()
        self.timer = PhaseTimer()
        out = self.params.ibd_output_path()
        progress = out + ".progress"
        append = False
        if resume and os.path.exists(progress) and os.path.exists(out):
            with open(progress) as fh:
                done, nseg, offset = fh.read().split()
            self._resume_skip = int(done)
            self.n_segments = int(nseg)
            # drop any partial gzip member written after the checkpoint
            with open(out, "ab") as fh:
                fh.truncate(int(offset))
            append = True
        path = self._open_writer(append=append)
        if self.params.hashing:
            with self.timer.phase("identification"):
                scan = HashingScan(self.params, self.data, self._on_match)
                scan.array_callback = self._on_matches_array
                scan.run(verbose=verbose)
            self._scan_thread_s = scan.scan_thread_s
            if self.bucket_sites:
                self._drain_buckets()
            if self._sort_buf:
                self._drain_sort_buf(final=True)
            self._flush(self._bn)
        else:
            self._run_no_hashing()
        self._dispatch_group()
        self._drain_group()
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
                      f"{st['flushes']} flushes, {st['overflow_redos']} "
                      f"overflow redos)")
            self.timer.report()
        return path


def _to_host(x: torch.Tensor) -> torch.Tensor:
    """``x`` on the host: for a CUDA tensor a pinned buffer with the copy
    queued (read it after an event recorded later has fired); a CPU tensor
    as it is."""
    if x.device.type != "cuda":
        return x
    h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    h.copy_(x, non_blocking=True)
    return h
