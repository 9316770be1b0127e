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

A flush group of batches is queued on the card batch by batch. Per batch
the two CUDA kernels, the window mask and the count of its runs
(``segments.count_runs``), whose two numbers are copied to pinned host
memory behind an event; then the run extraction at caps sized from those
counts, so no batch overflows and none is decoded twice (the JAX package
redoes a batch that overflows its caps, with the same bytes). The card
never waits for the host's read of a count: batch i+1's forward is
queued before the host waits for batch i's count, and batch i's
extraction, which frees its posterior, before batch i+1's backward, so at
most one alpha and one posterior are alive. At the group's first wait on
a count the host drains the previous group (waits on its events, unpacks,
writes) while the card decodes. The group's packed rows (and age rows)
go to pinned host memory in one copy, behind one CUDA event a device.
With a mesh (``parallel.sharding``) each batch is split over its shards,
which count and extract their own runs at the caps of the largest shard's
counts; the per-shard rows are merged at the drain. Record order equals
the JAX package's.

Every stage records a span in ``FastSMC.timer`` (``utils.timer``), all
under ``fastsmc.run``: ``fastsmc.intake`` (candidate or pair bookkeeping),
``fastsmc.dispatch`` (a group queued, in pieces, two a batch and one
more; in them each batch's ``fastsmc.decode.prologue``,
``.forward``, ``.backward``, its two ``fastsmc.extract`` phases and
``fastsmc.dispatch.count_wait``, the host's wait for a count),
``fastsmc.drain`` (with ``fastsmc.drain.wait`` on the card),
``fastsmc.emit`` (a batch's records to
the writer, whose thread records ``fastsmc.writer.format`` and
``.deflate`` with that emit as parent), ``fastsmc.checkpoint`` and the
final ``fastsmc.writer.close``; the constructor records ``fastsmc.init``,
the hashing scan's thread ``fastsmc.scan``. Under a running profiler they
are ``record_function`` ranges of the trace too. ``roofline()``'s host
seconds are read from them.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import DecodingParams
from ..engine import segments as seg
from ..engine.hmm import bucket_len
from ..engine.kernels import GpuDecoder, resolve_device, stage, to_host
from ..engine.oracle import DecodeContext
from ..hashing.germline import SCAN, HashingScan
from ..io import writers
from ..io.decoding_quantities import DecodingQuantities
from ..io.haps import Data, load_data
from ..parallel.sharding import ShardedDecoder, on_device
from ..utils.timer import SpanRecorder
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
        self.timer = SpanRecorder(root="fastsmc.run")
        with self.timer.span("fastsmc.init"):
            self.data = data if data is not None else load_data(params)
            self.dq = dq if dq is not None else DecodingQuantities.load(
                params.decoding_quant_file)
            self.ctx = DecodeContext.build(params, self.data, self.dq)
            if mesh is None:
                self.decoder = GpuDecoder(self.ctx, device, decode_profile,
                                          self.timer)
                self._devices = [device]
                self._shards = 1
            else:
                self.decoder = ShardedDecoder(self.ctx, mesh, decode_profile,
                                              self.timer)
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
        # window waste, the bytes copied from the card, and redos (none:
        # the caps are sized from each batch's counts)
        self.stats = {"decoded_site_pairs": 0, "union_site_pairs": 0,
                      "cand_site_pairs": 0, "flushes": 0,
                      "overflow_redos": 0, "d2h_bytes": 0}

    # ------------------------------------------------------------------
    def _open_writer(self, append: bool = False):
        p = self.params
        path = p.ibd_output_path()
        if p.bin_out:
            self._writer = writers.IbdBinaryWriter(
                path, self.data.fam_id_list, self.data.iid_list,
                self.data.chr_number, p.output_ibd_segment_length,
                p.do_per_pair_posterior_mean, p.do_per_pair_map,
                append=append, spans=self.timer)
        else:
            self._writer = writers.IbdTextWriter(
                path, self.data.fam_id_list, self.data.iid_list,
                self.data.chr_number, append=append, spans=self.timer)
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
        batch_size candidates flushes, in the order the buckets fill, once
        the chunk is bucketed. A candidate's output then depends only on
        (pair, canonical window), never on batch size, arrival order or
        batch composition. The ``fastsmc.intake`` span times the
        bookkeeping, not the flushes."""
        bs = self.params.batch_size
        full = []
        with self.timer.span("fastsmc.intake"):
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
                    cols = [np.concatenate([c_[j]
                                            for c_ in self._buckets[k]])
                            for j in range(4)]
                    full.append(([c[:bs] for c in cols], k))
                    self._buckets[k] = [tuple(c[bs:] for c in cols)]
                    n -= bs
                self._bucket_n[k] = n
        for cols, k in full:
            self._flush_bucket(cols, k)

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
        with self.timer.span("fastsmc.intake"):
            tails = [([np.concatenate([c_[j] for c_ in self._buckets[key]])
                       for j in range(4)], key)
                     for key in sorted(self._buckets)]
            self._buckets.clear()
            self._bucket_n.clear()
        for cols, key in tails:
            if len(cols[0]):
                self._flush_bucket(cols, key)

    def _push_arrays(self, id1, id2, from_pos, to_pos):
        """Arrival-order batches of batch_size candidates; the full ones
        flush once the chunk is buffered."""
        bs = self.params.batch_size
        full = []
        with self.timer.span("fastsmc.intake"):
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
                    full.append(self._take(bs))
        for cols in full:
            self._flush_entry(*cols, bs)

    def _drain_sort_buf(self, final: bool):
        """Sort the buffered candidates by genomic region (from // 512),
        window-length class and start, and push full batches; keep a
        partial batch buffered unless ``final`` (fastsmc.py:425-455; the
        stable order keeps the stream deterministic for resume)."""
        with self.timer.span("fastsmc.intake"):
            frm = np.concatenate([c[0] for c in self._sort_buf])
            to = np.concatenate([c[1] for c in self._sort_buf])
            id1 = np.concatenate([c[2] for c in self._sort_buf])
            id2 = np.concatenate([c[3] for c in self._sort_buf])
            wl = np.maximum(to - frm, 1)
            cls = np.frexp(wl.astype(np.float64))[1]   # ceil log2 class
            order = np.lexsort((to, frm, cls, frm // 512))
            bs = self.params.batch_size
            keep = 0 if final else len(order) % bs
            emit = order[:len(order) - keep] if keep else order
            rest = order[len(order) - keep:] if keep else order[:0]
            self._sort_buf = [(frm[rest], to[rest], id1[rest], id2[rest])] \
                if keep else []
            self._sort_n = keep
        self._push_arrays(id1[emit], id2[emit], frm[emit], to[emit])

    def _take(self, n: int):
        """Copies of the first ``n`` buffered candidates' columns; the
        buffer is then empty."""
        self._bn = 0
        return (self._bh1[:n].copy(), self._bh2[:n].copy(),
                self._from[:n].copy(), self._to[:n].copy())

    def _flush(self, n: int):
        if n:
            self._flush_entry(*self._take(n), self.params.batch_size)

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
        """Queue the group on the card, draining the previous one at the
        group's first wait on a count."""
        if not self._group:
            return
        entries, self._group = self._group, []
        self.stats["decoded_site_pairs"] += \
            sum(e["t_len"] * e["P"] for e in entries)
        self._gpending = self._queue_group(entries)

    def _stage(self, x):
        """Host array ``x`` on the decoder's device(s), with its pinned
        source(s) (``kernels.stage``; per shard with a mesh)."""
        if isinstance(self.decoder, ShardedDecoder):
            return self.decoder.stage(x)
        return stage(x, self._devices[0])

    def _queue_group(self, entries: List[dict]) -> dict:
        """Every entry's decode, count and sized extraction, in the order
        the module docstring gives, with the previous group's drain before
        the first wait on a count; then the group's packed (and age) rows
        copied to pinned host buffers, and one event a device after them.
        The host waits only for the counts' events and, in the drain, for
        the previous group's. The pair and window arrays go up through
        pinned tensors, which the entries keep until the drain."""
        dec = self.decoder
        # counted: the batch not extracted yet, popped so that nothing
        # holds its posterior once its extraction is queued
        rows, counted = [], []
        for e in entries:
            with self.timer.span("fastsmc.dispatch"):
                e["dev"] = [(None, None) if e[k] is None
                            else self._stage(e[k])
                            for k in ("hap1", "hap2", "w0", "w1")]
                ha, hb, w0, w1 = (x for x, _ in e["dev"])
                fwd = dec.forward_pass(ha, hb, e["frm"], e["t_len"])
            if counted and not rows:
                self._drain_group()
            with self.timer.span("fastsmc.dispatch"):
                if counted:
                    rows.append(self._extract(counted.pop()))
                counted.append(dec.count_pass(
                    fwd, self.state_threshold, e["s0"], e["s1"],
                    self.prob_threshold, self.age_threshold, self.need_ages,
                    w0, w1))
                del fwd                  # alpha, once the backward has read it
        if not rows:
            self._drain_group()
        with self.timer.span("fastsmc.dispatch"):
            rows.append(self._extract(counted.pop()))
            packs, ages = zip(*rows)
            res = dict(entries=entries, packed=_flat_to_host(packs),
                       ages=_flat_to_host(ages) if self.need_ages else None,
                       events=[])
            for dev in self._devices:
                if dev.type == "cuda":
                    with on_device(dev):
                        res["events"].append(torch.cuda.Event())
                        res["events"][-1].record()
        return res

    def _extract(self, counted):
        """A counted batch's extraction at the caps its counts size, once
        the host has read them."""
        with self.timer.span("fastsmc.dispatch.count_wait"):
            counts = self.decoder.read_counts(counted)
        self.stats["d2h_bytes"] += 8 * len(counts)
        cap, kcap = seg.sized_caps(counts)
        return self.decoder.extract_counted(counted, cap, kcap,
                                            self.age_threshold)

    @staticmethod
    def _unpack_entry(packed_i: np.ndarray, e: dict):
        """(start, b, score) of one entry's packed row, flat or per shard
        ([S, 3*kcap+2], merged), sliced to its kept runs, and the kept
        counts of each row (fastsmc.py:625-639)."""
        if packed_i.ndim == 2:
            start, b, score, ns_kept, _ = seg.merge_packed_shards(
                packed_i, e["t_len"], e["P"] // packed_i.shape[0])
            return start, b, score, ns_kept
        kcap = (len(packed_i) - 2) // 3
        start, b, score, nk, _ = seg.unpack_extract_rows(packed_i, kcap)
        return start[:nk], b[:nk], score[:nk], [nk]

    @staticmethod
    def _merge_entry_ages(ages_i: np.ndarray, ns_kept) -> np.ndarray:
        """[2, n_kept] age rows aligned with the kept runs, from a flat
        [2, kcap] or per-shard [S, 2, kcap] row (fastsmc.py:641-651)."""
        if ages_i.ndim == 3:
            return np.concatenate([a[:, :n] for a, n in zip(ages_i, ns_kept)],
                                  axis=1)
        return ages_i[:, :ns_kept[0]]

    def _drain_group(self):
        """Wait for the pending group's event, unpack its rows, write its
        records, and checkpoint every CHECKPOINT_DRAINS drains."""
        if self._gpending is None:
            return
        res, self._gpending = self._gpending, None
        entries = res["entries"]
        with self.timer.span("fastsmc.drain"):
            with self.timer.span("fastsmc.drain.wait"):
                for event in res["events"]:
                    event.synchronize()
            packed = _split_rows(*res["packed"])
            ages = [None] * len(entries) if res["ages"] is None \
                else _split_rows(*res["ages"])
            self.stats["d2h_bytes"] += sum(res[k][0].nbytes for k in
                                           ("packed", "ages") if res[k])
            out = []
            for e, packed_i, ages_i in zip(entries, packed, ages):
                start, b, score, ns_kept = self._unpack_entry(packed_i, e)
                out.append((seg.runs_from_packed(start, b, score,
                                                 e["t_len"]),
                            None if ages_i is None
                            else self._merge_entry_ages(ages_i, ns_kept)))
        for e, (runs, ages_e) in zip(entries, out):
            self._emit_runs(e, *runs, ages=ages_e)
        # the checkpoint names only batches whose records reached the
        # writer; run() closes the output without one
        self._drains_since_ckpt += 1
        if self._drains_since_ckpt >= CHECKPOINT_DRAINS:
            self._drains_since_ckpt = 0
            self._write_progress(entries[-1]["idx"])

    def _emit_runs(self, e, pair, a, b, score_sum, ages=None):
        """Write one batch's kept runs (window-relative a/b); ``ages`` is
        [2, n_kept] (posterior mean, MAP) aligned with the runs."""
        with self.timer.span("fastsmc.emit"):
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
        """Checkpoint (fastsmc.py:872-899): close the writer, which writes
        every queued gzip member, so the file is valid up to here and ends
        on a member boundary, record (finished batches,
        segments, byte offset), and reopen in append mode; the reopened
        writer records into the same spans."""
        with self.timer.span("fastsmc.checkpoint"):
            out = self.params.ibd_output_path()
            self._writer.close()
            offset = os.path.getsize(out)
            path = out + ".progress"
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                f.write(f"{done_idx} {self.n_segments} {offset}\n")
            os.replace(tmp, path)
            self._open_writer(append=True)

    def roofline(self) -> dict:
        """Host terms of a finished run (fastsmc.py:980-996): megabytes
        copied from the card, then seconds from the spans: the drain's wait
        on the card and its own host time (its span less the waits), the
        batcher's and the checkpoints', the writer's format and deflate
        (thread-seconds, summed over its workers) and the scan thread's;
        then the text writer's worker threads, the gzip members it wrote
        and the wall seconds in which at least one worker was busy; last
        the dispatch's waits for the batches' run counts."""
        sp = self.timer
        wait = sp.total_s("fastsmc.drain.wait")
        return {
            "d2h_mb": self.stats["d2h_bytes"] / 1e6,
            "drain_wait_s": wait,
            "drain_host_s": sp.total_s("fastsmc.drain") - wait,
            "batcher_s": sp.total_s("fastsmc.intake"),
            "ckpt_s": sp.total_s("fastsmc.checkpoint"),
            "writer_fmt_s": sp.total_s(writers.FORMAT),
            "writer_deflate_s": sp.total_s(writers.DEFLATE),
            "scan_thread_s": sp.total_s(SCAN),
            "writer_workers": getattr(self._writer, "workers", 0),
            "writer_chunks": int(sp.counter(writers.CHUNKS)),
            "writer_busy_s": sp.counter(writers.BUSY),
            "count_wait_s": sp.total_s("fastsmc.dispatch.count_wait"),
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
            with self.timer.span("fastsmc.intake"):
                n = min(ofs + p.batch_size, end) - ofs
                self._cpt += n
                self.stats["cand_site_pairs"] += L * n
                skip = self._batch_idx < self._resume_skip
                self._batch_idx += 1
                if not skip:
                    h1, h2 = pairs_from_flat_indices(
                        np.arange(ofs, ofs + n), p.within_only)
                    fill = -n % self._shards
                    h1, h2 = (np.concatenate([h.astype(np.int32),
                                              np.full(fill, h[-1], np.int32)])
                              for h in (h1, h2))
            if not skip:
                self._queue_entry(dict(
                    hap1=h1, hap2=h2, n=n, frm=0, t_len=bucket_len(L), s0=0,
                    s1=L, w0=None, w1=None, P=n + fill))

    # ------------------------------------------------------------------
    def run(self, verbose: bool = True, resume: bool = False) -> str:
        """Full pipeline (fastsmc.py:1045-1110); returns the output path.
        With ``resume=True`` a run killed after a checkpoint continues:
        the output is cut back to the ``.progress`` sidecar's offset, the
        deterministic candidate stream is replayed and the batches the
        sidecar names are skipped. The spans start afresh."""
        self.timer.reset()
        with self.timer.span("fastsmc.run"):
            path = self._run(resume, verbose)
        if verbose:
            print(f"[fastsmc] {self.n_segments} segments "
                  f"({self._cpt} candidates) in {self.timer.total():.2f}s "
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

    def _run(self, resume: bool, verbose: bool) -> str:
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
            scan = HashingScan(self.params, self.data, self._on_match,
                               self.timer)
            scan.array_callback = self._on_matches_array
            scan.run(verbose=verbose)
            if self.bucket_sites:
                self._drain_buckets()
            if self._sort_buf:
                self._drain_sort_buf(final=True)
            self._flush(self._bn)
        else:
            self._run_no_hashing()
        self._dispatch_group()
        self._drain_group()
        with self.timer.span("fastsmc.writer.close"):
            self._writer.close()
        if os.path.exists(progress):
            os.remove(progress)
        return path


def _flat_to_host(rows) -> tuple:
    """A group's rows (one tensor a batch, each its own shape) in one copy
    to the host (``kernels.to_host``): ``(flat tensor, shapes)``."""
    return (to_host(torch.cat([r.reshape(-1) for r in rows])),
            [tuple(r.shape) for r in rows])


def _split_rows(flat: torch.Tensor, shapes) -> list:
    """The rows of :func:`_flat_to_host`'s copy as arrays, once its event
    has fired."""
    ends = np.cumsum([int(np.prod(s)) for s in shapes])[:-1]
    return [x.reshape(s) for x, s in zip(np.split(flat.numpy(), ends),
                                         shapes)]
