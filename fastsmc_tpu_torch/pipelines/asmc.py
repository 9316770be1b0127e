"""ASMC on the GPU: all-pairs posterior decoding and the targeted-pair API.

Counterpart of ``fastsmc_tpu/pipelines/asmc.py`` (array and sequence
mode; exact, fast and turbo profiles): ``decode_all_in_job`` enumerates the job's pair range
(HMM.cpp:310-364) batch by batch through the two CUDA kernels, which sum
the posteriors over pairs on the card (``posterior_sums``,
``major_minor_sums``) and emit the per-pair posterior means and MAP states
that stream to ``.perPairPosteriorMeans.gz`` / ``.perPairMAP.gz``; the
batch sums accumulate on the host in float64. ``decode_pairs`` decodes
explicit pairs and returns the summaries of ``DecodePairsReturnStruct``.

The kernels take any number of pairs, so a partial last batch decodes
exactly its real pairs: the JAX package's padding with copies of the last
pair, and the second decode that subtracts them, have no counterpart. With
a mesh (``parallel.sharding``) a batch is split over its shards; of a last
batch that does not divide over them, the pairs past the last whole
multiple of the mesh size decode on the first shard's device.

Every stage of a job records a span in ``ASMC.timer`` (``utils.timer``),
as FastSMC's do: the constructor ``asmc.init``; ``decode_all_in_job``
starts the recorder afresh and records ``asmc.decode``, the job's loop,
and in it for each batch ``asmc.batch.pairs`` (the batch's flat pair
indices), the decoder's ``asmc.decode.prologue``, ``.forward`` and
``.backward``, ``asmc.d2h`` (the copy of the batch's outputs to the host,
where the host waits on the card), ``asmc.accumulate`` (the float64 adds)
and, with per-pair streams, ``asmc.per_pair.write``; ``write_outputs``
records ``asmc.write``, and the sums writer's pool (``io.writers``) on its
threads ``asmc.write.format`` and ``.deflate`` for each chunk, with
``asmc.write`` as parent. The counters ``pairs``, ``batches`` and
``d2h_bytes`` sit beside them, and the writer's ``asmc.write.members``
and ``asmc.write.native_chunks``. Under a running profiler the spans are
``record_function`` ranges of the trace too; ``roofline()`` reads them.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..config import DecodingParams
from ..engine.hmm import bucket_len
from ..engine.kernels import (BwdOutputs, GpuDecoder, PAIRS_PER_BLOCK,
                              PROFILES, alpha_dtype)
from ..engine.oracle import DecodeContext, OracleDecoder
from ..engine.tables import padded_states
from ..io import writers
from ..io.decoding_quantities import DecodingQuantities
from ..io.haps import Data, load_data
from ..parallel.sharding import ShardedDecoder, on_device
from ..utils.timer import SpanRecorder

# The helpers and result types below are copies of
# fastsmc_tpu/pipelines/asmc.py:45-86 and :170-197.

def hap_to_dip_id(hap: int) -> Tuple[int, int]:
    """HmmUtils.cpp:179-182."""
    return hap // 2, 1 + hap % 2


def dip_to_hap_id(ind: int, hap: int) -> int:
    """HmmUtils.cpp:184-188."""
    assert hap in (1, 2)
    return 2 * ind + hap - 1


def combined_id_to_ind_plus_hap(combined: str) -> Tuple[str, int]:
    """HmmUtils.cpp:200-208 (``<id>#1`` / ``<id>#2``)."""
    if len(combined) < 3 or combined[-2:] not in ("#1", "#2"):
        raise ValueError(
            f"Expected combined ID in form <id>#1 OR <id>#2, got {combined}")
    return combined[:-2], int(combined[-1])


@dataclasses.dataclass
class DecodingReturnValues:
    sum_over_pairs: np.ndarray                 # [L, K]
    sum_over_pairs00: Optional[np.ndarray] = None
    sum_over_pairs01: Optional[np.ndarray] = None
    sum_over_pairs11: Optional[np.ndarray] = None
    sites: int = 0
    states: int = 0
    site_was_flipped: Optional[np.ndarray] = None


@dataclasses.dataclass
class DecodePairsReturnStruct:
    """Python-API result container (DecodePairsReturnStruct.hpp:22-127)."""
    per_pair_indices: List[Tuple[int, str, int, str]]
    per_pair_posteriors: Optional[np.ndarray] = None   # [n, K, L]
    sum_of_posteriors: Optional[np.ndarray] = None     # [K, L]
    per_pair_posterior_means: Optional[np.ndarray] = None  # [n, L]
    min_posterior_means: Optional[np.ndarray] = None   # [L]
    argmin_posterior_means: Optional[np.ndarray] = None
    per_pair_maps: Optional[np.ndarray] = None         # [n, L] int
    min_maps: Optional[np.ndarray] = None
    argmin_maps: Optional[np.ndarray] = None


def pairs_from_flat_indices(idx: np.ndarray, within_only: bool = False
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """Closed-form mapping of the reference's flat pair enumeration
    (HMM.cpp:325-357) so biobank-scale ranges never materialise lists.

    Ordering per individual i: for j < i, (iHap, jHap) in row-major
    {1,2}x{1,2} emitting hap rows (2j+jHap, 2i+iHap); then the
    within-individual pair (2i, 2i+1).  Cumulative count before i is
    C(i) = 2*i^2 - i.
    """
    idx = np.asarray(idx, dtype=np.int64)
    if within_only:
        return 2 * idx, 2 * idx + 1
    # invert C(i) = 2 i^2 - i <= p  =>  i = floor((1 + sqrt(1+8p)) / 4)
    i = ((1.0 + np.sqrt(1.0 + 8.0 * idx.astype(np.float64))) / 4.0
         ).astype(np.int64)
    # float guard around the boundary
    i = np.where(2 * i * i - i > idx, i - 1, i)
    i = np.where(2 * (i + 1) * (i + 1) - (i + 1) <= idx, i + 1, i)
    r = idx - (2 * i * i - i)
    cross = r < 4 * i
    j = r // 4
    ihap = (r % 4) // 2
    jhap = r % 2
    h1 = np.where(cross, 2 * j + jhap, 2 * i)
    h2 = np.where(cross, 2 * i + ihap, 2 * i + 1)
    return h1, h2


def max_batch(free_bytes: int, sites: int, states: int,
              alpha_bytes: int = 4) -> int:
    """Most pairs a batch may hold on a device with ``free_bytes`` free:
    half of it for the [T, KP, P] forward messages (``alpha_bytes`` an
    element: 4 exact, 2 fast/turbo), the backward kernel's per-block
    partials and the per-pair outputs on the longest window (the whole
    chromosome), in whole 32-pair blocks. The other half is left to the
    caching allocator."""
    KP = padded_states(states)
    per_pair = bucket_len(sites) * (
        alpha_bytes * KP + 4 * (KP * 4 // PAIRS_PER_BLOCK + 2))
    return max(PAIRS_PER_BLOCK, free_bytes // 2 // per_pair
               // PAIRS_PER_BLOCK * PAIRS_PER_BLOCK)


def free_bytes(device: torch.device) -> int:
    """Bytes free to this process on the CUDA ``device``: the card's free
    memory and what the caching allocator holds that no tensor uses (a
    previous job's blocks, which the allocator hands out again or
    releases when a request needs them)."""
    free, _ = torch.cuda.mem_get_info(device)
    return free + torch.cuda.memory_reserved(device) \
        - torch.cuda.memory_allocated(device)


def job_pair_range(n_ind: int, params: DecodingParams) -> Tuple[int, int]:
    """The job's slice [start, end) of the flat pair enumeration: all
    2N^2 - N pairs, or the N within-individual ones (asmc.py:199-203)."""
    tot = n_ind if params.within_only else 2 * n_ind * n_ind - n_ind
    return (tot * (params.job_ind - 1) // params.jobs,
            tot * params.job_ind // params.jobs)


class ASMC:
    """All-pairs / targeted-pair decoding on one CUDA device or a mesh."""

    pairs_from_flat_indices = staticmethod(pairs_from_flat_indices)

    def __init__(self, params: DecodingParams,
                 data: Optional[Data] = None,
                 dq: Optional[DecodingQuantities] = None,
                 device=None,
                 batch_size: Optional[int] = None,
                 decode_profile: str = "exact",
                 mesh=None):
        """Arguments as the JAX package's ``ASMC``, with ``device`` (where
        the tables live and the kernels run: "cuda", the default, or "cpu"
        for the plain versions) in place of ``use_pallas``.
        ``decode_profile`` is "exact", "fast" or "turbo" (the JAX package's
        profiles; fast and turbo give the same bits). ``mesh``
        (``parallel.sharding.make_mesh``) shards every batch over its
        devices, which then rule: the batch size must be a multiple of its
        size, and a ``device`` that names another device raises
        ``ValueError``. ``params.no_batches`` decodes pair by pair with the
        scalar ``OracleDecoder`` on the host, and drops the mesh."""
        if params.no_batches:
            mesh = None
        if mesh is not None and device is not None:
            mesh.check_device(device)
        if decode_profile not in PROFILES:
            raise ValueError(f"unknown decode profile {decode_profile!r}")
        self.params = params
        self.timer = SpanRecorder(root="asmc.decode")
        self._write_workers = 0       # the sums writer's W, at the last write
        with self.timer.span("asmc.init"):
            self.data = data if data is not None else load_data(params)
            self.dq = dq if dq is not None else DecodingQuantities.load(
                params.decoding_quant_file)
            self.ctx = DecodeContext.build(params, self.data, self.dq)
            self.batch_size = batch_size or max(params.batch_size, 64)
            self._shards = 1 if mesh is None else mesh.size
            if params.no_batches:
                # reference noBatches debug path: scalar oracle per pair
                self.decoder = OracleDecoder(self.ctx)
                devices = []
            elif mesh is not None:
                if self.batch_size % mesh.size:
                    raise ValueError(
                        f"batch_size {self.batch_size} must be a multiple "
                        f"of the mesh size {mesh.size}")
                self.decoder = ShardedDecoder(self.ctx, mesh, decode_profile,
                                              self.timer, "asmc")
                devices = list(dict.fromkeys(mesh.devices))
            else:
                self.decoder = GpuDecoder(
                    self.ctx, "cuda" if device is None else device,
                    decode_profile, self.timer, "asmc")
                devices = [self.decoder.device]
            # a shard's batch may take half its card's free memory; sums
            # are then taken over smaller batches, which changes only their
            # f32 rounding
            for dev in devices:
                if dev.type == "cuda":
                    self.batch_size = min(
                        self.batch_size, self._shards * max_batch(
                            free_bytes(dev), self.data.sites, self.dq.states,
                            alpha_dtype(decode_profile).itemsize))
            self._device_decoder = bool(devices)

            # expected coalescent times for per-pair posterior means: from
            # --expectedCoalTimesFile when given (HMM.cpp:1741-1748,
            # non-FastSMC only), else the decoding quantities' expectedTimes
            self.expected_coal_times = self.dq.expected_times
            ect_file = params.expected_coal_times_file
            if ect_file and not params.fastsmc and os.path.isfile(ect_file):
                self.expected_coal_times = \
                    writers.read_expected_times_from_intervals_file(ect_file)
                if len(self.expected_coal_times) != self.dq.states:
                    raise ValueError(
                        f"{ect_file} has {len(self.expected_coal_times)} "
                        f"times, expected {self.dq.states}")
                if self._device_decoder:
                    # the per_pair_mean kernel output reads the tables' times
                    self.decoder.exp_times = self.expected_coal_times

    # ------------------------------------------------------------------
    def _job_pair_range(self) -> Tuple[int, int]:
        return job_pair_range(self.data.n_ind, self.params)

    def _job_pairs(self) -> List[Tuple[int, int]]:
        start, end = self._job_pair_range()
        h1, h2 = pairs_from_flat_indices(
            np.arange(start, end, dtype=np.int64), self.params.within_only)
        return list(zip(h1.tolist(), h2.tolist()))

    def _batches(self):
        """The job's pairs, batch by batch: int32 (h1, h2)."""
        p = self.params
        start, end = self._job_pair_range()
        for ofs in range(start, end, self.batch_size):
            with self.timer.span("asmc.batch.pairs"):
                h1, h2 = pairs_from_flat_indices(
                    np.arange(ofs, min(ofs + self.batch_size, end)),
                    p.within_only)
                h1, h2 = h1.astype(np.int32), h2.astype(np.int32)
            self.timer.add("batches")
            self.timer.add("pairs", len(h1))
            yield h1, h2

    def _decode(self, h1, h2, t0: int, t_len: int, outs: BwdOutputs
                ) -> dict:
        """The requested outputs for the pairs over [t0, t0+t_len) as host
        arrays, at ``GpuDecoder.decode_pairs``'s shapes. The oracle path
        derives them from its posterior as the JAX package's plain path
        does (asmc.py:306-328)."""
        if self._device_decoder:
            r = self._device_decode(h1, h2, t0, t_len, outs)
            with self.timer.span("asmc.d2h"):
                r = {k: v.cpu().numpy() for k, v in r.items()}
            self.timer.add("d2h_bytes", sum(v.nbytes for v in r.values()))
            return r
        post = self._full_posterior(h1, h2, t_len, t0)        # [T, K, n]
        r = {}
        if outs.posterior:
            r["posterior"] = post
        if outs.posterior_sums:
            r["posterior_sums"] = post.sum(axis=2)
        if outs.per_pair_mean:
            r["per_pair_mean"] = np.einsum("tkp,k->tp", post,
                                           self.expected_coal_times)
        if outs.per_pair_map:
            r["per_pair_map"] = post.argmax(axis=1).astype(np.float32)
        if outs.major_minor_sums:
            site = np.minimum(np.arange(t0, t0 + t_len), self.data.sites - 1)
            a = self.data.hap_bits[h1][:, site]
            b = self.data.hap_bits[h2][:, site]
            w = ((~(a ^ b) & ~(a & b)) & 1, (a ^ b) & 1, a & b)  # 00, 01, 11
            r["major_minor_sums"] = np.stack(
                [np.einsum("tkp,pt->tk", post, c.astype(np.float32))
                 for c in w], axis=1)
        return r

    def _device_decode(self, h1, h2, t0: int, t_len: int, outs: BwdOutputs
                       ) -> dict:
        """The decoder's outputs for the pairs. On a mesh, the pairs past
        the last whole multiple of the mesh size decode on the first
        shard's device and join the rest through ``ShardedDecoder.combine``
        (the sums added in float64, the per-pair outputs in pair order)."""
        dec = self.decoder
        k = len(h1) - len(h1) % self._shards
        if k == len(h1):
            return dec.decode_pairs(h1, h2, t0, t_len, outs, 0)
        with on_device(dec.devices[0]):
            tail = dec.shard_decoder(0).decode_pairs(h1[k:], h2[k:], t0,
                                                     t_len, outs, 0)
        if k == 0:
            return tail
        return dec.combine([dec.decode_pairs(h1[:k], h2[:k], t0, t_len,
                                             outs, 0), tail])

    # ------------------------------------------------------------------
    def decode_all_in_job(self, verbose: bool = True,
                          chunk_sites: Optional[int] = None,
                          halo_cm: float = 2.0) -> DecodingReturnValues:
        """All-pairs posterior sums for this job (asmc.py:212-349).

        ``chunk_sites`` enables genome-chunked decoding: each chunk decodes
        with a ``halo_cm`` centimorgan halo on both sides and only interior
        positions contribute. The spans start afresh."""
        self.timer.reset()
        if chunk_sites is not None:
            return self._decode_all_chunked(chunk_sites, halo_cm, verbose)
        p = self.params
        L, K = self.data.sites, self.dq.states
        t_len = bucket_len(L)
        start, end = self._job_pair_range()
        n_pairs = end - start

        sums = np.zeros((L, K), np.float64)
        mm = np.zeros((3, L, K), np.float64) \
            if p.do_major_minor_posterior_sums else None

        # per-pair streaming outputs (HMM.cpp:258-271, 1360-1419), which the
        # reference only streams outside FastSMC mode
        need_mean = p.do_per_pair_posterior_mean and not p.fastsmc
        need_map = p.do_per_pair_map and not p.fastsmc
        mean_writer = map_writer = None
        if need_mean:
            mean_writer = writers.PerPairStreamWriter(
                p.out_file_root + ".perPairPosteriorMeans.gz")
        if need_map:
            map_writer = writers.PerPairStreamWriter(
                p.out_file_root + ".perPairMAP.gz", integers=True)
        outs = BwdOutputs(posterior=False,
                          posterior_sums=p.do_posterior_sums,
                          major_minor_sums=mm is not None,
                          per_pair_mean=need_mean, per_pair_map=need_map)

        done = 0
        with self.timer.span("asmc.decode"):
            for h1, h2 in self._batches():
                r = self._decode(h1, h2, 0, t_len, outs)
                with self.timer.span("asmc.accumulate"):
                    if p.do_posterior_sums:
                        sums += r["posterior_sums"][:L]
                    if mm is not None:
                        mm += r["major_minor_sums"][:L].transpose(1, 0, 2)
                if need_mean or need_map:
                    with self.timer.span("asmc.per_pair.write"):
                        if need_mean:
                            mean_writer.write_rows(r["per_pair_mean"][:L].T)
                        if need_map:
                            map_writer.write_rows(r["per_pair_map"][:L].T)
                done += len(h1)
                if verbose:
                    print(f"\rDecoding progress: {100 * done // n_pairs}% "
                          f"({done}/{n_pairs})", end="", flush=True)
            if need_mean or need_map:
                with self.timer.span("asmc.per_pair.write"):
                    if mean_writer is not None:
                        mean_writer.close()
                    if map_writer is not None:
                        map_writer.close()
        if verbose:
            print(f"\nDecoded {n_pairs} pairs in "
                  f"{self.timer.total_s('asmc.decode'):.3f} seconds.")

        out = DecodingReturnValues(
            sum_over_pairs=sums.astype(np.float32),
            sites=L, states=K,
            site_was_flipped=self.data.site_was_flipped)
        if mm is not None:
            out.sum_over_pairs00 = mm[0].astype(np.float32)
            out.sum_over_pairs01 = mm[1].astype(np.float32)
            out.sum_over_pairs11 = mm[2].astype(np.float32)
        return out

    def _decode_all_chunked(self, chunk_sites: int, halo_cm: float,
                            verbose: bool) -> DecodingReturnValues:
        """Posterior sums chunk by chunk over the genome (asmc.py:351-415)."""
        from .fastsmc import get_from_position, get_to_position
        L, K = self.data.sites, self.dq.states
        g = self.data.genetic_positions
        start, end = self._job_pair_range()
        n_pairs = end - start
        sums = np.zeros((L, K), np.float64)

        chunks = []
        for c0 in range(0, L, chunk_sites):
            c1 = min(c0 + chunk_sites, L)
            w0 = get_from_position(g, c0, halo_cm)
            w1 = get_to_position(g, c1 - 1, halo_cm)
            chunks.append((c0, c1, w0, w1))

        outs = BwdOutputs(posterior=False, posterior_sums=True)
        done = 0
        with self.timer.span("asmc.decode"):
            for h1, h2 in self._batches():
                for (c0, c1, w0, w1) in chunks:
                    s = self._decode(h1, h2, w0, bucket_len(w1 - w0),
                                     outs)["posterior_sums"]
                    with self.timer.span("asmc.accumulate"):
                        sums[c0:c1] += s[c0 - w0:c1 - w0]
                done += len(h1)
                if verbose:
                    print(f"\rDecoding progress: {100 * done // n_pairs}%",
                          end="", flush=True)
        if verbose:
            print(f"\nDecoded {n_pairs} pairs (chunked x{len(chunks)}) in "
                  f"{self.timer.total_s('asmc.decode'):.3f} seconds.")
        return DecodingReturnValues(
            sum_over_pairs=sums.astype(np.float32), sites=L, states=K,
            site_was_flipped=self.data.site_was_flipped)

    def _full_posterior(self, h1, h2, t_len, t0_pos: int = 0) -> np.ndarray:
        """Posterior [t_len, K, n] of the pairs on the host; on a mesh the
        pair axis is padded to a multiple of its size with copies of the
        last pair (asmc.py:417-424)."""
        if self._device_decoder:
            n = len(h1)
            fill = -n % self._shards
            h1, h2 = (np.concatenate([h, np.full(fill, h[-1], h.dtype)])
                      for h in (h1, h2))
            r = self.decoder.decode_pairs(h1, h2, t0_pos, t_len,
                                          BwdOutputs(posterior=True), 0)
            return r["posterior"][..., :n].cpu().numpy()
        return np.asarray(self.decoder.decode_pairs(h1, h2, t0_pos, t_len))

    # ------------------------------------------------------------------
    def write_outputs(self, result: DecodingReturnValues) -> None:
        """main.cpp:119-167: the job's two or four sums files in one call
        of the sums writer, on one pool of threads."""
        p = self.params
        with self.timer.span("asmc.write"):
            mats = {}
            if p.do_posterior_sums:
                mats[p.out_file_root + ".sumOverPairs.gz"] = \
                    result.sum_over_pairs
            if p.do_major_minor_posterior_sums:
                mats.update(writers.major_minor_files(
                    p.out_file_root, result.sum_over_pairs00,
                    result.sum_over_pairs01, result.sum_over_pairs11,
                    result.site_was_flipped))
            self._write_workers = writers.write_sums_files(mats, self.timer)

    def roofline(self) -> dict:
        """Host terms of the last job, as ``FastSMC.roofline()`` gives
        its own: the counters (bytes copied from the card, pairs and
        batches decoded), then seconds from the spans: the job's loop,
        and in it the pair indices, the decoder's prologue, forward and
        backward (the time to queue them where the card runs them), the
        wait for each batch's outputs, the float64 adds and the per-pair
        streams; then the sums writer: its wall, the seconds its workers
        spent formatting and deflating (summed over the pool's threads),
        the gzip members written, the chunks the native formatter made
        and the pool's W."""
        sp = self.timer
        return {
            "d2h_bytes": int(sp.counter("d2h_bytes")),
            "pairs": int(sp.counter("pairs")),
            "batches": int(sp.counter("batches")),
            "decode_s": sp.total_s("asmc.decode"),
            "batch_pairs_s": sp.total_s("asmc.batch.pairs"),
            "prologue_s": sp.total_s("asmc.decode.prologue"),
            "forward_s": sp.total_s("asmc.decode.forward"),
            "backward_s": sp.total_s("asmc.decode.backward"),
            "d2h_s": sp.total_s("asmc.d2h"),
            "accumulate_s": sp.total_s("asmc.accumulate"),
            "per_pair_write_s": sp.total_s("asmc.per_pair.write"),
            "write_s": sp.total_s("asmc.write"),
            "write_format_s": sp.total_s(writers.SUMS_FORMAT),
            "write_deflate_s": sp.total_s(writers.SUMS_DEFLATE),
            "write_members": int(sp.counter(writers.SUMS_MEMBERS)),
            "write_native_chunks": int(sp.counter(
                writers.SUMS_NATIVE_CHUNKS)),
            "write_workers": self._write_workers,
        }

    # ------------------------------------------------------------------
    def decode_pairs(self,
                     haps_a: Sequence[Union[int, str]],
                     haps_b: Sequence[Union[int, str]],
                     per_pair_posteriors: bool = False,
                     sum_of_posteriors: bool = False,
                     per_pair_posterior_means: bool = True,
                     per_pair_maps: bool = True) -> DecodePairsReturnStruct:
        """ASMC.cpp:80-128 + DecodePairsReturnStruct summaries."""
        if len(haps_a) != len(haps_b) or not haps_a:
            raise ValueError("A and B hap vectors must be equal-length, "
                             "non-empty")
        iid = self.data.iid_list

        def to_hap(x) -> int:
            if isinstance(x, str):
                sid, hap = combined_id_to_ind_plus_hap(x)
                idx = iid.index(sid)
                return dip_to_hap_id(idx, hap)
            return int(x)

        ha = np.asarray([to_hap(x) for x in haps_a], np.int32)
        hb = np.asarray([to_hap(x) for x in haps_b], np.int32)
        L = self.data.sites
        post = self._full_posterior(ha, hb, bucket_len(L))[:L]  # [L, K, n]
        expt = self.expected_coal_times

        indices = []
        for a, b in zip(ha, hb):
            ia, hap_a = hap_to_dip_id(int(a))
            ib, hap_b = hap_to_dip_id(int(b))
            indices.append((int(a), f"{iid[ia]}#{hap_a}",
                            int(b), f"{iid[ib]}#{hap_b}"))

        res = DecodePairsReturnStruct(per_pair_indices=indices)
        scaled = post * expt[None, :, None]               # [L, K, n]
        if per_pair_posteriors:
            res.per_pair_posteriors = scaled.transpose(2, 1, 0)
        if sum_of_posteriors:
            res.sum_of_posteriors = scaled.sum(axis=2).T  # [K, L]
        if per_pair_posterior_means or per_pair_posteriors:
            means = scaled.sum(axis=1).T                  # [n, L]
            res.per_pair_posterior_means = means
            res.min_posterior_means = means.min(axis=0)
            res.argmin_posterior_means = means.argmin(axis=0)
        if per_pair_maps:
            maps = post.argmax(axis=1).T                  # [n, L]
            res.per_pair_maps = maps.astype(np.int32)
            res.min_maps = maps.min(axis=0).astype(np.int32)
            res.argmin_maps = maps.argmin(axis=0).astype(np.int32)
        return res
