"""Output codecs: IBD text/binary writers, posterior-sum writers, binary reader.

The port's copy of ``fastsmc_tpu/io/writers.py``. Byte-compatible with the
reference formats:
  * text ``.ibd.gz`` records (HMM.cpp:1110-1144), float columns printed with
    ``setprecision(digits10+1 == 7)`` default-float formatting (== ``%.7g``)
  * binary ``.bibd.gz``: header (3 option bools, chr, id table --
    HMM.cpp:383-401) + packed records (HMM.cpp:1146-1176)
  * ``.sumOverPairs.gz`` matrices in Eigen tab format (main.cpp:119-167)
    including the major/minor fold-flip
  * ``.perPairPosteriorMeans.gz`` / ``.perPairMAP.gz`` row streams
  * reader of ``.bibd.gz`` mirroring BinaryDataReader.hpp:64-185 (the
    ``convert-binary`` CLI)

The text ``.ibd.gz`` and the ``.sumOverPairs.gz`` files are series of
complete gzip members, made by one mechanism, :class:`_MemberPool`: each
chunk of text is formatted and deflated on a pool of W =
:func:`pool_workers` threads, by the same rule for every W (at W = 1 one
worker takes the chunks in order, never the calling thread). gzip
readers (``gzip.open``, ``zcat``) read the members
as one stream, so the decompressed bytes are the JAX package's, while the
compressed bytes differ from its single stream (about 0.3 % larger). The
text ``.ibd.gz`` has a member per CHUNK_RECORDS records (about 1 MiB of
text; the last of a file, or of a checkpoint's part, holds fewer), cut
across the blocks' edges, appended in order by one writer thread.

One fault of the JAX package's text writer is repaired here: when the
native formatter returns ``None`` (its C side refuses a truncated buffer)
the writer thread there fails on ``write(None)`` and exits with items still
queued, so the next ``Queue.join()`` never returns. This writer names the
formatter's failure, keeps taking the chunks left after an error, and
raises the error from ``close()`` instead of hanging.

The ``.sumOverPairs.gz`` files have a member per SUMS_CHUNK_ROWS rows,
formatted natively or by the same "%.6g" text in Python; each file is
written whole, its members in row order.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gzip
import os
import queue
import struct
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np

from .. import native
from ..utils.timer import SpanRecorder

# the IBD writers' spans: records formatted, and their bytes deflated
FORMAT = "fastsmc.writer.format"
DEFLATE = "fastsmc.writer.deflate"
# the text writer's counters: members written, and wall seconds in which
# at least one worker formatted or deflated
CHUNKS = "fastsmc.writer.chunks"
BUSY = "fastsmc.writer.busy_s"

# the sums writer's spans and counters, in ASMC's recorder: a chunk's rows
# formatted and deflated; members written, and the chunks the native
# formatter made (0: the Python fallback ran)
SUMS_FORMAT = "asmc.write.format"
SUMS_DEFLATE = "asmc.write.deflate"
SUMS_MEMBERS = "asmc.write.members"
SUMS_NATIVE_CHUNKS = "asmc.write.native_chunks"

# records per gzip member: ~0.9 MiB of text at ~92 bytes a record
CHUNK_RECORDS = 10_000
# rows per gzip member of a sums file: ~1.1 MiB of text at 69 states
SUMS_CHUNK_ROWS = 2_000
# chunks queued and not yet written; a full queue blocks the emit
MAX_CHUNKS_IN_FLIGHT = 64


def _usable_cores() -> int:
    """Cores this process may run on."""
    return len(os.sched_getaffinity(0))


def pool_workers() -> int:
    """W, the member pools' worker threads: one core left to the main
    thread and the hashing scan, at most 8."""
    return max(1, min(8, _usable_cores() - 1))


def fmt_float(x) -> str:
    """C++ ostream default-float with precision 7 (== printf %.7g)."""
    return "%.7g" % float(x)


def _gzip_member(text: bytes) -> bytes:
    """``text`` as one complete gzip member at level 6, the zlib default
    the reference's gzofstream uses (Python's gzip defaults to 9: ~3x
    slower deflate for a 2 % smaller file), with no time stamp."""
    return gzip.compress(text, 6, mtime=0)


class _MemberPool:
    """Chunks of text made into gzip members (:func:`_gzip_member`) on a
    pool of :func:`pool_workers` threads named ``name``, never on the
    calling thread, until :meth:`shutdown`. A chunk is a list of pieces:
    text, or items ``fmt`` turns into text (the formatter and zlib both
    release the GIL, so the workers overlap). Each ``fmt`` call is a
    ``format_span`` and each deflate a ``deflate_span`` in ``spans``, with
    the chunk's ``parent``; with ``busy`` named, that counter gains the
    wall from the first worker in to the last one out."""

    def __init__(self, name: str, spans: SpanRecorder, fmt,
                 format_span: str, deflate_span: str,
                 busy: Optional[str] = None):
        self.workers = pool_workers()
        self._pool = ThreadPoolExecutor(self.workers,
                                        thread_name_prefix=name)
        self._spans, self._fmt, self._busy_name = spans, fmt, busy
        self._fmt_span, self._deflate_span = format_span, deflate_span
        self._lock = threading.Lock()
        self._active = self._busy_t0 = 0   # workers in a span; since when

    def submit(self, parent: Optional[str], chunk: list) -> Future:
        """The future of ``chunk``'s member."""
        return self._pool.submit(self._member, parent, chunk)

    def shutdown(self, cancel: bool = False) -> None:
        self._pool.shutdown(cancel_futures=cancel)

    @contextlib.contextmanager
    def _span(self, name: str, parent: Optional[str]):
        with self._spans.span(name, parent):
            if self._busy_name is None:
                yield
                return
            with self._lock:
                if self._active == 0:
                    self._busy_t0 = time.perf_counter_ns()
                self._active += 1
            try:
                yield
            finally:
                with self._lock:
                    self._active -= 1
                    if self._active == 0:
                        self._spans.add(self._busy_name, 1e-9 * (
                            time.perf_counter_ns() - self._busy_t0))

    def _member(self, parent: Optional[str], chunk: list) -> bytes:
        text = []
        for piece in chunk:
            if not isinstance(piece, bytes):
                with self._span(self._fmt_span, parent):
                    piece = self._fmt(piece)
            text.append(piece)
        with self._span(self._deflate_span, parent):
            return _gzip_member(b"".join(text))


class IbdTextWriter:
    """Streaming text IBD writer (HMM.cpp:1114-1144).

    The records are cut into chunks of CHUNK_RECORDS records, across the
    blocks' edges (a small block waits for the next ones, or for
    ``close()``), each made a gzip member by a :class:`_MemberPool` (the
    native C formatter; without it, the same "%.7g" text made in Python
    on the calling thread), the members appended in chunk order by one
    writer thread; at most MAX_CHUNKS_IN_FLIGHT chunks wait, so a fast
    producer blocks in ``write_block``. ``close()`` writes every queued
    chunk, so the file ends on a member boundary (a checkpoint's offset).
    In ``spans``: the FORMAT and DEFLATE spans, with the span that began
    the chunk as parent, and the CHUNKS and BUSY counters."""

    def __init__(self, path: str, fam_ids: List[str], iids: List[str],
                 chr_number: int, append: bool = False,
                 spans: Optional[SpanRecorder] = None):
        self._raw = open(path, "ab" if append else "wb")
        self._append = append
        self.fam = fam_ids
        self.iid = iids
        self.chr = chr_number
        self.n_written = 0
        self._id_blob = None          # lazy native-formatter id table
        self._id_off = None
        self.spans = spans if spans is not None else SpanRecorder()
        self._err = None
        # the chunk being filled: pieces of blocks (columns, or the Python
        # fallback's text), their records, the span that began it
        self._chunk: list = []
        self._chunk_n = 0
        self._chunk_parent = None
        self._pool = _MemberPool("fastsmc-deflate", self.spans, self._format,
                                 FORMAT, DEFLATE, BUSY)
        self.workers = self._pool.workers
        self._q = queue.Queue(maxsize=MAX_CHUNKS_IN_FLIGHT)
        self._thr = threading.Thread(target=self._write_loop,
                                     name="fastsmc-write", daemon=True)
        self._thr.start()

    def _format(self, piece: tuple) -> bytes:
        """A piece's columns as text, by the native formatter."""
        buf = native.format_ibd(self._id_blob, self._id_off, *piece[:8],
                                str(self.chr), *piece[8:])
        if buf is None:
            raise RuntimeError(
                f"native IBD formatter returned no output for "
                f"{len(piece[0])} records")
        return buf

    def _write_loop(self):
        """The members in chunk order, up to None; after an error, the
        chunks left are still taken (and dropped) so that close() does
        not hang."""
        while (fut := self._q.get()) is not None:
            try:
                if self._err is None:
                    self._raw.write(fut.result())
                    self.spans.add(CHUNKS)
            except BaseException as e:      # raised on the main thread
                if self._err is None:
                    self._err = e

    def _format_py(self, ind1, hap1, ind2, hap2, pos_start, pos_end,
                   length_cm, score, post_est, map_est) -> bytes:
        """The records' text without the native library."""
        fam, iid, ch = self.fam, self.iid, str(self.chr)
        out = []
        for j in range(len(ind1)):
            i1 = ind1[j]
            i2 = ind2[j]
            parts = [fam[i1], iid[i1], str(hap1[j]), fam[i2], iid[i2],
                     str(hap2[j]), ch, str(pos_start[j]), str(pos_end[j])]
            if length_cm is not None:
                parts.append("%.7g" % length_cm[j])
            parts.append("%.7g" % score[j])
            if post_est is not None:
                parts.append("%.7g" % post_est[j])
            if map_est is not None:
                parts.append("%.7g" % map_est[j])
            out.append("\t".join(parts) + "\n")
        return "".join(out).encode()

    def write_block(self, ind1, hap1, ind2, hap2, pos_start, pos_end,
                    length_cm, score, post_est=None, map_est=None) -> None:
        """Bulk write from column arrays, one record per row, in order
        after every block written before.
        ``length_cm`` / ``post_est`` / ``map_est`` may be None (column
        omitted) or float32 arrays; ``score`` is float64 (matching the
        per-record float division). The column arrays must not change
        until ``close()``: the workers read them."""
        n = len(ind1)
        if n == 0:
            return
        if self._err is not None:
            raise self._err
        has_lib = native.get_lib() is not None
        if has_lib and self._id_blob is None:
            off = [0]
            blob = bytearray()
            for f_, i_ in zip(self.fam, self.iid):
                blob += f"{f_}\t{i_}".encode() + b"\0"
                off.append(len(blob))
            self._id_blob = bytes(blob)
            self._id_off = np.asarray(off, np.int32)
        cols = (ind1, hap1, ind2, hap2, pos_start, pos_end, length_cm,
                score, post_est, map_est)
        a = 0
        while a < n:
            if not self._chunk:
                self._chunk_parent = self.spans.current()
            b = min(n, a + CHUNK_RECORDS - self._chunk_n)
            piece = tuple(None if c is None else c[a:b] for c in cols)
            self._chunk.append(piece if has_lib else self._format_py(*piece))
            self._chunk_n += b - a
            a = b
            if self._chunk_n == CHUNK_RECORDS:
                self._submit()
        self.n_written += n

    def _submit(self):
        """Queue the chunk being filled."""
        chunk, parent = self._chunk, self._chunk_parent
        self._chunk, self._chunk_n = [], 0
        self._q.put(self._pool.submit(parent, chunk))

    def close(self):
        """Write every queued chunk and the one being filled, stop the
        threads and close the file; raise a worker's error, if one had
        one."""
        if self._chunk and self._err is None:
            self._submit()
        self._q.put(None)
        self._thr.join()
        self._pool.shutdown()
        if not self._append and self._raw.tell() == 0 and self._err is None:
            # no record: still a gzip file, as the reference's empty one
            self._raw.write(_gzip_member(b""))
        self._raw.close()
        if self._err is not None:
            raise self._err


class IbdBinaryWriter:
    """Binary ``.bibd.gz`` writer (HMM.cpp:383-401, 1146-1176)."""

    def __init__(self, path: str, fam_ids: List[str], iids: List[str],
                 chr_number: int, has_length: bool, has_post: bool,
                 has_map: bool, append: bool = False,
                 spans: Optional[SpanRecorder] = None):
        self._f = gzip.open(path, "ab" if append else "wb",
                            compresslevel=6)
        self.spans = spans if spans is not None else SpanRecorder()
        self.has_length = has_length
        self.has_post = has_post
        self.has_map = has_map
        self.n_written = 0
        if append:
            return  # header was written by the original run
        f = self._f
        f.write(struct.pack("<???i", has_length, has_post, has_map,
                            chr_number))
        f.write(struct.pack("<I", len(fam_ids)))
        for fam, iid in zip(fam_ids, iids):
            fb = fam.encode()
            ib = iid.encode()
            f.write(struct.pack("<I", len(fb)))
            f.write(fb)
            f.write(struct.pack("<I", len(ib)))
            f.write(ib)

    def write_block(self, ind1, hap1, ind2, hap2, pos_start, pos_end,
                    length_cm, score, post_est=None, map_est=None) -> None:
        """Bulk write from column arrays: one packed numpy record dtype,
        the reference's record layout (HMM.cpp:1146-1176)."""
        n = len(ind1)
        if n == 0:
            return
        fields = [("i1", "<u4"), ("h1", "u1"), ("i2", "<u4"), ("h2", "u1"),
                  ("s", "<i4"), ("e", "<i4")]
        if self.has_length:
            fields.append(("len", "<f4"))
        fields.append(("score", "<f4"))
        if self.has_post:
            fields.append(("post", "<f4"))
        if self.has_map:
            fields.append(("map", "<f4"))
        with self.spans.span(FORMAT):
            rec = np.empty(n, np.dtype(fields))  # list-of-tuples: packed
            rec["i1"] = ind1
            rec["h1"] = hap1
            rec["i2"] = ind2
            rec["h2"] = hap2
            rec["s"] = pos_start
            rec["e"] = pos_end
            if self.has_length:
                rec["len"] = np.asarray(length_cm, np.float32)
            rec["score"] = np.asarray(score, np.float32)
            if self.has_post:
                rec["post"] = np.asarray(post_est, np.float32)
            if self.has_map:
                rec["map"] = np.asarray(map_est, np.float32)
        with self.spans.span(DEFLATE):
            self._f.write(rec.tobytes())
        self.n_written += n

    def close(self):
        self._f.close()


def _alias(field: str) -> property:
    """A read/write property under another name for dataclass ``field``."""
    return property(lambda self: getattr(self, field),
                    lambda self, value: setattr(self, field, value))


@dataclasses.dataclass
class IbdPairDataLine:
    """Mirror of BinaryDataReader.hpp:18-61, with the reference module's
    camelCase spellings of its fields and ``toString`` (pybind.cpp:181-195;
    "chromosome" already matches)."""
    ind1_fam_id: str
    ind1_id: str
    ind1_hap: int
    ind2_fam_id: str
    ind2_id: str
    ind2_hap: int
    chromosome: int
    ibd_start: int
    ibd_end: int
    length_cm: float = -1.0
    score: float = -1.0
    post_est: float = -1.0
    map_est: float = -1.0

    def to_string(self) -> str:
        parts = [self.ind1_fam_id, self.ind1_id, str(self.ind1_hap),
                 self.ind2_fam_id, self.ind2_id, str(self.ind2_hap),
                 str(self.chromosome), str(self.ibd_start), str(self.ibd_end)]
        if self.length_cm != -1.0:
            parts.append(fmt_float(self.length_cm))
        parts.append(fmt_float(self.score))
        if self.post_est != -1.0:
            parts.append(fmt_float(self.post_est))
        if self.map_est != -1.0:
            parts.append(fmt_float(self.map_est))
        return "\t".join(parts)

    toString = to_string
    ind1FamId = _alias("ind1_fam_id")
    ind1Id = _alias("ind1_id")
    ind1Hap = _alias("ind1_hap")
    ind2FamId = _alias("ind2_fam_id")
    ind2Id = _alias("ind2_id")
    ind2Hap = _alias("ind2_hap")
    ibdStart = _alias("ibd_start")
    ibdEnd = _alias("ibd_end")
    lengthInCentimorgans = _alias("length_cm")
    ibdScore = _alias("score")
    postEst = _alias("post_est")
    mapEst = _alias("map_est")


class BinaryDataReader:
    """Reader for ``.bibd.gz`` (BinaryDataReader.hpp:64-185): the header on
    construction, then one :class:`IbdPairDataLine` per record."""

    def __init__(self, path: str):
        self._f = gzip.open(path, "rb")
        hdr = self._f.read(3 + 4)
        self.has_length, self.has_post, self.has_map = (
            bool(hdr[0]), bool(hdr[1]), bool(hdr[2]))
        self.chr_number = struct.unpack("<i", hdr[3:7])[0]
        (n_ids,) = struct.unpack("<I", self._f.read(4))
        self.fam_ids = []
        self.iids = []
        for _ in range(n_ids):
            (lf,) = struct.unpack("<I", self._f.read(4))
            self.fam_ids.append(self._f.read(lf).decode())
            (li,) = struct.unpack("<I", self._f.read(4))
            self.iids.append(self._f.read(li).decode())

    def __iter__(self):
        while True:
            head = self._f.read(4)
            if len(head) < 4:
                return
            (ind1,) = struct.unpack("<I", head)
            hap1, = struct.unpack("<B", self._f.read(1))
            ind2, = struct.unpack("<I", self._f.read(4))
            hap2, = struct.unpack("<B", self._f.read(1))
            start, end = struct.unpack("<ii", self._f.read(8))
            line = IbdPairDataLine(
                ind1_fam_id=self.fam_ids[ind1], ind1_id=self.iids[ind1],
                ind1_hap=hap1,
                ind2_fam_id=self.fam_ids[ind2], ind2_id=self.iids[ind2],
                ind2_hap=hap2,
                chromosome=self.chr_number, ibd_start=start, ibd_end=end)
            if self.has_length:
                (line.length_cm,) = struct.unpack("<f", self._f.read(4))
            (line.score,) = struct.unpack("<f", self._f.read(4))
            if self.has_post:
                (line.post_est,) = struct.unpack("<f", self._f.read(4))
            if self.has_map:
                (line.map_est,) = struct.unpack("<f", self._f.read(4))
            yield line

    def close(self) -> None:
        self._f.close()


# ---------------------------------------------------------------------------
# posterior sum matrices (main.cpp:119-167)
# ---------------------------------------------------------------------------

def read_expected_times_from_intervals_file(path: str) -> np.ndarray:
    """Parse an ``.intervalsInfo``-style file into expected coalescent times.

    Mirrors ``readExpectedTimesFromIntervalsFile`` (HMM.cpp:40-61): each line
    is "intervalStart expectedCoalescentTime intervalEnd"; the middle column
    is kept (float32).
    """
    opener = gzip.open if path.endswith(".gz") else open
    times = []
    with opener(path, "rt") as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if len(parts) != 3:
                raise ValueError(
                    f"{path} should have \"intervalStart\t"
                    f"expectedCoalescentTime\tintervalEnd\" at each line.")
            times.append(np.float32(parts[1]))
    return np.asarray(times, np.float32)


class PerPairStreamWriter:
    """Streaming gzip writer for ``.perPairPosteriorMeans.gz`` /
    ``.perPairMAP.gz`` (HMM.cpp:258-271, 1414-1419).

    One row per decoded pair, space-separated, Eigen FullPrecision float
    formatting (max_digits10 == 9 for float). The reference's Eigen format
    uses "\\n" as the row separator with no terminator, which concatenates
    the last row of one batch with the first row of the next; we terminate
    every row (deliberate, documented fix — files stay line-parseable).
    """

    def __init__(self, path: str, integers: bool = False):
        self._f = gzip.open(path, "wt")
        self._int = integers

    def write_rows(self, mat: np.ndarray) -> None:
        for row in mat:
            if self._int:
                self._f.write(" ".join(str(int(v)) for v in row))
            else:
                self._f.write(" ".join("%.9g" % float(v) for v in row))
            self._f.write("\n")

    def close(self) -> None:
        self._f.close()


def _eigen_tab_format(mat: np.ndarray) -> str:
    # Eigen StreamPrecision default-float (like %g with precision 6... Eigen
    # StreamPrecision uses the stream default precision 6); reference uses
    # the stream's default operator<< on floats.
    lines = []
    for row in mat:
        lines.append("\t".join("%.6g" % float(v) for v in row))
    return "\n".join(lines)


def write_sums_files(mats: Dict[str, np.ndarray],
                     spans: Optional[SpanRecorder] = None) -> int:
    """Write each ``{path: matrix}`` as a ``.sumOverPairs.gz`` file: the
    matrix's rows in Eigen tab format (main.cpp:119-167), as a series of
    complete gzip members of SUMS_CHUNK_ROWS rows each, in row order.

    Every file's chunks go at once to one :class:`_MemberPool` (the
    native formatter, or the Python "%.6g" loop: the same bytes); each
    file is written whole once its members are done, so a chunk's failure
    raises, names the file, and leaves no part of it written. No rows
    give one member of "\\n", the single-stream writer's text. In
    ``spans``: the FORMAT and DEFLATE spans, with the caller's open span
    as parent, and the members and native chunks counters. Returns W."""
    spans = spans if spans is not None else SpanRecorder()
    parent = spans.current()
    use_native = native.get_lib() is not None

    def fmt(piece) -> bytes:
        path, r0, block = piece
        if not use_native:
            return (_eigen_tab_format(block) + "\n").encode()
        text = native.format_sums(block)
        if text is None:
            raise RuntimeError(
                f"native sums formatter returned no output for rows "
                f"{r0}-{r0 + len(block)} of {path}")
        spans.add(SUMS_NATIVE_CHUNKS)
        return text

    n = SUMS_CHUNK_ROWS
    pool = _MemberPool("asmc-sums", spans, fmt, SUMS_FORMAT, SUMS_DEFLATE)
    try:
        futures = {path: [pool.submit(parent, [(path, r0, m[r0:r0 + n])])
                          for r0 in range(0, len(m), n)]
                   for path, m in mats.items()}
        for path, fs in futures.items():
            members = [f.result() for f in fs] or [_gzip_member(b"\n")]
            with open(path, "wb") as fh:
                fh.writelines(members)
            spans.add(SUMS_MEMBERS, len(members))
    finally:
        pool.shutdown(cancel=True)
    return pool.workers


def write_sum_over_pairs(path: str, mat: np.ndarray) -> None:
    write_sums_files({path: mat})


def major_minor_files(out_root: str, sums00: np.ndarray, sums01: np.ndarray,
                      sums11: np.ndarray, flipped: np.ndarray
                      ) -> Dict[str, np.ndarray]:
    """main.cpp:126-165: the three major/minor files' paths and matrices;
    00/11 matrices swap rows where the site was flipped during
    minor-allele folding."""
    m00 = np.where(flipped[:, None], sums11, sums00)
    m11 = np.where(flipped[:, None], sums00, sums11)
    return {out_root + ".00.sumOverPairs.gz": m00,
            out_root + ".01.sumOverPairs.gz": sums01,
            out_root + ".11.sumOverPairs.gz": m11}


def write_major_minor_sums(out_root: str, sums00: np.ndarray,
                           sums01: np.ndarray, sums11: np.ndarray,
                           flipped: np.ndarray) -> None:
    """main.cpp:126-165: 00/11 matrices swap rows where the site was flipped
    during minor-allele folding."""
    write_sums_files(major_minor_files(out_root, sums00, sums01, sums11,
                                       flipped))
