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

One fault of the JAX package's text writer is repaired here: when the
native formatter returns ``None`` (its C side refuses a truncated buffer)
the writer thread there fails on ``write(None)`` and exits with items still
queued, so the next ``Queue.join()`` never returns. This writer names the
formatter's failure, keeps marking the items left after an error as done,
and raises the error from ``close()`` instead of hanging.
"""

from __future__ import annotations

import dataclasses
import gzip
import queue
import struct
import threading
from typing import List, Optional

import numpy as np

from .. import native
from ..utils.timer import SpanRecorder

# the IBD writers' spans: records formatted, and their bytes deflated
FORMAT = "fastsmc.writer.format"
DEFLATE = "fastsmc.writer.deflate"


def fmt_float(x) -> str:
    """C++ ostream default-float with precision 7 (== printf %.7g)."""
    return "%.7g" % float(x)


class IbdTextWriter:
    """Streaming text IBD writer (HMM.cpp:1114-1144).

    Bulk writes are formatted and deflated on a background thread
    (``threaded=True``): both the native formatter and zlib release the
    GIL, so the thread overlaps them with the device work the main thread
    waits on. Byte order is preserved (a single FIFO queue; the Python
    fallback and close() drain the queue first). The formatter's and
    deflate's time goes to ``spans`` as FORMAT and DEFLATE spans; on the
    thread their parent is the span that queued the block."""

    def __init__(self, path: str, fam_ids: List[str], iids: List[str],
                 chr_number: int, append: bool = False,
                 threaded: bool = True,
                 spans: Optional[SpanRecorder] = None):
        # compresslevel 6 = the zlib default the reference's gzofstream uses
        # (Python's gzip defaults to 9, ~3x slower deflate — it was ~7 s
        # of the 98k-hap e2e output phase for a 2% size difference)
        self._f = gzip.open(path, "at" if append else "wt", compresslevel=6)
        self.fam = fam_ids
        self.iid = iids
        self.chr = chr_number
        self.n_written = 0
        self._id_blob = None          # lazy native-formatter id table
        self._id_off = None
        self._text_dirty = False      # text-wrapper bytes pending flush
        # the formatter's and gzip's deflate spans (FORMAT, DEFLATE)
        self.spans = spans if spans is not None else SpanRecorder()
        self._q = None
        self._thr = None
        self._thr_err = None
        if threaded:
            self._q = queue.Queue(maxsize=64)
            self._thr = threading.Thread(target=self._deflate_loop,
                                         name="fastsmc-deflate",
                                         daemon=True)
            self._thr.start()

    @property
    def fmt_s(self) -> float:
        """Seconds in the formatter, the total of the recorder's FORMAT
        spans (with a recorder shared across writers, of all of them)."""
        return self.spans.total_s(FORMAT)

    @property
    def deflate_s(self) -> float:
        """Seconds in gzip's deflate, the total of the DEFLATE spans."""
        return self.spans.total_s(DEFLATE)

    def _deflate_loop(self):
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                if self._thr_err is not None:
                    continue            # after an error: drop, still done
                # deferred bulk format: ctypes releases the GIL, so
                # formatting joins deflate on this thread; the spans' parent
                # is the span that queued the block
                parent, cols = item
                with self.spans.span(FORMAT, parent):
                    buf = native.format_ibd(self._id_blob, self._id_off,
                                            *cols[:8], str(self.chr),
                                            *cols[8:])
                if buf is None:
                    raise RuntimeError(
                        f"native IBD formatter returned no output for a "
                        f"block of {len(cols[0])} records")
                with self.spans.span(DEFLATE, parent):
                    self._f.buffer.write(buf)
            except BaseException as e:      # raised on the main thread
                self._thr_err = e
            finally:
                self._q.task_done()

    def _sync_q(self):
        """Drain queued bulk writes (ordering barrier before a direct text
        write)."""
        if self._q is not None:
            self._q.join()
            if self._thr_err is not None:
                raise self._thr_err

    def write_block(self, ind1, hap1, ind2, hap2, pos_start, pos_end,
                    length_cm, score, post_est=None, map_est=None) -> None:
        """Bulk write from column arrays, one record per row. Uses the
        native C formatter when available (the same "%.7g" printf as the
        Python fallback).
        ``length_cm`` / ``post_est`` / ``map_est`` may be None (column
        omitted) or float32 arrays; ``score`` is float64 (matching the
        per-record float division)."""
        n = len(ind1)
        if n == 0:
            return
        if native.get_lib() is not None:
            if self._id_blob is None:
                off = [0]
                blob = bytearray()
                for f_, i_ in zip(self.fam, self.iid):
                    blob += f"{f_}\t{i_}".encode() + b"\0"
                    off.append(len(blob))
                self._id_blob = bytes(blob)
                self._id_off = np.asarray(off, np.int32)
            if self._text_dirty:
                # order text-wrapper bytes before ours; skipping the flush
                # when clean avoids a Z_SYNC_FLUSH per flushed batch
                self._f.flush()
                self._text_dirty = False
            if self._q is not None:
                # format AND deflate on the writer thread (both release
                # the GIL); the column arrays are never mutated after
                # emit, so referencing them is safe. FIFO order with
                # direct writes is preserved by _sync_q.
                if self._thr_err is not None:
                    raise self._thr_err
                self._q.put((self.spans.current(),
                             (ind1, hap1, ind2, hap2, pos_start, pos_end,
                              length_cm, score, post_est, map_est)))
                self.n_written += n
                return
            with self.spans.span(FORMAT):
                buf = native.format_ibd(self._id_blob, self._id_off, ind1,
                                        hap1, ind2, hap2, pos_start, pos_end,
                                        length_cm, score, str(self.chr),
                                        post_est, map_est)
            if buf is None:
                raise RuntimeError(f"native IBD formatter returned no "
                                   f"output for a block of {n} records")
            with self.spans.span(DEFLATE):
                self._f.buffer.write(buf)
            self.n_written += n
            return
        fam, iid, ch = self.fam, self.iid, str(self.chr)
        out = []
        has_len = length_cm is not None
        for j in range(n):
            i1 = ind1[j]
            i2 = ind2[j]
            parts = [fam[i1], iid[i1], str(hap1[j]), fam[i2], iid[i2],
                     str(hap2[j]), ch, str(pos_start[j]), str(pos_end[j])]
            if has_len:
                parts.append("%.7g" % length_cm[j])
            parts.append("%.7g" % score[j])
            if post_est is not None:
                parts.append("%.7g" % post_est[j])
            if map_est is not None:
                parts.append("%.7g" % map_est[j])
            out.append("\t".join(parts))
        self._sync_q()
        self._f.write("\n".join(out) + "\n")
        self.n_written += len(out)
        self._text_dirty = True

    def close(self):
        """Drain the queue, stop the thread and close the file; raise the
        writer thread's error, if it had one."""
        if self._q is not None:
            self._q.join()
            self._q.put(None)
            self._thr.join()
            self._q = None
        self._f.close()
        if self._thr_err is not None:
            raise self._thr_err


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


def write_sum_over_pairs(path: str, mat: np.ndarray) -> None:
    with gzip.open(path, "wt") as f:
        f.write(_eigen_tab_format(mat))
        f.write("\n")


def write_major_minor_sums(out_root: str, sums00: np.ndarray,
                           sums01: np.ndarray, sums11: np.ndarray,
                           flipped: np.ndarray) -> None:
    """main.cpp:126-165: 00/11 matrices swap rows where the site was flipped
    during minor-allele folding."""
    sites = sums00.shape[0]
    m00 = np.where(flipped[:, None], sums11, sums00)
    m11 = np.where(flipped[:, None], sums00, sums11)
    write_sum_over_pairs(out_root + ".00.sumOverPairs.gz", m00)
    write_sum_over_pairs(out_root + ".01.sumOverPairs.gz", sums01)
    write_sum_over_pairs(out_root + ".11.sumOverPairs.gz", m11)
