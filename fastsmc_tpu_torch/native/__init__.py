"""Native (C++) host components, loaded with ctypes.

The port's copy of ``fastsmc_tpu/native/``: ``fastsmc_native.cpp`` (the
undistinguished-count sampler, the GERMLINE2 scan, the IBD record formatter
and the posterior-sums formatter) is compiled with the system's ``g++`` at
first use into ``build/fastsmc_tpu_torch/native/`` at the repository root,
keyed by a hash of the source, the flags and the host's CPU (a changed
source, or a ``build/`` carried to another CPU, builds a new library:
``-march=native`` code may not run there; an unchanged one is reused).
Every entry point has a pure-Python fallback (``utils/cxx_rng.py``,
``hashing/germline.py``, the writers), so the package works without a
compiler; :func:`get_lib` returns None then.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).resolve().parent / "fastsmc_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / \
    "fastsmc_tpu_torch" / "native"
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _cpu_identity() -> str:
    """The machine, and the CPU's model and feature flags where
    ``/proc/cpuinfo`` gives them: what ``-march=native`` compiles for."""
    ident = [platform.machine(), platform.processor()]
    try:
        with open("/proc/cpuinfo") as fh:
            seen = set()
            for line in fh:
                key = line.split(":", 1)[0].strip()
                if key in ("model name", "flags", "Features") \
                        and key not in seen:
                    seen.add(key)
                    ident.append(line.strip())
    except OSError:
        pass
    return "\n".join(ident)


def library_path() -> Path:
    """Where the library of this source, these flags and this CPU is
    built."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(_cpu_identity().encode())
    h.update(_SRC.read_bytes())
    return BUILD_DIR / f"libfastsmc_native.{h.hexdigest()[:16]}.so"


def _compile(lib_path: Path) -> bool:
    """g++ into a temporary name, then an atomic rename: concurrent
    processes may build the same library."""
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, str(_SRC), "-o", str(tmp)]
    try:
        r = subprocess.run(cmd, capture_output=True, timeout=300)
        if r.returncode != 0 or not tmp.exists():
            return False
        os.replace(tmp, lib_path)
        return True
    except Exception:
        return False
    finally:
        tmp.unlink(missing_ok=True)


def get_lib() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            lib_path = library_path()
        except OSError:
            # the source is absent (a package installed without it)
            return None
        if not lib_path.exists() and not _compile(lib_path):
            return None
        try:
            lib = ctypes.CDLL(str(lib_path))
        except OSError:
            return None

        lib.fastsmc_undistinguished.restype = ctypes.c_int
        lib.fastsmc_undistinguished.argtypes = [
            ctypes.c_long,
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            ctypes.c_int, ctypes.c_int, ctypes.c_uint,
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        ]
        lib.fastsmc_hash_scan.restype = ctypes.c_long
        lib.fastsmc_hash_scan.argtypes = [
            np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS"),
            ctypes.c_int, ctypes.c_int,
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_int,
            ctypes.c_double,
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            ctypes.c_long, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_double,
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            ctypes.c_long,
        ]
        _scan_params = [
            np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS"),
            ctypes.c_int, ctypes.c_int,
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_int,
            ctypes.c_double,
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            ctypes.c_long, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_double,
        ]
        lib.fastsmc_scan_create.restype = ctypes.c_void_p
        lib.fastsmc_scan_create.argtypes = _scan_params
        lib.fastsmc_scan_words.restype = ctypes.c_long
        lib.fastsmc_scan_words.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                           ctypes.c_int]
        lib.fastsmc_scan_finish.restype = ctypes.c_long
        lib.fastsmc_scan_finish.argtypes = [ctypes.c_void_p]
        lib.fastsmc_scan_take.restype = ctypes.c_long
        lib.fastsmc_scan_take.argtypes = [
            ctypes.c_void_p,
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            ctypes.c_long,
        ]
        lib.fastsmc_scan_destroy.restype = None
        lib.fastsmc_scan_destroy.argtypes = [ctypes.c_void_p]
        lib.fastsmc_format_ibd.restype = ctypes.c_long
        lib.fastsmc_format_ibd.argtypes = [
            ctypes.c_long, ctypes.c_char_p,
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            ctypes.c_int,
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            ctypes.c_int,
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            ctypes.c_int,
            ctypes.c_char_p,
            np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
            ctypes.c_long,
        ]
        lib.fastsmc_format_sums.restype = ctypes.c_long
        lib.fastsmc_format_sums.argtypes = [
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            ctypes.c_long, ctypes.c_long,
            np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
            ctypes.c_long,
        ]
        _lib = lib
        return _lib


def undistinguished_counts(derived: np.ndarray, total: np.ndarray,
                           csfs_samples: int, fold: bool,
                           seed: int) -> Optional[np.ndarray]:
    """Native undistinguished-count sampling; None if the library is
    unavailable (caller falls back to the Python implementation)."""
    lib = get_lib()
    if lib is None:
        return None
    sites = len(derived)
    out = np.empty((sites, 3), dtype=np.int32)
    rc = lib.fastsmc_undistinguished(
        sites, np.ascontiguousarray(derived, np.int32),
        np.ascontiguousarray(total, np.int32),
        int(csfs_samples), int(bool(fold)), int(seed) & 0xFFFFFFFF, out)
    if rc != 0:
        return None
    return out


def format_ibd(id_blob: bytes, id_off: np.ndarray, ind1, hap1, ind2, hap2,
               pos_start, pos_end, length_cm, score,
               chr_str: str, post_est=None, map_est=None) -> Optional[bytes]:
    """Bulk-format IBD text records (byte-identical to the per-record
    Python path); None if the library is unavailable. ``length_cm``,
    ``post_est`` and ``map_est`` may be None (column omitted)."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(ind1)
    has_len = length_cm is not None
    if not has_len:
        length_cm = np.zeros(0, np.float32)
    has_post = post_est is not None
    has_map = map_est is not None
    if not has_post:
        post_est = np.zeros(0, np.float32)
    if not has_map:
        map_est = np.zeros(0, np.float32)
    # 320 bytes/record covers any numeric payload; size the headroom from
    # the longest id pair so oversized sample ids can never truncate
    # (the C side additionally returns -1 on any truncation)
    max_id = int(np.diff(np.ascontiguousarray(id_off, np.int64)).max()) \
        if len(id_off) > 1 else len(id_blob)
    cap = (320 + 2 * max_id) * max(n, 1)
    out = np.empty(cap, np.uint8)
    w = lib.fastsmc_format_ibd(
        n, id_blob, np.ascontiguousarray(id_off, np.int32),
        np.ascontiguousarray(ind1, np.int32),
        np.ascontiguousarray(hap1, np.int32),
        np.ascontiguousarray(ind2, np.int32),
        np.ascontiguousarray(hap2, np.int32),
        np.ascontiguousarray(pos_start, np.int64),
        np.ascontiguousarray(pos_end, np.int64),
        np.ascontiguousarray(length_cm, np.float32), int(has_len),
        np.ascontiguousarray(score, np.float64),
        np.ascontiguousarray(post_est, np.float32), int(has_post),
        np.ascontiguousarray(map_est, np.float32), int(has_map),
        chr_str.encode(), out, cap)
    if w < 0 or w > cap:
        return None
    return out[:w].tobytes()


# the longest "%.6g" of a double ("-2.22507e-308") and its separator
SUMS_BYTES_PER_VALUE = 14


def format_sums(mat: np.ndarray) -> Optional[bytes]:
    """A matrix's rows as posterior-sums text: each value's "%.6g" (of the
    value as a double), tab-separated, a newline after every row; the
    bytes of the writers' Python fallback. None if the library is
    unavailable or its buffer was too small."""
    lib = get_lib()
    if lib is None:
        return None
    m = np.ascontiguousarray(mat, np.float64)
    rows, cols = m.shape
    cap = max(rows * (cols * SUMS_BYTES_PER_VALUE + 1), 1)
    out = np.empty(cap, np.uint8)
    w = lib.fastsmc_format_sums(m, rows, cols, out, cap)
    if w < 0 or w > cap:
        return None
    return out[:w].tobytes()


class NativeScan:
    """Chunked GERMLINE2 scan handle: scan word ranges incrementally so a
    producer thread can stay inside the GIL-releasing C calls while the
    main thread validates the previous chunk's candidates. The carried
    extend-hash state makes the chunked stream identical (same matches,
    same order) to the single-shot :func:`hash_scan`.

    Only the creating thread may call :meth:`scan_words` / :meth:`finish`
    / :meth:`take` (the handle is not thread-safe)."""

    def __init__(self, lib, handle, refs):
        self._lib = lib
        self._h = handle
        self._refs = refs      # keep words/id_num/gpos alive

    @classmethod
    def create(cls, words: np.ndarray, id_num: np.ndarray, *, haploid: bool,
               windows, min_m: float, genetic_positions: np.ndarray,
               word_size: int, read_ahead: int, gap: int, max_seeds: int,
               skip: float) -> Optional["NativeScan"]:
        lib = get_lib()
        if lib is None or not hasattr(lib, "fastsmc_scan_create"):
            return None
        n_haps, n_words = words.shape
        gpos = np.ascontiguousarray(genetic_positions, np.float32)
        idn = np.ascontiguousarray(id_num, np.int64)
        w = np.ascontiguousarray(words, np.uint64)
        if windows is not None:
            args = (1, windows.jobs, windows.job_ind, windows.w_i,
                    windows.w_j, windows.window_size,
                    int(windows.is_j_above_diag))
        else:
            args = (0, 1, 1, 1, 1, 0, 0)
        h = lib.fastsmc_scan_create(
            w, n_haps, n_words, idn, int(bool(haploid)), args[0], args[1],
            args[2], args[3], args[4], args[5], args[6], float(min_m), gpos,
            len(gpos), int(word_size), int(read_ahead), int(gap),
            int(max_seeds), float(skip))
        if not h:
            return None
        return cls(lib, h, (w, idn, gpos))

    def scan_words(self, w_begin: int, w_end: int) -> int:
        """Scan [w_begin, w_end); returns matches accumulated so far."""
        return self._lib.fastsmc_scan_words(self._h, int(w_begin),
                                            int(w_end))

    def finish(self) -> int:
        """Flush all still-active matches (end of panel)."""
        return self._lib.fastsmc_scan_finish(self._h)

    def take(self) -> tuple:
        """Copy out + clear the accumulated (id1, id2, from, to) arrays."""
        cap = 65536
        while True:
            out1 = np.empty(cap, np.int32)
            out2 = np.empty(cap, np.int32)
            outf = np.empty(cap, np.int64)
            outt = np.empty(cap, np.int64)
            n = self._lib.fastsmc_scan_take(self._h, out1, out2, outf, outt,
                                            cap)
            if n >= 0:
                return out1[:n], out2[:n], outf[:n], outt[:n]
            cap *= 4

    def destroy(self) -> None:
        if self._h:
            self._lib.fastsmc_scan_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.destroy()
        except Exception:
            pass


def hash_scan(words: np.ndarray, id_num: np.ndarray, *, haploid: bool,
              windows, min_m: float, genetic_positions: np.ndarray,
              word_size: int, read_ahead: int, gap: int, max_seeds: int,
              skip: float) -> Optional[tuple]:
    """Native GERMLINE2 scan. Returns (id1, id2, from, to) int arrays or
    None when the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n_haps, n_words = words.shape
    cap = max(65536, n_haps * 64)
    gpos = np.ascontiguousarray(genetic_positions, np.float32)
    idn = np.ascontiguousarray(id_num, np.int64)
    w = np.ascontiguousarray(words, np.uint64)
    while True:
        out1 = np.empty(cap, np.int32)
        out2 = np.empty(cap, np.int32)
        outf = np.empty(cap, np.int64)
        outt = np.empty(cap, np.int64)
        if windows is not None:
            args = (1, windows.jobs, windows.job_ind, windows.w_i,
                    windows.w_j, windows.window_size,
                    int(windows.is_j_above_diag))
        else:
            args = (0, 1, 1, 1, 1, 0, 0)
        n = lib.fastsmc_hash_scan(
            w, n_haps, n_words, idn, int(bool(haploid)), args[0], args[1],
            args[2], args[3], args[4], args[5], args[6], float(min_m), gpos,
            len(gpos), int(word_size), int(read_ahead), int(gap),
            int(max_seeds), float(skip), out1, out2, outf, outt, cap)
        if n >= 0:
            return out1[:n].copy(), out2[:n].copy(), outf[:n].copy(), \
                outt[:n].copy()
        cap *= 4
