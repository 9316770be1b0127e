"""Build CUDA libraries with nvcc and bind them with ctypes.

A :class:`Library` names its sources and headers under
``fastsmc_tpu_torch/csrc/`` and its C signatures. Its sources compile at
first use, one ``nvcc`` per source started together, and link into one
shared library with a plain C interface, under ``build/fastsmc_tpu_torch/``
at the repository root, keyed by a hash of its own sources and headers and
the flags (a changed source builds a new library; an unchanged one is
reused). A failed build raises: there is no fallback. :func:`build` and
:func:`load_library` take the decode kernels' library, :data:`DECODE`,
unless given another (a probe's).
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Tuple

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "fastsmc_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True, eq=False)
class Library:
    """A shared library: ``stem`` names its file; ``sources``, each
    compiled by its own ``nvcc``, and ``headers`` are under :data:`CSRC`;
    ``argtypes`` gives each entry point's C arguments (each returns an
    int)."""
    stem: str
    sources: Tuple[str, ...]
    headers: Tuple[str, ...]
    argtypes: Dict[str, list]


_P = ctypes.c_void_p
_I = ctypes.c_int
DECODE = Library("libfastsmc_kernels",
                 ("hmm_forward.cu", "hmm_backward.cu", "hmm_reduce.cu"),
                 ("hmm_common.cuh",), {
    # Mf (exact: hi), Mlo, profile, G, em, obs, isp, ops, rops, hem, mask,
    # alpha, T, P, KP, device, stream
    "fastsmc_hmm_forward": [_P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                            _I, _I, _I, _I, _P],
    # Mb, profile, G, em, obs, alpha, ops, rops, hem, mask, exp_times, post,
    # th, mean, map, psum, mm, T, P, K, KP, state_threshold, device, stream
    "fastsmc_hmm_backward": [_P, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                             _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # part, out, nblk, E, device, stream
    "fastsmc_block_reduce": [_P, _P, _I, ctypes.c_int64, _I, _P]})


@dataclasses.dataclass
class BuildInfo:
    path: Path        # the shared library
    seconds: float    # nvcc wall time (compile + link), 0.0 when reused
    log: str          # nvcc's output (ptxas registers / shared memory)


class BuildError(RuntimeError):
    pass


_lock = threading.Lock()
_info: Dict[str, BuildInfo] = {}      # by stem
_lib: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if not CUDA_HOME:
        raise BuildError("no CUDA toolkit found (set CUDA_HOME)")
    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise BuildError(f"nvcc not found at {nvcc}")
    return nvcc


def digest(library: Library) -> str:
    """The key of ``library``'s file: a hash of the flags and of each of
    its sources and headers, by name and contents."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in library.sources + library.headers:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build(library: Library = DECODE) -> BuildInfo:
    """Compile ``library`` unless a library of these sources exists."""
    with _lock:
        if library.stem not in _info:
            _info[library.stem] = _build_locked(library)
        return _info[library.stem]


def _build_locked(library: Library) -> BuildInfo:
    sources = library.sources
    lib = BUILD_DIR / f"{library.stem}.{digest(library)}.so"
    if lib.exists():
        return BuildInfo(lib, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{lib.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{Path(s).stem}.o" for s in sources]
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    try:
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(CSRC / s),
                                   "-o", str(o)], cwd=str(CSRC), text=True,
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT)
                 for s, o in zip(sources, objs)]
        log = "".join(p.communicate()[0] for p in procs)
        failed = [s for s, p in zip(sources, procs) if p.returncode != 0]
        if failed:
            raise BuildError(f"nvcc failed on {failed}:\n{log}")
        r = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                            *map(str, objs)], capture_output=True, text=True,
                           cwd=str(CSRC))
        log += r.stdout + r.stderr
        if r.returncode != 0 or not tmp.exists():
            raise BuildError(f"nvcc link failed ({r.returncode}):\n{log}")
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    os.replace(tmp, lib)
    return BuildInfo(lib, seconds, log)


def load_library(library: Library = DECODE) -> ctypes.CDLL:
    """``library``, built on first use, with its C signatures."""
    info = build(library)
    with _lock:
        if library.stem not in _lib:
            lib = ctypes.CDLL(str(info.path))
            for name, argtypes in library.argtypes.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib[library.stem] = lib
        return _lib[library.stem]
