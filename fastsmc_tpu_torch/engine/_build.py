"""Build the CUDA kernels with nvcc and bind them with ctypes.

The sources under ``fastsmc_tpu_torch/csrc/`` compile at first use, one
``nvcc`` per source started together, and link into one shared library with
a plain C interface, under ``build/fastsmc_tpu_torch/`` at the repository
root, keyed by a hash of the sources and flags (a changed source builds a
new library; an unchanged one is reused). A failed build raises: there is
no fallback.
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
from typing import Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
SOURCES = ("hmm_forward.cu", "hmm_backward.cu", "hmm_reduce.cu",
           "alpha_wall.cu")
HEADERS = ("hmm_common.cuh",)
BUILD_DIR = _PKG.parent / "build" / "fastsmc_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = {
    # Mf (exact: hi), Mlo, profile, G, em, obs, isp, ops, rops, hem, mask,
    # alpha, T, P, KP, device, stream
    "fastsmc_hmm_forward": [_P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                            _I, _I, _I, _I, _P],
    # Mb, profile, G, em, obs, alpha, ops, rops, hem, mask, exp_times, post,
    # th, mean, map, psum, mm, T, P, K, KP, state_threshold, device, stream
    "fastsmc_hmm_backward": [_P, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                             _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # part, out, nblk, E, device, stream
    "fastsmc_block_reduce": [_P, _P, _I, ctypes.c_int64, _I, _P],
    # M, G, em, obs, isp, ops, alpha, T, P, KC, KA, S, store_every,
    # norm_block, device, stream
    "fastsmc_alpha_wall_forward": [_P, _I, _P, _P, _P, _P, _P, _I, _I, _I,
                                   _I, _I, _I, _I, _I, _P],
    # M, G, em, obs, alpha, ops, out, carry, carry_site, T, P, KC, KA, S,
    # read_every, norm_block, device, stream
    "fastsmc_alpha_wall_backward": [_P, _I, _P, _P, _P, _P, _P, _P, _I, _I,
                                    _I, _I, _I, _I, _I, _I, _I, _P],
}


@dataclasses.dataclass
class BuildInfo:
    path: Path        # the shared library
    seconds: float    # nvcc wall time (compile + link), 0.0 when reused
    log: str          # nvcc's output (ptxas registers / shared memory)


class BuildError(RuntimeError):
    pass


_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_info: Optional[BuildInfo] = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if not CUDA_HOME:
        raise BuildError("no CUDA toolkit found (set CUDA_HOME)")
    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise BuildError(f"nvcc not found at {nvcc}")
    return nvcc


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> BuildInfo:
    """Compile the kernels unless a library of these sources exists."""
    global _info
    with _lock:
        if _info is None:
            _info = _build_locked()
        return _info


def _build_locked() -> BuildInfo:
    lib = BUILD_DIR / f"libfastsmc_kernels.{_digest()}.so"
    if lib.exists():
        return BuildInfo(lib, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{lib.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{Path(s).stem}.o" for s in SOURCES]
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    try:
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(CSRC / s),
                                   "-o", str(o)], cwd=str(CSRC), text=True,
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT)
                 for s, o in zip(SOURCES, objs)]
        log = "".join(p.communicate()[0] for p in procs)
        failed = [s for s, p in zip(SOURCES, procs) if p.returncode != 0]
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


def load_library() -> ctypes.CDLL:
    """The kernels' library, built on first use, with its C signatures."""
    global _lib
    info = build()
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(info.path))
            for name, argtypes in _ARGTYPES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib
