"""Build the CUDA kernels with nvcc and bind them with ctypes.

The sources under ``fastsmc_tpu_torch/csrc/`` compile at first use into
one shared library with a plain C interface, under ``build/fastsmc_tpu_torch/``
at the repository root, keyed by a hash of the sources and flags (a changed
source builds a new library; an unchanged one is reused). A failed build
raises: there is no fallback.
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
SOURCES = ("hmm_forward.cu", "hmm_backward.cu")
HEADERS = ("hmm_common.cuh",)
BUILD_DIR = _PKG.parent / "build" / "fastsmc_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = {
    # Mf, G, em, obs, isp, ops, mask, alpha, T, P, KP, device, stream
    "fastsmc_hmm_forward": [_P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                            _P],
    # Mb, G, em, obs, alpha, ops, mask, post, th, T, P, K, KP,
    # state_threshold, device, stream
    "fastsmc_hmm_backward": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                             _I, _I, _I, _P],
}


@dataclasses.dataclass
class BuildInfo:
    path: Path        # the shared library
    seconds: float    # nvcc wall time, 0.0 when the library was reused
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
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(CSRC / s) for s in SOURCES)]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True, cwd=str(CSRC))
    seconds = time.perf_counter() - t0
    log = r.stdout + r.stderr
    if r.returncode != 0 or not tmp.exists():
        raise BuildError(f"nvcc failed ({r.returncode}):\n{log}")
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
