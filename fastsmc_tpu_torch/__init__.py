"""fastsmc_tpu_torch: the FastSMC main path in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper (sm_90a).

The JAX package ``fastsmc_tpu`` stays the reference. This package reuses
its host modules that never import JAX (configuration, panel and
decoding-quantities readers, emissions, dense operators, the GERMLINE2
scan, writers, timers) and owns everything that touches the device:
decode tables, the forward and backward+combine kernels, run extraction
and the FastSMC pipeline.

Entry point::

    from fastsmc_tpu_torch import DecodingParams, FastSMC
    FastSMC(params, device="cuda").run()
"""

import os

# ``fastsmc_tpu/__init__.py`` turns on JAX's compilation cache (importing
# JAX) unless this is set; the port must never import JAX.
os.environ.setdefault("FASTSMC_TPU_NO_CACHE", "1")

from fastsmc_tpu.config import DecodingParams  # noqa: E402,F401

from .pipelines.fastsmc import FastSMC  # noqa: E402,F401

__all__ = ["DecodingParams", "FastSMC"]
