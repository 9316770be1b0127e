"""fastsmc_tpu_torch: FastSMC and ASMC in PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper (sm_90a).

The JAX package ``fastsmc_tpu`` stays the reference; this package imports
nothing of it. It holds its own copies of the host modules it needs, under
the JAX package's paths and module names (``config``, ``io/``, ``native/``,
``hashing/germline.py``, ``utils/``, ``engine/{emissions,dense,oracle}.py``)
and owns everything that touches the device: decode tables, the forward,
backward+combine and block reduction kernels, run extraction, the FastSMC
and ASMC pipelines, their mesh over local devices and job tiles across
processes (``parallel/``), and the alpha-wall probe
(``probes/alpha_wall.py``). Over them sit the user-facing surfaces: the
command line (``cli.py``), the reference module's camelCase API
(``compat.py``), the model builder (``prepare/``, ``preparedecoding.py``)
and a walkthrough (``walkthrough.py``).

Entry points::

    from fastsmc_tpu_torch import ASMC, DecodingParams, FastSMC
    FastSMC(params, device="cuda").run()
    a = ASMC(params, device="cuda")
    a.write_outputs(a.decode_all_in_job())

    python -m fastsmc_tpu_torch.cli fastsmc|asmc|convert-binary|merge|prepare
"""

from .config import DecodingParams
from .pipelines.asmc import ASMC
from .pipelines.fastsmc import FastSMC

__all__ = ["ASMC", "DecodingParams", "FastSMC"]
