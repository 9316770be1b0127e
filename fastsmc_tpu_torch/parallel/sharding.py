"""Pair-parallel decoding over the local devices of one process.

Counterpart of ``fastsmc_tpu/parallel/sharding.py``. There a single
controller runs ``shard_map`` over a 1-D mesh: every device decodes its
contiguous slice of the pair axis with replicated tables, the sums over
pairs come back by ``psum`` and the per-pair outputs stay pair-sharded.
Here one Python thread drives every device of a :class:`Mesh` the same
way: each shard's staging, kernels and extraction are queued on its
device's current stream without waiting, so the devices work at once. No
``torch.distributed`` call is on this path; processes only share out job
tiles (:mod:`.multihost`).

The sums over pairs are added over the shards in float64, in shard order,
and the per-pair outputs concatenated along the pair axis in shard order,
both on the mesh's first device. A mesh may name a device more than once
(``["cuda:0"] * 2``, or ``["cpu"] * 4`` in tests, as the JAX package's
tests use virtual host devices); the tables are held once per distinct
device. Each shard runs inside its device's context, so the launchers'
``cudaSetDevice`` never leaves the thread on another device.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..engine.kernels import (BwdOutputs, GpuDecoder, resolve_device,
                              stage)
from ..engine.oracle import DecodeContext

# outputs summed over pairs (psum in the JAX package); the others are per
# pair, with the pair axis last
_SUM_OUTPUTS = frozenset({"posterior_sums", "major_minor_sums"})


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: the devices, one shard each, in shard order."""
    devices: Tuple[torch.device, ...]
    axis_name: str = "pairs"

    @property
    def size(self) -> int:
        return len(self.devices)

    def check_device(self, device) -> None:
        """Raise ``ValueError`` unless ``device`` names every device of the
        mesh ("cuda" matches any CUDA device)."""
        dev = torch.device(device)
        if any(d.type != dev.type or dev.index not in (None, d.index)
               for d in self.devices):
            raise ValueError(f"device {device!r} conflicts with the mesh's "
                             f"devices {[str(d) for d in self.devices]}")


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "pairs",
              devices=None) -> Mesh:
    """A mesh over every CUDA device of this process, the first
    ``n_devices`` of them, or ``devices`` (which may repeat a device).
    Raises ``RuntimeError`` when there is no CUDA device and no
    ``devices``."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; pass devices= "
                               "(e.g. ['cpu'] * 4 for the plain versions)")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devs = []
    for d in devices:
        d = resolve_device(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        devs.append(d)
    if n_devices is not None:
        devs = devs[:n_devices]
    if not devs:
        raise ValueError("a mesh needs at least one device")
    return Mesh(tuple(devs), axis_name)


def on_device(dev: torch.device):
    """The device's context for a CUDA device (restores the thread's
    current device on exit); nothing for the CPU."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


class ShardedDecoder:
    """Pair-parallel decoding over a mesh with the :class:`GpuDecoder`
    interface the pipelines use (``decode_pairs``, ``decode_extract_packed``).
    The global pair batch must be a multiple of the mesh size; shard s
    takes the s-th contiguous slice of it."""

    supports_fused_extract = True

    def __init__(self, ctx: DecodeContext, mesh: Mesh,
                 decode_profile: str = "exact"):
        self.ctx = ctx
        self.mesh = mesh
        self.devices = mesh.devices
        self.n_devices = mesh.size
        self.decoders = {}                 # one per distinct device
        for dev in self.devices:
            if dev not in self.decoders:
                with on_device(dev):
                    self.decoders[dev] = GpuDecoder(ctx, dev, decode_profile)
        self.alpha_dtype = self.shard_decoder(0).alpha_dtype
        self.L = self.shard_decoder(0).L

    @property
    def n_extract_shards(self) -> int:
        """Packed rows a batch's extraction returns (one per shard)."""
        return self.n_devices

    def shard_decoder(self, s: int) -> GpuDecoder:
        """The decoder of shard ``s``'s device."""
        return self.decoders[self.devices[s]]

    @property
    def exp_times(self) -> torch.Tensor:
        return self.shard_decoder(0).exp_times

    @exp_times.setter
    def exp_times(self, times) -> None:
        for dec in self.decoders.values():
            dec.exp_times = times

    # ------------------------------------------------------------------
    def stage(self, x) -> Tuple[List[torch.Tensor], list]:
        """Host array ``x`` [P_global] as per-shard tensors, each slice on
        its shard's device through :func:`kernels.stage` (pinned,
        ``non_blocking``): ``(tensors, sources)``; keep the sources until
        an event recorded on each device after the copies has fired."""
        P_local = self._local_size(x)
        tensors, sources = [], []
        for s, dev in enumerate(self.devices):
            with on_device(dev):
                t, src = stage(x[s * P_local:(s + 1) * P_local], dev)
            tensors.append(t)
            sources.append(src)
        return tensors, sources

    def _local_size(self, hap_a) -> int:
        """Pairs a shard takes; ``hap_a`` is a host array or tensor of the
        global batch, or the per-shard tensors of :meth:`stage`."""
        if isinstance(hap_a, (list, tuple)):
            P_global = sum(len(x) for x in hap_a)
        else:
            P_global = len(hap_a)
        if P_global % self.n_devices != 0:
            raise ValueError(f"global pair batch {P_global} is not divisible "
                             f"by mesh size {self.n_devices}")
        return P_global // self.n_devices

    @staticmethod
    def _local(x, s: int, P_local: int):
        """Shard ``s``'s part of ``x``: its entry of per-shard tensors, its
        slice of a global array, or None."""
        if x is None:
            return None
        if isinstance(x, (list, tuple)):
            return x[s]
        return x[s * P_local:(s + 1) * P_local]

    def combine(self, parts: List[dict]) -> dict:
        """Outputs of consecutive slices of the pair axis, in pair order, as
        one: the sums over pairs added in float64 in that order and rounded
        once, the per-pair outputs concatenated along the pair axis, on the
        mesh's first device."""
        dev = self.devices[0]
        out = {}
        for name in parts[0]:
            xs = [r[name].to(dev, non_blocking=True) for r in parts]
            if name in _SUM_OUTPUTS:
                acc = xs[0].double()
                for x in xs[1:]:
                    acc += x
                out[name] = acc.float()
            else:
                out[name] = torch.cat(xs, dim=-1)
        return out

    def decode_pairs(self, hap_a, hap_b, t0: int = 0,
                     t_len: Optional[int] = None,
                     outputs: BwdOutputs = BwdOutputs(),
                     state_threshold: int = 0) -> dict:
        """Decode a global batch of hap pairs over [t0, t0+t_len), sharded
        over the mesh; ``GpuDecoder.decode_pairs``'s outputs and shapes
        (sharding.py:203-220)."""
        t_len = self.L - t0 if t_len is None else int(t_len)
        P_local = self._local_size(hap_a)
        parts = []
        for s, dev in enumerate(self.devices):
            with on_device(dev):
                parts.append(self.decoders[dev].decode_pairs(
                    self._local(hap_a, s, P_local),
                    self._local(hap_b, s, P_local), int(t0), t_len, outputs,
                    int(state_threshold)))
        return self.combine(parts)

    def decode_extract_packed(self, hap_a, hap_b, t0: int, t_len: int,
                              state_threshold: int, s0: int, s1: int,
                              prob_threshold: float, cap: int, pps_cap: int,
                              age_threshold: int, need_ages: bool = True,
                              w0=None, w1=None, kcap: int = 0):
        """Decode + capped extraction per shard (sharding.py:283-332):
        ``(packed [S, 3*kcap+2] int32, ages [S, 2, min(pps_cap, kcap)] or
        None, threshold_sums [T, P_global])`` on the mesh's first device.
        Every shard extracts its own pairs with the full ``cap``/``kcap``
        (run counts are not balanced across shards), so the overflow
        checks apply per shard (``segments.merge_packed_shards``). With the
        pair and window arrays staged (:meth:`stage`) nothing here waits
        for a device."""
        P_local = self._local_size(hap_a)
        T = int(t_len)
        if T * P_local >= 1 << 28:
            raise ValueError(f"T*P_local = {T * P_local} >= 2**28 overflows "
                             "the packed boundary encoding")
        kcap = kcap or cap
        if cap <= 0 or pps_cap <= 0 or not 0 < kcap <= cap:
            raise ValueError(f"cap={cap}/kcap={kcap}/pps_cap={pps_cap} must "
                             "be positive with kcap <= cap")
        packs, ages, ths = [], [], []
        for s, dev in enumerate(self.devices):
            with on_device(dev):
                packed, a, th = self.decoders[dev].decode_extract_packed(
                    self._local(hap_a, s, P_local),
                    self._local(hap_b, s, P_local), t0, T, state_threshold,
                    s0, s1, prob_threshold, cap, pps_cap, age_threshold,
                    need_ages, self._local(w0, s, P_local),
                    self._local(w1, s, P_local), kcap)
            packs.append(packed)
            ages.append(a)
            ths.append(th)
        dev = self.devices[0]

        def gather(xs):
            return [x.to(dev, non_blocking=True) for x in xs]

        return (torch.stack(gather(packs)),
                torch.stack(gather(ages)) if need_ages else None,
                torch.cat(gather(ths), dim=1))

    # ------------------------------------------------------------------
    def posterior_sums(self, hap_a, hap_b, t0: int, t_len: int):
        """Sum over the pairs of every shard [T, K] (sharding.py:334-339)."""
        return self.decode_pairs(hap_a, hap_b, t0, t_len,
                                 BwdOutputs(posterior=False,
                                            posterior_sums=True),
                                 0)["posterior_sums"]

    def per_pair_outputs(self, hap_a, hap_b, t0: int, t_len: int,
                         state_threshold: int):
        """``(threshold_sums [T, P_global], posterior_mean [T, P_global])``
        (sharding.py:341-349)."""
        r = self.decode_pairs(hap_a, hap_b, t0, t_len,
                              BwdOutputs(posterior=False, per_pair_mean=True,
                                         threshold_sums=True),
                              state_threshold)
        return r["threshold_sums"], r["per_pair_mean"]


def training_step(ctx: DecodeContext, mesh: Mesh):
    """The canonical multi-device step of the JAX package
    (sharding.py:352-365): a sharded decode of two pairs a shard over a
    64-site window, and their sums over pairs. No gradient. Returns
    ``(step, example_args)``."""
    sd = ShardedDecoder(ctx, mesh)
    rng = np.random.default_rng(0)
    ha = rng.integers(0, ctx.data.n_haps, 2 * sd.n_devices).astype(np.int32)
    hb = ((ha + 1) % ctx.data.n_haps).astype(np.int32)

    def step(hap_a, hap_b):
        return sd.posterior_sums(hap_a, hap_b, 0, 64)

    return step, (ha, hb)
