"""The traffic generator: a synthetic biobank panel and the jobs over it,
from a traffic file's parameters and the run's seed.

The panel's sites, their physical and genetic positions and the founders'
alleles are those of a source panel and its map (a traffic file's
``founders``). With ``"mosaic": false`` the panel is the source's own
haplotypes. Otherwise each new haplotype copies one founder haplotype at a
time, switching to a founder drawn at random at a recombination between
two sites, with the chance ``1 - exp(-rate * d)`` for ``d`` Morgans
between them (Li and Stephens' copying model), and carries point noise at
the rate the file gives; it is drawn on the device, in a few large calls
from one ``torch.Generator`` seeded from the run's seed, so every seed
gives another panel with the same sites and statistics, and the same seed
the same bits. The panel is then folded to minor alleles. The jobs are
consecutive job indices of a fixed job count from a start drawn from the
seed.
"""

from __future__ import annotations

import dataclasses
import gzip

import numpy as np
import torch

# haplotypes drawn at a time: bounds the generator's temporaries
_BLOCK = 4096


@dataclasses.dataclass
class Panel:
    bits: torch.Tensor             # uint8 [haplotypes, sites] on the device,
    #                                folded to minor alleles
    genetic_positions: np.ndarray  # float64 Morgans [sites]
    physical_positions: np.ndarray  # int64 [sites]
    dac: np.ndarray                # int32 [sites] minor-allele counts
    flipped: np.ndarray            # bool [sites] folded sites

    @property
    def haplotypes(self) -> int:
        return self.bits.shape[0]

    @property
    def sites(self) -> int:
        return self.bits.shape[1]


def seeds(seed: int, n: int) -> list:
    """``n`` independent 63-bit seeds derived from the run's seed."""
    ss = np.random.SeedSequence(int(seed))
    return [int(x) >> 1 for x in ss.generate_state(n, np.uint64)]


def read_founders(hap_path: str, map_path: str, sites: int):
    """The first ``sites`` sites of a ``.hap.gz`` panel and its map
    (columns position, rate, cM, one header line): ``(alleles uint8
    [haplotypes, sites], physical positions, genetic positions in
    Morgans)``."""
    with gzip.open(hap_path, "rb") as f:
        rows = [line.split(None, 5) for _, line in zip(range(sites), f)]
    if len(rows) < sites:
        raise ValueError(f"{hap_path} has {len(rows)} sites, not {sites}")
    phys = np.asarray([int(r[2]) for r in rows], np.int64)
    text = b"".join(r[5] for r in rows)
    digits = np.frombuffer(text, np.uint8)
    alleles = (digits[(digits == ord("0")) | (digits == ord("1"))]
               - ord("0")).reshape(sites, -1)
    with gzip.open(map_path, "rt") as f:
        gmap = np.loadtxt(f, skiprows=1, max_rows=sites, ndmin=2)
    if not np.array_equal(gmap[:, 0].astype(np.int64), phys):
        raise ValueError(f"{map_path} and {hap_path} name other sites")
    return np.ascontiguousarray(alleles.T), phys, gmap[:, 2] / 100.0


def make_panel(spec: dict, seed: int, device) -> Panel:
    """The panel of a traffic file's ``panel`` section, with the sizes
    ``haplotypes`` and ``sites`` and the ``founders`` files' paths as
    found (``hap_path``, ``map_path``), drawn on ``device``."""
    H, L = int(spec["haplotypes"]), int(spec["sites"])
    alleles, phys, morgans = read_founders(spec["hap_path"],
                                           spec["map_path"], L)
    if "morgans" in spec and abs(morgans[-1] - spec["morgans"]) > 1e-9:
        raise ValueError(f"the map's first {L} sites span {morgans[-1]} M, "
                         f"not {spec['morgans']}")
    founders = torch.as_tensor(alleles, device=device)
    n_f = founders.shape[0]
    if not spec.get("mosaic", True):
        if H != n_f:
            raise ValueError(f"the source panel has {n_f} haplotypes, "
                             f"not {H}")
        return _folded(founders.clone(), morgans, phys)
    g = torch.Generator(device=device)
    g.manual_seed(seeds(seed, 1)[0])
    u = dict(generator=g, device=device)
    d = torch.as_tensor(np.diff(morgans, prepend=0.0), device=device)
    p_switch = (-torch.expm1(-float(spec["switch_per_morgan"]) * d)).float()
    bits = torch.empty((H, L), dtype=torch.uint8, device=device)
    sites = torch.arange(L, device=device)
    for h0 in range(0, H, _BLOCK):
        b = min(_BLOCK, H - h0)
        # founder of each stretch between switches: the draw at the last
        # switch at or before the site
        switch = torch.rand((b, L), **u) < p_switch
        switch[:, 0] = True
        last = torch.where(switch, sites, 0).cummax(dim=1).values
        fid = torch.randint(0, n_f, (b, L), **u).gather(1, last)
        noise = (torch.rand((b, L), **u) < spec["noise"]).to(torch.uint8)
        bits[h0:h0 + b] = founders[fid, sites] ^ noise
    return _folded(bits, morgans, phys)


def _folded(bits: torch.Tensor, morgans, phys) -> Panel:
    """``bits`` folded to minor alleles, in place, with its counts."""
    H = bits.shape[0]
    dac = bits.sum(dim=0, dtype=torch.int32)
    flip = dac > H - dac
    bits ^= flip.to(torch.uint8)
    dac = torch.where(flip, H - dac, dac)
    return Panel(bits=bits, genetic_positions=morgans,
                 physical_positions=phys,
                 dac=dac.cpu().numpy().astype(np.int32),
                 flipped=flip.cpu().numpy())


def job_sequence(J: int, seed: int) -> list:
    """Job indices (1-based) of ``J`` jobs in the order the window runs
    them: consecutive from a start drawn from the seed, wrapping."""
    start = seeds(seed, 2)[1] % J
    return [(start + i) % J + 1 for i in range(J)]
