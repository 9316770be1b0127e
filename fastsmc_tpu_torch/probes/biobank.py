"""The synthetic biobank panel of ``scripts/biobank_probe.py``.

A copy of that script's ``make_panel`` (and ``params_for``), which builds
the JAX package's ``Data``; this one builds the port's. The same seed gives
the same arrays.
"""

import numpy as np

from ..config import DecodingParams
from ..io.haps import Data

WORDS = 100                      # 6,400 sites, ~200 cM (example-panel scale)
SITES = 64 * WORDS


def make_panel(n_haps: int, seed: int = 0):
    """Founder-mosaic panel of ``n_haps`` haplotypes x 6,400 sites:
    realistic word-collision structure for GERMLINE.

    founders = n_haps//8 keeps expected sharing per founder-chunk at ~8
    haps; with ~1.2% mutation noise and min_m=1.5 cM (~48 sites) the
    candidate rate lands at O(10) candidates/hap — the sparse-but-nonzero
    regime the reference targets at biobank scale.
    """
    rng = np.random.default_rng(seed)
    n_f = max(512, n_haps // 8)
    founders = (rng.random((n_f, SITES)) <
                rng.uniform(0.05, 0.5, SITES)).astype(np.uint8)
    bits = np.empty((n_haps, SITES), np.uint8)
    block = 8192
    for lo in range(0, n_haps, block):
        hi = min(lo + block, n_haps)
        b = hi - lo
        # geometric founder switches, mean distance ~400 sites (~12.5 cM)
        switch = rng.random((b, SITES)) < (1.0 / 400)
        switch[:, 0] = True
        seg = np.cumsum(switch, axis=1) - 1
        fid = rng.integers(0, n_f, (b, seg.max() + 1))
        rows = fid[np.arange(b)[:, None], seg]
        bits[lo:hi] = founders[rows, np.arange(SITES)[None, :]]
        noise = rng.random((b, SITES)) < 0.012
        bits[lo:hi] ^= noise.astype(np.uint8)
    n_ind = n_haps // 2
    # minor-allele folding, exactly like the file loader (Data.cpp:365-366,
    # 472-473). Round-4 skipped it (fold_to_minor=False on unfolded bits),
    # which sent out-of-support rows into the FOLDED CSFS table: ~3% of
    # sites got an all-zero emission row, and any decode window containing
    # such a site for a pair observing that class went NaN — silently
    # deleting segments, with the loss pattern depending on batch unions.
    # The hashing stage reconstructs raw alleles as folded ^ flipped, so
    # the candidate stream is unchanged by the fix; only validation
    # (emissions) is repaired.
    dac = bits.sum(axis=0).astype(np.int32)
    flip = dac > n_haps - dac
    bits = bits ^ flip[None, :].astype(np.uint8)
    dac = np.where(flip, n_haps - dac, dac).astype(np.int32)
    return Data(
        sites=SITES, sample_size=n_ind,
        fam_id_list=[f"f{i}" for i in range(n_ind)],
        iid_list=[f"s{i}" for i in range(n_ind)],
        hap_bits=bits,
        genetic_positions=np.linspace(0, 2.0, SITES),   # 200 cM in Morgans
        physical_positions=np.arange(SITES, dtype=np.int64) * 1000,
        rec_rate_at_marker=np.zeros(SITES),
        snp_ids=[f"snp{i}" for i in range(SITES)],
        derived_allele_counts=dac,
        total_samples_count=np.full(SITES, n_haps, np.int32),
        site_was_flipped=flip,
        chr_number=1, windows=None,
        fold_to_minor=True, decoding_uses_csfs=True, use_known_seed=True)


def params_for(n_haps: int) -> DecodingParams:
    """FastSMC parameters the panel decodes under (its tables need no
    files: the paths are placeholders)."""
    return DecodingParams(fastsmc=True, hashing=True, batch_size=64,
                          in_file_root="/x", decoding_quant_file="/x",
                          out_file_root="/x", min_m=1.5)
