"""End-to-end walkthrough of the port (the reference's notebooks/fastsmc.ipynb
flow), the counterpart of ``examples/walkthrough.py``.

Builds a model from raw inputs, runs both pipelines and touches the
analysis APIs -- a copy-paste starting point for new users:

    python -m fastsmc_tpu_torch.walkthrough [--device cpu] [--samples N]

Its inputs are all in the repository: the CEU demography and the 69-state
discretisation written out of ``artifacts/n300.array.decodingQuantities.npz``
(``io/inputs.py``) and the example panel ``artifacts/panels/example_array``
(with an ASMC-format copy of its map for the ASMC steps). The decodes run
the CUDA kernels on ``--device cuda`` (the default) or their plain versions
on ``--device cpu``; outputs go to ``build/walkthrough/`` in the checkout
unless ``--out`` says otherwise.
"""

from __future__ import annotations

import argparse
import gzip
import os

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACT = os.path.join(REPO, "artifacts", "n300.array.decodingQuantities.npz")
PANEL = os.path.join(REPO, "artifacts", "panels", "example_array", "example")


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    ap.add_argument("--samples", type=int, default=30,
                    help="CSFS sample size of the prepared model (the "
                         "reference's production value is 300)")
    ap.add_argument("--out", default=os.path.join(REPO, "build",
                                                  "walkthrough"))
    args = ap.parse_args(argv)
    out = args.out
    os.makedirs(out, exist_ok=True)

    from .config import DecodingParams
    from .io.decoding_quantities import DecodingQuantities
    from .io.inputs import write_asmc_panel, write_model_files
    from .pipelines.asmc import ASMC
    from .pipelines.fastsmc import FastSMC
    from .prepare.make_dq import prepare_decoding, write_intervals_info

    # 1. decoding quantities (TOOLS/PREPARE_DECODING equivalent); the CSFS
    # is computed from the demography, no smcpp needed
    demo, disc = write_model_files(DecodingQuantities.load(ARTIFACT),
                                   os.path.join(out, "CEU"))
    dq = prepare_decoding(demography_file=demo, discretization_file=disc,
                          file_root=PANEL, samples=args.samples,
                          verbose=False)
    dq_path = os.path.join(out, "model.decodingQuantities.npz")
    dq.save_npz(dq_path)
    write_intervals_info(dq, os.path.join(out, "model.intervalsInfo"))
    print(f"[1] decoding quantities: {dq.states} states, CSFS of "
          f"{dq.csfs_samples} samples -> {dq_path}")

    # 2. ASMC: posterior sums for one job; the panel loads the job's two
    # sample windows (the reference's triangular tiling, jobs a square)
    # and the job decodes its share of their pairs
    asmc_panel = write_asmc_panel(PANEL, os.path.join(out, "asmc_panel",
                                                      "example"))
    params = DecodingParams.asmc(
        asmc_panel, dq_path, os.path.join(out, "asmc"),
        do_posterior_sums=True, use_known_seed=True, jobs=100, job_ind=7)
    asmc = ASMC(params, device=args.device)
    res = asmc.decode_all_in_job(verbose=False)
    asmc.write_outputs(res)
    print(f"[2] ASMC sums {res.sum_over_pairs.shape} -> "
          f"{params.out_file_root}.sumOverPairs.gz")

    # 3. targeted pair decoding (the decodePairs API) on the whole panel
    full = ASMC(DecodingParams.asmc(asmc_panel, dq_path,
                                    os.path.join(out, "asmc_full")),
                device=args.device)
    pairs = full.decode_pairs([0, 3, 11], [7, 40, 200],
                              per_pair_posteriors=True)
    print(f"[3] decodePairs posteriors {pairs.per_pair_posteriors.shape}; "
          f"first pair's mean TMRCA at site 0: "
          f"{pairs.per_pair_posterior_means[0, 0]:.1f} generations")

    # 4. FastSMC: two-stage IBD detection on the example panel (its map is
    # in FastSMC format), the native host scan
    fp = DecodingParams.fastsmc_defaults(
        PANEL, dq_path, os.path.join(out, "ibd"), use_known_seed=True)
    path = FastSMC(fp, device=args.device, hashing_backend="host").run(
        verbose=False)
    with gzip.open(path, "rt") as fh:
        segs = fh.read().splitlines()
    print(f"[4] FastSMC: {len(segs)} IBD segments -> {path}")
    if segs:
        print("    first:", segs[0][:100])

    # 5. posterior heat map (TOOLS/PLOT_POSTERIORS equivalent); needs
    # matplotlib, which the rest of the port does not
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        print("[5] heat map skipped: matplotlib is not installed")
    else:
        from .pipelines.plot import plot_posterior_heatmap
        png = plot_posterior_heatmap(
            params.out_file_root + ".sumOverPairs.gz",
            os.path.join(out, "model.intervalsInfo"),
            os.path.join(out, "heatmap.png"))
        print(f"[5] heat map -> {png}")
    print("walkthrough complete")
    return out


if __name__ == "__main__":
    main()
