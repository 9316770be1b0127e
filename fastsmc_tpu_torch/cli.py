"""Command-line interface of the PyTorch/CUDA port.

The port's counterpart of ``fastsmc_tpu/cli.py``, with its subcommands,
flags, names and defaults; mirrors the reference executables:
  * ``fastsmc``        <- FastSMC_exe  (DecodingParams.cpp:164-276 flag set)
  * ``asmc``           <- ASMC_exe     (DecodingParams.cpp:75-162 flag set)
  * ``convert-binary`` <- convertBinary_exe (main_convertBinary.cpp)
  * ``merge``          <- ASMCmergePosteriorSums jar
  * ``prepare``        <- ASMCprepareDecoding jar (+ the .npz artifact)

``fastsmc`` and ``asmc`` decode through the H100 / CUDA kernels on
``--device cuda`` (the default; without CUDA they raise) or through the
kernels' plain versions on ``--device cpu``.

Run as ``python -m fastsmc_tpu_torch.cli <subcommand> ...`` or
``fastsmc-tpu-torch <subcommand> ...``.
"""

from __future__ import annotations

import argparse
import sys


def _add_fastsmc_parser(sub):
    p = sub.add_parser("fastsmc", help="two-stage IBD detection (FastSMC)")
    p.add_argument("--inFileRoot", required=True)
    p.add_argument("--outFileRoot", required=True)
    p.add_argument("--decodingQuantFile", default="")
    p.add_argument("--mode", default="array", choices=["array", "sequence"])
    p.add_argument("--time", type=int, default=100)
    p.add_argument("--jobs", type=int, default=1)
    p.add_argument("--jobInd", type=int, default=1)
    p.add_argument("--bin", action="store_true")
    p.add_argument("--batchSize", type=int, default=32)
    p.add_argument("--recall", type=int, default=3)
    p.add_argument("--segmentLength", action="store_true", default=True)
    p.add_argument("--perPairMAP", action="store_true", default=True)
    p.add_argument("--perPairPosteriorMeans", action="store_true",
                   default=True)
    p.add_argument("--noConditionalAgeEstimates", action="store_true")
    p.add_argument("--withinOnly", action="store_true")
    p.add_argument("--useAncestral", action="store_true")
    p.add_argument("--compress", action="store_true")
    p.add_argument("--skipCSFSdistance", type=float, default=float("nan"))
    p.add_argument("--hashing", action="store_true", default=True)
    p.add_argument("--no-hashing", dest="hashing", action="store_false")
    p.add_argument("--min_m", type=float, default=1.0)
    p.add_argument("--skip", type=float, default=0.0)
    p.add_argument("--min_maf", type=float, default=0.0)
    p.add_argument("--gap", type=int, default=1)
    p.add_argument("--max_seeds", type=int, default=0)
    p.add_argument("--useKnownSeed", action="store_true")
    p.add_argument("--permissiveWindow", action="store_true",
                   help="scan each batch member over the batch-UNION "
                        "window (the reference's permissive override, "
                        "HMM.cpp:1199-1204 -- sized for batchSize 32). "
                        "Default scans each candidate over its own padded "
                        "window (the reference's flagged less-permissive "
                        "TODO option), making output invariant to batch "
                        "size and candidate order")
    p.add_argument("--hashingBackend", default="host",
                   choices=["host", "device"],
                   help="identification scan: the streaming host scan "
                        "(native C++, or Python without it); 'device', the "
                        "JAX package's sort-based scan, is not ported and "
                        "ends the run with an error")
    p.add_argument("--decodeProfile", default="exact",
                   choices=["exact", "fast", "turbo"],
                   help="decode numerics: exact (reference NO_SSE f32), "
                        "fast (bf16 alpha store, bf16 operands with f32 "
                        "accumulation), or turbo (bf16 operators too; the "
                        "same bits as fast)")
    _add_device(p)
    return p


def _add_device(p):
    p.add_argument("--device", default="cuda",
                   help="where the decode runs: cuda (the CUDA kernels; "
                        "raises without CUDA) or cpu (their plain versions)")


def _run_fastsmc(args):
    from .config import DecodingParams
    from .pipelines.fastsmc import FastSMC

    params = DecodingParams.fastsmc_cli_defaults(
        args.inFileRoot, args.outFileRoot,
        decoding_quant_file=args.decodingQuantFile,
        decoding_mode=args.mode, time=args.time,
        jobs=args.jobs, job_ind=args.jobInd, bin_out=args.bin,
        batch_size=args.batchSize, recall_threshold=args.recall,
        output_ibd_segment_length=args.segmentLength,
        do_per_pair_map=args.perPairMAP,
        do_per_pair_posterior_mean=args.perPairPosteriorMeans,
        no_conditional_age_estimates=args.noConditionalAgeEstimates,
        within_only=args.withinOnly, use_ancestral=args.useAncestral,
        compress=args.compress, skip_csfs_distance=args.skipCSFSdistance,
        hashing=args.hashing, min_m=args.min_m, skip=args.skip,
        min_maf=args.min_maf, gap=args.gap, max_seeds=args.max_seeds,
        use_known_seed=args.useKnownSeed,
        permissive_window=args.permissiveWindow)
    try:
        f = FastSMC(params, device=args.device,
                    hashing_backend=args.hashingBackend,
                    decode_profile=args.decodeProfile)
    except NotImplementedError as e:
        sys.exit(f"ERROR: {e}")
    f.run()


def _add_asmc_parser(sub):
    p = sub.add_parser("asmc", help="all-pairs posterior decoding (ASMC)")
    p.add_argument("--inFileRoot", required=True)
    p.add_argument("--decodingQuantFile", default="")
    p.add_argument("--outFileRoot", default="")
    p.add_argument("--jobs", type=int, default=0)
    p.add_argument("--jobInd", type=int, default=0)
    p.add_argument("--mode", default="array", choices=["array", "sequence"])
    p.add_argument("--compress", action="store_true")
    p.add_argument("--useAncestral", action="store_true")
    p.add_argument("--skipCSFSdistance", type=float, default=0.0)
    p.add_argument("--posteriorSums", action="store_true")
    p.add_argument("--majorMinorPosteriorSums", action="store_true")
    # per-pair output surface (DecodingParams.hpp:56-60; the reference
    # reaches these through the library API / HMM setters)
    p.add_argument("--perPairPosteriorMeans", action="store_true",
                   help="stream per-pair posterior means to "
                        "<out>.perPairPosteriorMeans.gz (large output)")
    p.add_argument("--perPairMAP", action="store_true",
                   help="stream per-pair MAP states to <out>.perPairMAP.gz")
    p.add_argument("--expectedCoalTimesFile", default="",
                   help="3-column intervals file supplying expected "
                        "coalescent times for posterior means "
                        "(implies --perPairPosteriorMeans)")
    p.add_argument("--withinOnly", action="store_true",
                   help="only decode pairs within unphased individuals")
    p.add_argument("--noConditionalAgeEstimates", action="store_true")
    p.add_argument("--useKnownSeed", action="store_true")
    p.add_argument("--batchSize", type=int, default=64)
    p.add_argument("--noBatches", action="store_true",
                   help="scalar (non-batched) oracle decoding on the host; "
                        "debug only")
    p.add_argument("--decodeProfile", default="exact",
                   choices=["exact", "fast", "turbo"])
    _add_device(p)
    return p


def _run_asmc(args):
    from .config import DecodingParams
    from .pipelines.asmc import ASMC

    if not (args.posteriorSums or args.majorMinorPosteriorSums
            or args.perPairPosteriorMeans or args.perPairMAP
            or args.expectedCoalTimesFile):
        sys.exit("ERROR: At least one of --posteriorSums, "
                 "--majorMinorPosteriorSums, --perPairPosteriorMeans, "
                 "--perPairMAP, --expectedCoalTimesFile must be specified")
    params = DecodingParams.asmc(
        args.inFileRoot, args.decodingQuantFile, args.outFileRoot,
        jobs=args.jobs, job_ind=args.jobInd, decoding_mode=args.mode,
        compress=args.compress, use_ancestral=args.useAncestral,
        skip_csfs_distance=args.skipCSFSdistance,
        do_posterior_sums=args.posteriorSums,
        do_major_minor_posterior_sums=args.majorMinorPosteriorSums,
        do_per_pair_posterior_mean=args.perPairPosteriorMeans,
        do_per_pair_map=args.perPairMAP,
        expected_coal_times_file=args.expectedCoalTimesFile,
        within_only=args.withinOnly,
        no_conditional_age_estimates=args.noConditionalAgeEstimates,
        use_known_seed=args.useKnownSeed, batch_size=args.batchSize,
        no_batches=args.noBatches)
    asmc = ASMC(params, device=args.device,
                decode_profile=args.decodeProfile)
    result = asmc.decode_all_in_job()
    asmc.write_outputs(result)


def _run_convert(args):
    from .io.writers import BinaryDataReader
    for line in BinaryDataReader(args.binaryFile):
        print(line.to_string())


def _run_merge(args):
    from .pipelines.merge import PosteriorMerger
    if args.fileList:
        with open(args.fileList) as fh:
            roots = [line.strip() for line in fh if line.strip()]
        m = PosteriorMerger.from_file_list(roots, normalize=args.norm)
    else:
        m = PosteriorMerger.from_job_indices(args.fileRoot, args.jobs,
                                             normalize=args.norm)
    if args.infoFile:
        m.compute_coalescent_times(args.infoFile)
    m.write(args.out)


def _run_prepare(args):
    from .prepare.make_dq import (prepare_decoding, write_intervals_info,
                                  write_reference_text)
    dq = prepare_decoding(
        demography_file=args.demography,
        discretization_file=args.discretization,
        csfs_file=args.CSFS,
        file_root=args.fileRoot, freq_file=args.freqFile,
        samples=args.samples, mu=args.mut)
    dq.save_npz(args.out + ".decodingQuantities.npz")
    write_intervals_info(dq, args.out + ".intervalsInfo")
    if args.text:
        write_reference_text(dq, args.out + ".decodingQuantities.gz")
    print(f"Wrote {args.out}.decodingQuantities.npz")


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="fastsmc-tpu-torch",
        description="FastSMC/ASMC IBD detection in PyTorch, decoding with "
                    "hand-written CUDA kernels on an NVIDIA H100")
    sub = parser.add_subparsers(dest="cmd", required=True)

    _add_fastsmc_parser(sub)
    _add_asmc_parser(sub)

    c = sub.add_parser("convert-binary", help="print .bibd.gz as text")
    c.add_argument("binaryFile")

    m = sub.add_parser("merge", help="merge per-job posterior sums")
    g = m.add_mutually_exclusive_group(required=True)
    g.add_argument("--fileRoot")
    g.add_argument("--fileList")
    m.add_argument("--jobs", type=int, default=0)
    m.add_argument("--out", required=True)
    m.add_argument("--norm", action="store_true")
    m.add_argument("--infoFile", default="")

    pp = sub.add_parser("prepare", help="generate decoding quantities")
    pp.add_argument("-D", "--demography", required=True)
    pp.add_argument("-d", "--discretization", required=True)
    pp.add_argument("-C", "--CSFS", default="",
                    help="precomputed .csfs (omit to compute it from the "
                         "demography; replaces the smcpp get_csfs.py step")
    pp.add_argument("-f", "--fileRoot", default=None)
    pp.add_argument("-F", "--freqFile", default=None)
    pp.add_argument("-n", "--samples", type=int, default=300)
    pp.add_argument("-mu", "--mut", type=float, default=1.65e-8)
    pp.add_argument("-o", "--out", required=True)
    pp.add_argument("--text", action="store_true",
                    help="also write the reference gzipped-text format")

    args = parser.parse_args(argv)
    {"fastsmc": _run_fastsmc, "asmc": _run_asmc,
     "convert-binary": _run_convert, "merge": _run_merge,
     "prepare": _run_prepare}[args.cmd](args)


if __name__ == "__main__":
    main()
