"""Drop-in compatibility surface for the reference ``asmc`` Python module.

The port's counterpart of ``fastsmc_tpu/compat.py``. The reference ships a
pybind11 module (ASMC_SRC/SRC/pybind.cpp:54-252, re-exported by
ASMC_SRC/SRC/__init__.py) whose classes use camelCase methods. This module
maps that surface onto the port, so existing scripts can switch with

    import fastsmc_tpu_torch.compat as asmc

Covered: ``DecodingParams`` (both profiles), ``DecodingQuantities``,
``ASMC`` (decodeAllInJob / decodePairs by index or "ind#hap" id /
get_copy_of_results), ``FastSMC`` (run), ``BinaryDataReader``
(getNextLine / moreLinesInFile), ``IbdPairDataLine`` (toString), ``Data``,
``HMM``, ``Individual`` and the return structs. Attribute spellings follow
the pybind bindings (``per_pair_MAPs`` etc. aliased onto the snake_case
natives; ``IbdPairDataLine``'s camelCase fields are the port's own class's,
``io/writers.py``).

Every decode runs through the H100 / CUDA kernels (``engine/kernels.py``)
on ``device="cuda"``, the default of ``HMM``, ``ASMC`` and ``FastSMC``;
``device="cpu"`` runs the kernels' plain versions, and without CUDA the
default raises rather than falling back to the CPU.
"""

from __future__ import annotations

import copy
import dataclasses
import enum
from typing import Optional, Sequence, Union

import numpy as np

from . import preparedecoding  # noqa: F401  (asmc.preparedecoding)
from .config import DecodingParams as _Params
from .engine.hmm import bucket_len
from .engine.kernels import BwdOutputs, GpuDecoder
from .engine.oracle import DecodeContext
from .io.decoding_quantities import DecodingQuantities as _DQ
from .io.haps import Data as _NativeData
from .io.haps import count_hap_lines, load_data
from .io.writers import BinaryDataReader as _Reader
from .io.writers import IbdPairDataLine
from .pipelines import asmc as _asmc
from .pipelines import fastsmc as _fastsmc

__all__ = [
    "DecodingParams", "DecodingQuantities", "ASMC", "FastSMC",
    "BinaryDataReader", "IbdPairDataLine", "DecodePairsReturnStruct",
    "DecodingReturnValues", "DecodingMode", "DecodingModeOverall",
    "Data", "HMM", "Individual", "PairObservations",
    "preparedecoding",
]


class DecodingModeOverall(enum.IntEnum):
    """pybind.cpp:55-57."""
    sequence = 0
    array = 1


class DecodingMode(enum.IntEnum):
    """pybind.cpp:58-62."""
    sequenceFolded = 0
    arrayFolded = 1
    sequence = 2
    array = 3


# camelCase pybind attribute -> native snake_case field
# (pybind.cpp:146-178; names that already match are omitted)
_PARAM_ALIASES = {
    "inFileRoot": "in_file_root",
    "decodingQuantFile": "decoding_quant_file",
    "outFileRoot": "out_file_root",
    "jobInd": "job_ind",
    "decodingModeString": "decoding_mode",
    "decodingSequence": "decoding_sequence",
    "foldData": "fold_data",
    "usingCSFS": "using_csfs",
    "useAncestral": "use_ancestral",
    "skipCSFSdistance": "skip_csfs_distance",
    "noBatches": "no_batches",
    "batchSize": "batch_size",
    "recallThreshold": "recall_threshold",
    "FastSMC": "fastsmc",
    "BIN_OUT": "bin_out",
    "useKnownSeed": "use_known_seed",
    "outputIbdSegmentLength": "output_ibd_segment_length",
    "hashingWordSize": "hashing_word_size",
    "constReadAhead": "const_read_ahead",
    "noConditionalAgeEstimates": "no_conditional_age_estimates",
    "doPosteriorSums": "do_posterior_sums",
    "doPerPairMAP": "do_per_pair_map",
    "doPerPairPosteriorMean": "do_per_pair_posterior_mean",
    "expectedCoalTimesFile": "expected_coal_times_file",
    "withinOnly": "within_only",
    "doMajorMinorPosteriorSums": "do_major_minor_posterior_sums",
}

# the real config fields (strict-attribute check in __setattr__)
_PARAM_FIELDS = frozenset(f.name for f in dataclasses.fields(_Params))

# pybind big-ctor keyword order (pybind.cpp:121-141, DecodingParams.cpp:39-54)
_PYBIND_CTOR_ORDER = (
    "inFileRoot", "decodingQuantFile", "outFileRoot", "jobs", "jobInd",
    "decodingModeString", "decodingSequence", "usingCSFS", "compress",
    "useAncestral", "skipCSFSdistance", "noBatches", "doPosteriorSums",
    "doPerPairPosteriorMean", "expectedCoalTimesFile", "withinOnly",
    "doMajorMinorPosteriorSums", "doPerPairMAP")


class DecodingParams(_Params):
    """Reference pybind DecodingParams: camelCase read/write attributes and
    the validate methods, as used attribute-style in notebooks/fastsmc.ipynb
    (pybind.cpp:122-179)."""

    def __init__(self, *args, **kw):
        # FastSMC-defaults overload (pybind.cpp:143-144, the reference's
        # DecodingParams(in_dir, decoding_quants, out_dir, FastSMC=True))
        if any(k in kw for k in ("in_dir", "decoding_quants", "out_dir",
                                 "FastSMC")):
            a = list(args) + [None] * (4 - len(args))
            in_dir = kw.pop("in_dir", a[0]) or ""
            dq = kw.pop("decoding_quants", a[1]) or ""
            out = kw.pop("out_dir", a[2]) or ""
            fast = kw.pop("FastSMC", a[3])
            fast = True if fast is None else fast
            if kw:
                raise TypeError(f"unexpected arguments: {sorted(kw)}")
            if not fast:
                raise RuntimeError(
                    "This DecodingParams constructor sets sensible FastSMC "
                    "defaults, and is only intended for use with FastSMC.")
            base = _Params.fastsmc_defaults(in_dir, dq, out)
            super().__init__(**dataclasses.asdict(base))
            self.finalize()
            return
        if not args and all(k in _PARAM_FIELDS for k in kw):
            # native snake_case construction (also the dataclasses.replace
            # path the pipelines take)
            super().__init__(**kw)
            return
        # pybind 18-arg ctor (positional in the reference order, or by
        # camelCase keyword); the reference runs processOptions afterwards
        # (DecodingParams.cpp:51-53) -- finalize() here
        if len(args) > len(_PYBIND_CTOR_ORDER):
            raise TypeError(f"at most {len(_PYBIND_CTOR_ORDER)} positional "
                            "arguments")
        named = dict(zip(_PYBIND_CTOR_ORDER, args))
        for k, v in kw.items():
            if k in named:
                raise TypeError(f"duplicate argument {k!r}")
            named[k] = v
        fields = {}
        for k, v in named.items():
            snake = _PARAM_ALIASES.get(k, k)
            if snake not in _PARAM_FIELDS:
                raise TypeError(f"unknown DecodingParams argument {k!r}")
            fields[snake] = v
        super().__init__(**fields)
        if self.in_file_root:
            self.finalize()

    def __getattr__(self, name):
        # only called when normal lookup fails, i.e. for camelCase spellings
        snake = _PARAM_ALIASES.get(name)
        if snake is None:
            raise AttributeError(name)
        return getattr(self, snake)

    def __setattr__(self, name, value):
        if name == "decodingMode":
            # the enum field is distinct from decodingModeString in the
            # reference (DecodingParams.hpp:37-38): assigning it does NOT
            # rewrite the string, and validate re-derives the enum from the
            # string (processOptions, DecodingParams.cpp:502-533)
            object.__setattr__(self, "_decoding_mode_enum",
                               DecodingMode(value))
            return
        snake = _PARAM_ALIASES.get(name, name)
        # strict surface (pybind rejects unknown attributes): only known
        # camelCase aliases, real config fields, and private state pass
        if snake not in _PARAM_FIELDS and not snake.startswith("_"):
            raise AttributeError(
                f"'DecodingParams' has no attribute {name!r}")
        object.__setattr__(self, snake, value)

    @property
    def decodingMode(self) -> DecodingMode:
        shadow = self.__dict__.get("_decoding_mode_enum")
        if shadow is not None:
            return shadow
        if self.decoding_mode == "array":
            return (DecodingMode.arrayFolded if self.fold_data
                    else DecodingMode.array)
        return (DecodingMode.sequenceFolded if self.fold_data
                else DecodingMode.sequence)

    @decodingMode.setter
    def decodingMode(self, value):
        self.__setattr__("decodingMode", value)

    def validateParamsFastSMC(self) -> bool:
        """DecodingParams.cpp:278-464 -- True when consistent. Like the
        reference, validating FastSMC params with the FastSMC flag unset is
        a hard error (DecodingParams.cpp:282-287)."""
        if not self.fastsmc:
            raise RuntimeError(
                "Attempting to validate FastSMC parameters but FastSMC flag "
                "is false. Set DecodingParams.FastSMC to true?")
        return self.validateParams()

    def validateParams(self) -> bool:
        object.__setattr__(self, "_decoding_mode_enum", None)
        self.finalize()
        return True


class DecodingQuantities:
    """Reference ctor signature DecodingQuantities(fileName) with the full
    pybind member surface (pybind.cpp:100-120): camelCase scalars/vectors
    plus the distance-keyed transition maps (Dvectors/Bvectors/Uvectors/
    rowRatioVectors, DecodingQuantities.hpp:60-64) and the CSFS tensors.
    Unknown attributes fall through to the native snake_case object."""

    # camelCase -> native field (identity spellings omitted)
    _ALIASES = {
        "CSFSSamples": "csfs_samples",
        "initialStateProb": "initial_state_prob",
        "expectedTimes": "expected_times",
        "timeVector": "time_vector",
        "columnRatios": "column_ratios",
        "classicEmissionTable": "classic_emission",
        "compressedEmissionTable": "compressed_emission",
        "CSFSmap": "csfs",
        "foldedCSFSmap": "folded_csfs",
        "ascertainedCSFSmap": "ascertained_csfs",
        "foldedAscertainedCSFSmap": "folded_ascertained_csfs",
    }

    def __init__(self, path_or_native):
        native = (path_or_native if isinstance(path_or_native, _DQ)
                  else _DQ.load(path_or_native))
        object.__setattr__(self, "_native", native)

    def _dist_map(self, table):
        n = self._native
        return {float(d): table[i] for i, d in enumerate(n.gen_dists)}

    @property
    def Dvectors(self):
        return self._dist_map(self._native.D)

    @property
    def Bvectors(self):
        return self._dist_map(self._native.B)

    @property
    def Uvectors(self):
        return self._dist_map(self._native.U)

    @property
    def rowRatioVectors(self):
        return self._dist_map(self._native.RR)

    @property
    def homozygousEmissionMap(self):
        n = self._native
        return {int(d): n.homozygous_emissions[i]
                for i, d in enumerate(n.phys_dists)}

    def __getattr__(self, name):
        return getattr(self._native, self._ALIASES.get(name, name))


class DecodePairsReturnStruct:
    """camelCase view over the native result struct (pybind.cpp:79-88
    attribute spellings)."""

    _ALIASES = {"per_pair_MAPs": "per_pair_maps", "min_MAPs": "min_maps",
                "argmin_MAPs": "argmin_maps"}

    def __init__(self, native):
        self._native = native

    def __getattr__(self, name):
        return getattr(self._native, self._ALIASES.get(name, name))


class DecodingReturnValues:
    """pybind.cpp:71-78 field spellings."""

    def __init__(self, native):
        self._native = native

    @property
    def sumOverPairs(self):
        return self._native.sum_over_pairs

    @property
    def sumOverPairs00(self):
        return self._native.sum_over_pairs00

    @property
    def sumOverPairs01(self):
        return self._native.sum_over_pairs01

    @property
    def sumOverPairs11(self):
        return self._native.sum_over_pairs11

    @property
    def siteWasFlippedDuringFolding(self):
        return self._native.site_was_flipped

    def __getattr__(self, name):
        return getattr(self._native, name)


class ASMC:
    """ASMC facade with the reference constructor overloads and camelCase
    methods (ASMC.hpp:30-69, pybind.cpp:235-251); ``device`` as the port's
    ``ASMC`` takes it (None: "cuda")."""

    def __init__(self, params_or_in_file_root: Union[_Params, str],
                 decoding_quant_file: str = "",
                 out_file_root: str = "", device=None):
        if isinstance(params_or_in_file_root, _Params):
            params = params_or_in_file_root
        else:
            params = _Params.asmc(params_or_in_file_root,
                                  decoding_quant_file,
                                  out_file_root or params_or_in_file_root)
        self._impl = _asmc.ASMC(params, device=device)
        self._results = None

    def decodeAllInJob(self):
        return DecodingReturnValues(
            self._impl.decode_all_in_job(verbose=False))

    def decodePairs(self, hap_indices_a: Sequence, hap_indices_b: Sequence,
                    per_pair_posteriors: bool = False,
                    sum_of_posteriors: bool = False,
                    per_pair_posterior_means: bool = False,
                    per_pair_MAPs: bool = False) -> None:
        self._results = self._impl.decode_pairs(
            list(hap_indices_a), list(hap_indices_b),
            per_pair_posteriors=per_pair_posteriors,
            sum_of_posteriors=sum_of_posteriors,
            per_pair_posterior_means=per_pair_posterior_means,
            per_pair_maps=per_pair_MAPs)

    def get_copy_of_results(self) -> DecodePairsReturnStruct:
        return DecodePairsReturnStruct(copy.deepcopy(self._results))

    def get_ref_of_results(self) -> DecodePairsReturnStruct:
        return DecodePairsReturnStruct(self._results)


class FastSMC:
    """FastSMC facade (FastSMC.hpp:26-55, pybind.cpp:231-234); ``device`` as
    the port's ``FastSMC`` takes it (None: "cuda")."""

    def __init__(self, params_or_in_dir: Union[_Params, str, None] = None,
                 out_dir: Optional[str] = None, *,
                 in_dir: Optional[str] = None, device=None):
        # the reference exposes both FastSMC(params) and
        # FastSMC(in_dir=..., out_dir=...) (pybind.cpp:231-234, used
        # keyword-style in notebooks/fastsmc-minimal.ipynb)
        if in_dir is not None:
            params_or_in_dir = in_dir
        if isinstance(params_or_in_dir, _Params):
            self._params = params_or_in_dir
        else:
            if params_or_in_dir is None or out_dir is None:
                raise TypeError("FastSMC(in_dir, out_dir) needs both")
            self._params = _Params.fastsmc_defaults(
                params_or_in_dir, out_file_root=out_dir)
        self._device = device
        self._impl = None

    def run(self) -> None:
        if self._impl is None:
            self._impl = _fastsmc.FastSMC(self._params, device=self._device)
        self._impl.run(verbose=False)


class BinaryDataReader:
    """camelCase reader methods (pybind.cpp:197-200)."""

    def __init__(self, binary_file: str):
        self._it = iter(_Reader(binary_file))
        self._next = next(self._it, None)

    def moreLinesInFile(self) -> bool:
        return self._next is not None

    def getNextLine(self) -> IbdPairDataLine:
        line = self._next
        if line is None:
            raise RuntimeError("no more lines in file")
        self._next = next(self._it, None)
        return line


# ---------------------------------------------------------------------------
# Individual / PairObservations / Data / HMM (pybind.cpp:89-99, 202-230)
# ---------------------------------------------------------------------------

class Individual:
    """Two haploid genotype vectors (Individual.hpp, pybind.cpp:89-96)."""

    def __init__(self, numOfSites: int = 0):
        self.genotype1 = np.zeros(numOfSites, dtype=bool)
        self.genotype2 = np.zeros(numOfSites, dtype=bool)

    def setGenotype(self, hap: int, pos: int, val) -> None:
        if hap not in (1, 2):
            raise ValueError("hap must be 1 or 2")
        (self.genotype1 if hap == 1 else self.genotype2)[pos] = bool(val)


class PairObservations:
    """XOR / hom-minor bit views for one haplotype pair (HMM.hpp:37-46,
    pybind.cpp:97-99). Created via HMM.makePairObs."""

    __slots__ = ("iHap", "jHap", "iInd", "jInd", "obsBits", "homMinorBits")

    def __init__(self, iHap=0, jHap=0, iInd=0, jInd=0,
                 obsBits=None, homMinorBits=None):
        self.iHap, self.jHap = iHap, jHap
        self.iInd, self.jInd = iInd, jInd
        self.obsBits, self.homMinorBits = obsBits, homMinorBits


class Data:
    """camelCase panel view (pybind.cpp:202-217): Data(params) loads the
    panel; members mirror Data.hpp."""

    def __init__(self, params: Union[_Params, _NativeData]):
        self._native = params if isinstance(params, _NativeData) \
            else load_data(params)
        self._individuals = None

    @staticmethod
    def countHapLines(in_file_root: str) -> int:
        return count_hap_lines(in_file_root)

    @property
    def FamIDList(self):
        return list(self._native.fam_id_list)

    @property
    def IIDList(self):
        return list(self._native.iid_list)

    @property
    def famAndIndNameList(self):
        # Data.cpp:243: famId + "\t" + IId
        return [f"{f}\t{i}" for f, i in zip(self._native.fam_id_list,
                                            self._native.iid_list)]

    @property
    def individuals(self):
        """Individual views over the packed bitmatrix (built on demand)."""
        if self._individuals is None:
            bits = self._native.hap_bits
            out = []
            for i in range(self._native.n_ind):
                ind = Individual(0)
                ind.genotype1 = bits[2 * i].astype(bool)
                ind.genotype2 = bits[2 * i + 1].astype(bool)
                out.append(ind)
            self._individuals = out
        return self._individuals

    @property
    def sampleSize(self):
        return self._native.sample_size

    @property
    def haploidSampleSize(self):
        return self._native.n_haps

    @property
    def sites(self):
        return self._native.sites

    @property
    def decodingUsesCSFS(self):
        return self._native.decoding_uses_csfs

    @property
    def geneticPositions(self):
        return self._native.genetic_positions

    @property
    def physicalPositions(self):
        return self._native.physical_positions

    @property
    def siteWasFlippedDuringFolding(self):
        return self._native.site_was_flipped

    @property
    def recRateAtMarker(self):
        return self._native.rec_rate_at_marker


class HMM:
    """Reference HMM pybind surface (pybind.cpp:218-230, HMM.hpp:170-260):
    immediate decode / decodeSummarize, buffered decodePair(s) with
    getBatchBuffer + finishDecoding, decodeAll, makePairObs.

    Every decode runs the H100 / CUDA kernels through the port's
    ``GpuDecoder`` on ``device`` ("cuda" unless given; "cpu" runs their
    plain versions), over the window rounded up to ``bucket_len`` sites as
    the JAX package's decoder does. The observation buffer reproduces the
    reference batching contract: pairs queue until batchSize and flush
    through one decode, whose posterior sums over the batch come from the
    backward kernel's ``posterior_sums`` output."""

    def __init__(self, data, params: _Params, scalingSkip: int = 1,
                 device=None):
        self._data = data if isinstance(data, Data) else Data(data)
        self._params = params
        self._dq = _DQ.load(params.decoding_quant_file)
        self._ctx = DecodeContext.build(params, self._data._native, self._dq,
                                        scaling_skip=scalingSkip)
        self._decoder = GpuDecoder(self._ctx,
                                   "cuda" if device is None else device)
        self._batch = []
        L, K = self._data._native.sites, self._dq.states
        self._sums = np.zeros((L, K), np.float64)
        self._rv = None

    @property
    def device(self):
        return self._decoder.device

    # -- observation construction (HMM.cpp makePairObs) -------------------
    def makePairObs(self, iHap: int, ind1: int, jHap: int, ind2: int
                    ) -> PairObservations:
        obs, hom = self._ctx.pair_observations(
            self._hap_index(ind1, iHap), self._hap_index(ind2, jHap))
        return PairObservations(iHap, jHap, ind1, ind2, obs, hom)

    @staticmethod
    def _hap_index(ind: int, hap: int) -> int:
        return 2 * ind + (hap - 1)

    def _decode_window(self, pairs, from_pos: int, to_pos: int,
                       outputs: BwdOutputs = BwdOutputs()) -> dict:
        """The requested outputs for PairObservations over [from, to), on
        the host at ``GpuDecoder.decode_pairs``' shapes ([T, K, P]
        posterior, [T, K] sums), cut to the window's T sites."""
        pa = np.array([self._hap_index(o.iInd, o.iHap) for o in pairs],
                      np.int32)
        pb = np.array([self._hap_index(o.jInd, o.jHap) for o in pairs],
                      np.int32)
        r = self._decoder.decode_pairs(pa, pb, from_pos,
                                       bucket_len(to_pos - from_pos),
                                       outputs)
        return {k: v[:to_pos - from_pos].cpu().numpy() for k, v in r.items()}

    # -- immediate decode (HMM.cpp:decode) ---------------------------------
    def decode(self, observations: PairObservations,
               from_pos: int = 0, to_pos: Optional[int] = None):
        """Posterior [K, T] for one pair (reference returns [state][pos])."""
        to_pos = self._data.sites if to_pos is None else to_pos
        post = self._decode_window([observations], from_pos,
                                   to_pos)["posterior"][:, :, 0]
        if self._params.do_posterior_sums:
            self._sums[from_pos:to_pos] += post
        return post.T

    def decodeSummarize(self, observations: PairObservations):
        """(posterior_map, posterior_mean) per position (HMM.cpp:1498-1517)."""
        posterior = self.decode(observations)          # [K, T]
        times = np.asarray(self._dq.expected_times)
        posterior_mean = times @ posterior
        posterior_map = times[np.argmax(posterior, axis=0)]
        return posterior_map.astype(np.float32), \
            posterior_mean.astype(np.float32)

    # -- buffered batch decoding (HMM.cpp:403-530) -------------------------
    def _add_to_batch(self, obs: PairObservations) -> None:
        self._batch.append(obs)
        if len(self._batch) >= self._params.batch_size:
            self._flush()

    def _flush(self) -> None:
        if not self._batch:
            return
        sums = self._decode_window(
            self._batch, 0, self._data.sites,
            BwdOutputs(posterior=False, posterior_sums=True))
        if self._params.do_posterior_sums:
            self._sums += sums["posterior_sums"]
        self._batch = []

    def decodePair(self, i: int, j: int) -> None:
        """2x2 hap combos across individuals; one cross-chromosome pair
        within an individual (HMM.cpp:413-440)."""
        if i != j:
            for iHap in (1, 2):
                for jHap in (1, 2):
                    self._add_to_batch(self.makePairObs(iHap, i, jHap, j))
        else:
            self._add_to_batch(self.makePairObs(1, i, 2, i))

    def decodePairs(self, individualsA: Sequence[int],
                    individualsB: Sequence[int]) -> None:
        if len(individualsA) != len(individualsB):
            raise RuntimeError("vector of A indicies must be the same size "
                               "as vector of B indicies")
        for i, j in zip(individualsA, individualsB):
            self.decodePair(int(i), int(j))

    def decodeHapPair(self, i: int, j: int) -> None:
        iInd, iHap = divmod(int(i), 2)
        jInd, jHap = divmod(int(j), 2)
        self._add_to_batch(self.makePairObs(iHap + 1, iInd, jHap + 1, jInd))

    def decodeHapPairs(self, hapsA: Sequence[int],
                       hapsB: Sequence[int]) -> None:
        if len(hapsA) != len(hapsB):
            raise RuntimeError("vector of A indices must be the same size "
                               "as vector of B indices")
        for a, b in zip(hapsA, hapsB):
            self.decodeHapPair(a, b)

    def getBatchBuffer(self):
        return self._batch

    def finishDecoding(self) -> None:
        self._flush()

    # -- all-pairs (HMM.cpp:283-380) ---------------------------------------
    def decodeAll(self, jobs: int, jobInd: int) -> None:
        p = dataclasses.replace(self._params, jobs=jobs, job_ind=jobInd,
                                do_posterior_sums=True)
        impl = _asmc.ASMC(p, data=self._data._native, dq=self._dq,
                          device=self.device)
        self._rv = impl.decode_all_in_job(verbose=False)
        self._sums = self._rv.sum_over_pairs

    def getDecodingReturnValues(self) -> DecodingReturnValues:
        if self._rv is None:
            self._rv = _asmc.DecodingReturnValues(
                sum_over_pairs=self._sums,
                sites=self._data.sites, states=self._dq.states,
                site_was_flipped=self._data._native.site_was_flipped)
        return DecodingReturnValues(self._rv)

    def getDecodingQuantities(self) -> DecodingQuantities:
        return DecodingQuantities(self._dq)

    def getStateThreshold(self) -> int:
        """Generation threshold -> state threshold (HMM.cpp:505-514)."""
        disc = self._dq.discretization
        t = float(self._params.time)
        result = 0
        while result < self._dq.states and disc[result] < t:
            result += 1
        return result
