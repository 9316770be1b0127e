// Forward recursion of the batched pair HMM: array and sequence mode, on
// the exact, fast and turbo profiles.
//
// Replaces the Pallas TPU kernel `_make_fwd_kernel`
// (fastsmc_tpu/engine/kernels.py:96-165, launched at :564 for sequence mode
// and :588 for array mode):
//   alpha_0 = isp * em_0, divided by its column sum;
//   array:    alpha_t = norm(em_t * (Mf[ops[t]] @ alpha_{t-1}));
//   sequence: mid     = hem_t * (Mf[ops[t]] @ alpha_{t-1})   (homozygous
//             alpha_t = norm(em_t * (Mf[rops[t]] @ mid))      half-step, then
//                                                             marker step),
// where norm multiplies by 1/sum_k where mask[t] != 0 (the reference's
// scalingSkip) and alpha is stored [T][KP][P] with P contiguous. On the
// approximate profiles (hmm_common.cuh) the product operands are rounded to
// bf16, alpha is stored as bf16, and in array mode norm runs only at the
// last site of each kBlockSites-site block (kernels.py:135-148).
//
// Bound on an H100: the per-site K x K operator product (two in sequence
// mode) is ~5.2k FMA per pair and site against ~300 bytes of alpha written
// (~150 in bf16), so the kernel is bound by FP32 issue and shared-memory
// bandwidth, not device memory. Design: one block per 32 pairs walks the
// whole window; the carry stays on chip (the normalised carry in shared
// memory, each thread's rows in registers), the site's operator(s) are
// staged once in shared memory and read as a warp-wide broadcast, and the
// only device-memory traffic per site is the operators (L2 hits: the
// panel's operator table is a few MB), one emission row and the coalesced
// alpha stores. In sequence mode the half-step's result passes through
// shared memory as the second product's operand, one barrier more per site.
// Later work: tensor-core products for the bf16 profiles, double-buffered
// operator loads, more pairs per thread.
#include "hmm_common.cuh"

namespace fastsmc {
namespace {

template <int RPW, bool SEQ, bool APPROX>
__global__ void __launch_bounds__(kThreads)
    hmm_forward_kernel(const float* __restrict__ Mf, int G,
                       const float* __restrict__ em,   // [T][3][KP]
                       const float* __restrict__ obs,  // [T][2][P]
                       const float* __restrict__ isp,  // [KP]
                       const int* __restrict__ ops,    // [T]
                       const int* __restrict__ mask,   // [T]
                       AlphaT<APPROX>* __restrict__ alpha,  // [T][KP][P]
                       int T, int P,
                       const int* __restrict__ rops,   // [T], SEQ only
                       const float* __restrict__ hem,  // [T][KP], SEQ only
                       bool op_bf16) {                 // Mf is bf16 (turbo)
  constexpr int KP = RPW * kWarps;
  // block normalisation: the approximate profiles in array mode
  // (kernels.py:396-398)
  constexpr bool kNormBlock = APPROX && !SEQ;
  extern __shared__ float4 smem4[];
  float* sM = reinterpret_cast<float*>(smem4);  // [KP][KP] operator of site t
  float* sC = sM + KP * KP;                     // [KP][kPairs] carry alpha_{t-1}
  float* sRed = sC + KP * kPairs;               // [kWarps][kPairs]
  float* sM2 = sRed + kWarps * kPairs;          // SEQ: [KP][KP] rate operator
  float* sMid = sM2 + KP * KP;                  // SEQ: [KP][kPairs] half-step
  const int lane = threadIdx.x % kPairs;
  const int warp = threadIdx.x / kPairs;
  const int p = blockIdx.x * kPairs + lane;
  const bool live = p < P;
  const size_t Pz = static_cast<size_t>(P);

  float c[RPW];
  {
    // site 0 (kernels.py:152-156)
    const float oz = live ? obs[p] : 1.f;
    const float oh = live ? obs[Pz + p] : 0.f;
    float part = 0.f;
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int k = warp + kWarps * i;
      c[i] = isp[k] * emission(em, k, KP, oz, oh);
      part += c[i];
    }
    const float s = column_sum(sRed, part, lane, warp);
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int k = warp + kWarps * i;
      c[i] = c[i] / s;
      if (live) alpha[k * Pz + p] = float_to_alpha<APPROX>(c[i]);
      sC[k * kPairs + lane] = operand<APPROX>(c[i]);
    }
  }
  for (int t = 1; t < T; ++t) {
    stage<APPROX>(sM, Mf, op_bf16, ops[t], G, KP);
    if constexpr (SEQ) stage<APPROX>(sM2, Mf, op_bf16, rops[t], G, KP);
    __syncthreads();  // operators and carry visible; last step's sRed reads done
    float acc[RPW];
    matvec<RPW>(acc, sM, sC, lane, warp);
    if constexpr (SEQ) {
      // homozygous half-step (kernels.py:129-133)
      const float* hem_t = hem + static_cast<size_t>(t) * KP;
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const int k = warp + kWarps * i;
        sMid[k * kPairs + lane] = operand<APPROX>(acc[i] * hem_t[k]);
      }
      __syncthreads();  // half-step visible; last step's sMid reads done
      matvec<RPW>(acc, sM2, sMid, lane, warp);
    }
    const float* em_t = em + static_cast<size_t>(t) * 3 * KP;
    const float oz = live ? obs[(2 * static_cast<size_t>(t)) * Pz + p] : 1.f;
    const float oh = live ? obs[(2 * static_cast<size_t>(t) + 1) * Pz + p] : 0.f;
    float part = 0.f;
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      c[i] = acc[i] * emission(em_t, warp + kWarps * i, KP, oz, oh);
      part += c[i];
    }
    float inv;
    if constexpr (kNormBlock) {
      if (t % kBlockSites == kBlockSites - 1) {
        inv = 1.f / column_sum(sRed, part, lane, warp);  // kernels.py:145
      } else {
        __syncthreads();  // every warp's reads of sC done before it is rewritten
        inv = 1.f;
      }
    } else {
      const float s = column_sum(sRed, part, lane, warp);
      inv = mask[t] != 0 ? 1.f / s : 1.f;  // kernels.py:147
    }
    AlphaT<APPROX>* alpha_t = alpha + static_cast<size_t>(t) * KP * Pz;
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int k = warp + kWarps * i;
      c[i] = c[i] * inv;
      if (live) alpha_t[k * Pz + p] = float_to_alpha<APPROX>(c[i]);
      sC[k * kPairs + lane] = operand<APPROX>(c[i]);
    }
  }
}

struct ForwardArgs {
  const float* Mf;
  int G;
  const float* em;
  const float* obs;
  const float* isp;
  const int* ops;
  const int* rops;
  const float* hem;
  const int* mask;
  void* alpha;
  int T, P;
  bool op_bf16;
};

template <int RPW, bool SEQ, bool APPROX>
int launch_forward(const ForwardArgs& a, cudaStream_t stream) {
  constexpr int KP = RPW * kWarps;
  const size_t smem =
      shared_bytes(KP, 1) + (SEQ ? sizeof(float) * (KP * KP + KP * kPairs) : 0);
  auto* kernel = hmm_forward_kernel<RPW, SEQ, APPROX>;
  const int rc = allow_shared(kernel, smem);
  if (rc != 0) return rc;
  const dim3 grid((a.P + kPairs - 1) / kPairs);
  kernel<<<grid, kThreads, smem, stream>>>(
      a.Mf, a.G, a.em, a.obs, a.isp, a.ops, a.mask,
      static_cast<AlphaT<APPROX>*>(a.alpha), a.T, a.P, a.rops, a.hem,
      a.op_bf16);
  return static_cast<int>(cudaGetLastError());
}

template <bool SEQ, bool APPROX>
int forward_variant(const ForwardArgs& a, int rpw, cudaStream_t stream) {
  return dispatch_rpw(rpw, [&](auto r) {
    return launch_forward<decltype(r)::value, SEQ, APPROX>(a, stream);
  });
}

}  // namespace
}  // namespace fastsmc

// Launch the forward kernel on `stream` (device `device`); returns the
// cudaError_t of the launch. `profile` is kExact, kFast or kTurbo (Mf f32,
// f32, bf16; alpha f32, bf16, bf16). Sequence mode when `rops` and `hem`
// are given, array mode when both are null. KP must be a multiple of 8, at
// most 128.
extern "C" int fastsmc_hmm_forward(const void* Mf, int profile, int G,
                                   const float* em, const float* obs,
                                   const float* isp, const int* ops,
                                   const int* rops, const float* hem,
                                   const int* mask, void* alpha, int T, int P,
                                   int KP, int device, void* stream) {
  using namespace fastsmc;
  if (T <= 0 || P <= 0 || G <= 0 || KP % kWarps != 0 || profile < kExact ||
      profile > kTurbo || (rops == nullptr) != (hem == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const ForwardArgs a{static_cast<const float*>(Mf), G, em, obs, isp, ops,
                      rops, hem, mask, alpha, T, P, profile == kTurbo};
  const int rpw = KP / kWarps;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool seq = rops != nullptr;
  if (profile == kExact)
    return seq ? forward_variant<true, false>(a, rpw, s)
               : forward_variant<false, false>(a, rpw, s);
  return seq ? forward_variant<true, true>(a, rpw, s)
             : forward_variant<false, true>(a, rpw, s);
}
