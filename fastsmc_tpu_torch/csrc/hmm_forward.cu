// Forward recursion of the batched pair HMM (array mode, exact profile).
//
// Replaces the Pallas TPU kernel `_make_fwd_kernel`, array branch
// (fastsmc_tpu/engine/kernels.py:96-165, launched at :588):
//   alpha_0 = isp * em_0, divided by its column sum;
//   alpha_t = norm_mask(em_t * (Mf[ops[t]] @ alpha_{t-1})),
// where norm_mask multiplies by 1/sum_k where mask[t] != 0 (the reference's
// scalingSkip) and alpha is stored [T][KP][P] with P contiguous.
//
// Bound on an H100: the per-site K x K operator product is ~5.2k FMA per
// pair and site against ~300 bytes of alpha written, so the kernel is bound
// by FP32 issue and shared-memory bandwidth, not device memory. Design: one
// block per 32 pairs walks the whole window; the carry stays on chip (the
// normalised carry in shared memory, each thread's rows in registers), the
// site's operator is staged once in shared memory and read as a warp-wide
// broadcast, and the only device-memory traffic per site is the operator
// (an L2 hit: the panel's operator table is a few MB), one emission row and
// the coalesced alpha stores. Later work: double-buffer the operator load
// and give each thread more pairs to cut shared-memory reads per FMA.
#include "hmm_common.cuh"

namespace fastsmc {
namespace {

template <int RPW>
__global__ void __launch_bounds__(kThreads)
    hmm_forward_kernel(const float* __restrict__ Mf, int G,
                       const float* __restrict__ em,   // [T][3][KP]
                       const float* __restrict__ obs,  // [T][2][P]
                       const float* __restrict__ isp,  // [KP]
                       const int* __restrict__ ops,    // [T]
                       const int* __restrict__ mask,   // [T]
                       float* __restrict__ alpha,      // [T][KP][P]
                       int T, int P) {
  constexpr int KP = RPW * kWarps;
  extern __shared__ float4 smem4[];
  float* sM = reinterpret_cast<float*>(smem4);  // [KP][KP] operator of site t
  float* sC = sM + KP * KP;                     // [KP][kPairs] carry alpha_{t-1}
  float* sRed = sC + KP * kPairs;               // [kWarps][kPairs]
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
      if (live) alpha[k * Pz + p] = c[i];
      sC[k * kPairs + lane] = c[i];
    }
  }
  for (int t = 1; t < T; ++t) {
    stage_operator(sM, Mf, ops[t], G, KP);
    __syncthreads();  // operator and carry visible; last step's sRed reads done
    float acc[RPW];
    matvec<RPW>(acc, sM, sC, lane, warp);
    const float* em_t = em + static_cast<size_t>(t) * 3 * KP;
    const float oz = live ? obs[(2 * static_cast<size_t>(t)) * Pz + p] : 1.f;
    const float oh = live ? obs[(2 * static_cast<size_t>(t) + 1) * Pz + p] : 0.f;
    float part = 0.f;
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      c[i] = acc[i] * emission(em_t, warp + kWarps * i, KP, oz, oh);
      part += c[i];
    }
    const float s = column_sum(sRed, part, lane, warp);
    const float inv = mask[t] != 0 ? 1.f / s : 1.f;  // kernels.py:147
    float* alpha_t = alpha + static_cast<size_t>(t) * KP * Pz;
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int k = warp + kWarps * i;
      c[i] = c[i] * inv;
      if (live) alpha_t[k * Pz + p] = c[i];
      sC[k * kPairs + lane] = c[i];
    }
  }
}

template <int RPW>
int launch_forward(const float* Mf, int G, const float* em, const float* obs,
                   const float* isp, const int* ops, const int* mask,
                   float* alpha, int T, int P, cudaStream_t stream) {
  const size_t smem = shared_bytes(RPW * kWarps, 1);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        hmm_forward_kernel<RPW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((P + kPairs - 1) / kPairs);
  hmm_forward_kernel<RPW><<<grid, kThreads, smem, stream>>>(
      Mf, G, em, obs, isp, ops, mask, alpha, T, P);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace fastsmc

// Launch the forward kernel on `stream` (device `device`); returns the
// cudaError_t of the launch. KP must be a multiple of 8, at most 128.
extern "C" int fastsmc_hmm_forward(const float* Mf, int G, const float* em,
                                   const float* obs, const float* isp,
                                   const int* ops, const int* mask,
                                   float* alpha, int T, int P, int KP,
                                   int device, void* stream) {
  using namespace fastsmc;
  if (T <= 0 || P <= 0 || G <= 0 || KP % kWarps != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  FASTSMC_DISPATCH_RPW(KP / kWarps, launch_forward, Mf, G, em, obs, isp, ops,
                       mask, alpha, T, P, static_cast<cudaStream_t>(stream))
}
