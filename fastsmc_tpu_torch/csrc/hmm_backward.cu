// Backward recursion + posterior combine of the batched pair HMM
// (array mode, exact profile).
//
// Replaces the Pallas TPU kernel `_make_bwd_kernel`, array branch
// (fastsmc_tpu/engine/kernels.py:185-293, launched at :681), for the two
// outputs the FastSMC main path reads:
//   beta_{T-1} = 1/K on real states, 0 on padded ones;
//   beta_pos   = norm_mask(Mb[ops[pos]] @ (beta_{pos+1} * em_{pos+1}));
//   post_pos   = alpha_pos * beta_pos / sum_k(alpha_pos * beta_pos);
//   posterior[pos][k][p] = post (optional),
//   threshold_sums[pos][p] = sum_{k < state_threshold} post (optional).
// As in kernels.py:597-603, ops and the emission/observation rows are taken
// at pos+1 for the step that produces beta_pos, and mask[pos] says whether
// site t0+pos is a scaling site.
//
// Bound on an H100: the same FP32 operator product as the forward pass
// (~5.2k FMA per pair and site) plus reading alpha and writing the
// posterior (~600 bytes per pair and site), still compute-bound. Design:
// the forward kernel's tile (one block per 32 pairs, the window as a loop
// inside the block), walking pos = T-1 .. 0. beta stays in registers; the
// product's operand beta_{pos+1} * em_{pos+1} is the only thing written to
// shared memory. The posterior sums reduce across warps through shared
// memory, so the [T, K, P] posterior is written only when it is asked for.
#include "hmm_common.cuh"

namespace fastsmc {
namespace {

template <int RPW>
__global__ void __launch_bounds__(kThreads)
    hmm_backward_kernel(const float* __restrict__ Mb, int G,
                        const float* __restrict__ em,     // [T][3][KP]
                        const float* __restrict__ obs,    // [T][2][P]
                        const float* __restrict__ alpha,  // [T][KP][P]
                        const int* __restrict__ ops,      // [T]
                        const int* __restrict__ mask,     // [T]
                        float* __restrict__ post,         // [T][KP][P] or null
                        float* __restrict__ th,           // [T][P] or null
                        int T, int P, int K, int state_threshold) {
  constexpr int KP = RPW * kWarps;
  extern __shared__ float4 smem4[];
  float* sM = reinterpret_cast<float*>(smem4);  // [KP][KP] operator of gap pos
  float* sV = sM + KP * KP;                     // [KP][kPairs] beta*em at pos+1
  float* sRed0 = sV + KP * kPairs;              // beta normalisation
  float* sRed1 = sRed0 + kWarps * kPairs;       // posterior normalisation
  float* sRed2 = sRed1 + kWarps * kPairs;       // threshold sums
  const int lane = threadIdx.x % kPairs;
  const int warp = threadIdx.x / kPairs;
  const int p = blockIdx.x * kPairs + lane;
  const bool live = p < P;
  const size_t Pz = static_cast<size_t>(P);

  // lastBeta = 1/K on real states (HMM.cpp:886-897), rounded from double
  // as the JAX package does
  const float beta0 = static_cast<float>(1.0 / static_cast<double>(K));
  float b[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) b[i] = (warp + kWarps * i) < K ? beta0 : 0.f;

  for (int pos = T - 1; pos >= 0; --pos) {
    if (pos < T - 1) {
      stage_operator(sM, Mb, ops[pos], G, KP);
      __syncthreads();  // operator and operand visible
      float acc[RPW];
      matvec<RPW>(acc, sM, sV, lane, warp);
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < RPW; ++i) part += acc[i];
      const float s = column_sum(sRed0, part, lane, warp);
      const float inv = mask[pos] != 0 ? 1.f / s : 1.f;  // kernels.py:242
#pragma unroll
      for (int i = 0; i < RPW; ++i) b[i] = acc[i] * inv;
    }

    // combine (kernels.py:262-278)
    const float* alpha_t = alpha + static_cast<size_t>(pos) * KP * Pz;
    float q[RPW];
    float part = 0.f;
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int k = warp + kWarps * i;
      q[i] = live ? alpha_t[k * Pz + p] * b[i] : 0.f;
      part += q[i];
    }
    const float s = column_sum(sRed1, part, lane, warp);
    float* post_t = post ? post + static_cast<size_t>(pos) * KP * Pz : nullptr;
    float tpart = 0.f;
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int k = warp + kWarps * i;
      q[i] = q[i] / s;
      if (post_t && live) post_t[k * Pz + p] = q[i];
      if (k < state_threshold) tpart += q[i];
    }
    if (th) {
      const float tsum = column_sum(sRed2, tpart, lane, warp);
      if (warp == 0 && live) th[static_cast<size_t>(pos) * Pz + p] = tsum;
    }

    // operand of the next (earlier) site's product: beta_pos * em_pos
    if (pos > 0) {
      const float* em_t = em + static_cast<size_t>(pos) * 3 * KP;
      const float oz = live ? obs[(2 * static_cast<size_t>(pos)) * Pz + p] : 1.f;
      const float oh = live ? obs[(2 * static_cast<size_t>(pos) + 1) * Pz + p] : 0.f;
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const int k = warp + kWarps * i;
        sV[k * kPairs + lane] = b[i] * emission(em_t, k, KP, oz, oh);
      }
    }
  }
}

template <int RPW>
int launch_backward(const float* Mb, int G, const float* em, const float* obs,
                    const float* alpha, const int* ops, const int* mask,
                    float* post, float* th, int T, int P, int K,
                    int state_threshold, cudaStream_t stream) {
  const size_t smem = shared_bytes(RPW * kWarps, 3);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        hmm_backward_kernel<RPW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((P + kPairs - 1) / kPairs);
  hmm_backward_kernel<RPW><<<grid, kThreads, smem, stream>>>(
      Mb, G, em, obs, alpha, ops, mask, post, th, T, P, K, state_threshold);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace fastsmc

// Launch the backward+combine kernel on `stream` (device `device`); `post`
// and `th` may each be null (output not wanted). Returns the cudaError_t of
// the launch. KP must be a multiple of 8, at most 128, with K <= KP.
extern "C" int fastsmc_hmm_backward(const float* Mb, int G, const float* em,
                                    const float* obs, const float* alpha,
                                    const int* ops, const int* mask,
                                    float* post, float* th, int T, int P,
                                    int K, int KP, int state_threshold,
                                    int device, void* stream) {
  using namespace fastsmc;
  if (T <= 0 || P <= 0 || G <= 0 || K <= 0 || K > KP || KP % kWarps != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  FASTSMC_DISPATCH_RPW(KP / kWarps, launch_backward, Mb, G, em, obs, alpha,
                       ops, mask, post, th, T, P, K, state_threshold,
                       static_cast<cudaStream_t>(stream))
}
