// Shared pieces of the two decode kernels (hmm_forward.cu, hmm_backward.cu).
//
// Layout of one thread block: kWarps warps x kPairs lanes. Lane l owns pair
// column p = blockIdx.x * kPairs + l; warp w owns the state rows
// k = w, w + kWarps, ..., w + kWarps * (RPW - 1), so KP = kWarps * RPW
// padded states (K=69 -> RPW=9, KP=72). The genome axis runs as a loop
// inside the block: blocks carry nothing between them.
//
// All arithmetic is float32 with fmaf in the operator products; there is no
// fast-math, no __fdividef and no TF32 anywhere on this path.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace fastsmc {

constexpr int kWarps = 8;
constexpr int kPairs = 32;
constexpr int kThreads = kWarps * kPairs;

// Dynamic shared memory a kernel needs for KP states and n_red reduction
// buffers: the staged operator [KP][KP], one [KP][kPairs] operand and the
// [kWarps][kPairs] partial column sums.
inline size_t shared_bytes(int KP, int n_red) {
  return sizeof(float) * (static_cast<size_t>(KP) * KP + KP * kPairs +
                          n_red * kWarps * kPairs);
}

// Emission of state k for one pair (HMM.cpp:827-828):
//   em1 + em0minus1 * obsIsZero + em2minus0 * obsIsHomMinor.
// em_t points at the site's [3][KP] component rows.
__device__ __forceinline__ float emission(const float* __restrict__ em_t,
                                          int k, int KP, float oz, float oh) {
  return em_t[k] + em_t[KP + k] * oz + em_t[2 * KP + k] * oh;
}

// Copy operator `op` ([KP][KP] f32, 16-byte aligned) into shared memory.
// An index outside the table is a caller bug: stop the kernel.
__device__ __forceinline__ void stage_operator(float* __restrict__ sM,
                                               const float* __restrict__ M,
                                               int op, int G, int KP) {
  if (op < 0 || op >= G) __trap();
  const float4* src =
      reinterpret_cast<const float4*>(M + static_cast<size_t>(op) * KP * KP);
  float4* dst = reinterpret_cast<float4*>(sM);
  for (int i = threadIdx.x; i < KP * KP / 4; i += kThreads) dst[i] = __ldg(src + i);
}

// acc[i] = sum_j sM[k_i][j] * sV[j][lane], j ascending, for this thread's rows.
template <int RPW>
__device__ __forceinline__ void matvec(float (&acc)[RPW],
                                       const float* __restrict__ sM,
                                       const float* __restrict__ sV, int lane,
                                       int warp) {
  constexpr int KP = RPW * kWarps;
#pragma unroll
  for (int i = 0; i < RPW; ++i) acc[i] = 0.f;
#pragma unroll 4
  for (int j = 0; j < KP; ++j) {
    const float v = sV[j * kPairs + lane];
#pragma unroll
    for (int i = 0; i < RPW; ++i)
      acc[i] = fmaf(sM[(warp + kWarps * i) * KP + j], v, acc[i]);
  }
}

// Sum of `part` over the block's warps for this thread's pair column.
// Contains the barrier that orders every earlier shared-memory read of this
// step before the writes that follow it.
__device__ __forceinline__ float column_sum(float* __restrict__ sRed, float part,
                                            int lane, int warp) {
  sRed[warp * kPairs + lane] = part;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s += sRed[w * kPairs + lane];
  return s;
}

}  // namespace fastsmc

// Instantiate `launch<RPW>(args...)` for the row counts 1..16 (K <= 128).
#define FASTSMC_DISPATCH_RPW(rpw, launch, ...)                     \
  switch (rpw) {                                                   \
    case 1: return launch<1>(__VA_ARGS__);                         \
    case 2: return launch<2>(__VA_ARGS__);                         \
    case 3: return launch<3>(__VA_ARGS__);                         \
    case 4: return launch<4>(__VA_ARGS__);                         \
    case 5: return launch<5>(__VA_ARGS__);                         \
    case 6: return launch<6>(__VA_ARGS__);                         \
    case 7: return launch<7>(__VA_ARGS__);                         \
    case 8: return launch<8>(__VA_ARGS__);                         \
    case 9: return launch<9>(__VA_ARGS__);                         \
    case 10: return launch<10>(__VA_ARGS__);                       \
    case 11: return launch<11>(__VA_ARGS__);                       \
    case 12: return launch<12>(__VA_ARGS__);                       \
    case 13: return launch<13>(__VA_ARGS__);                       \
    case 14: return launch<14>(__VA_ARGS__);                       \
    case 15: return launch<15>(__VA_ARGS__);                       \
    case 16: return launch<16>(__VA_ARGS__);                       \
    default: return static_cast<int>(cudaErrorInvalidValue);       \
  }
