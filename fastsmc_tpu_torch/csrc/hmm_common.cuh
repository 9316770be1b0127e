// Shared pieces of the two decode kernels (hmm_forward.cu, hmm_backward.cu).
//
// Layout of one backward thread block: kWarps warps x kPairs lanes. Lane l
// owns pair column p = blockIdx.x * kPairs + l; warp w owns the state rows
// k = w, w + kWarps, ..., w + kWarps * (RPW - 1), so KP = kWarps * RPW
// padded states (K=69 -> RPW=9, KP=72). The forward kernel lays its pairs
// out on tensor-core fragments instead (hmm_forward.cu). The genome axis
// runs as a loop inside the block: blocks carry nothing between them.
//
// The backward's arithmetic is float32 with fmaf in the operator products;
// there is no fast-math and no __fdividef on this path. On the approximate
// profiles (fast, turbo) both operands of every product are rounded to bf16
// (nearest even) before the f32 product, which is the TPU's single-pass
// matrix unit (fastsmc_tpu/engine/kernels.py:59-73): a product of two bf16
// values is exact in f32, so only the order of the f32 sums differs from
// the TPU's. The forward's exact profile splits each operand into two TF32
// values (3xTF32, never a single TF32 pass).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>
#include <utility>

namespace fastsmc {

constexpr int kWarps = 8;
constexpr int kPairs = 32;
constexpr int kThreads = kWarps * kPairs;

// Profile codes of the C interface (kernels.py _PROFILE_CODE).
constexpr int kExact = 0;
constexpr int kFast = 1;   // f32 operators, rounded to bf16 as they are staged
constexpr int kTurbo = 2;  // bf16 operators
// Sites per normalisation block on the approximate profiles in array mode
// (kernels.py BLOCK_SITES): the carry is normalised only at the last site
// of each block (and at the forward pass's site 0).
constexpr int kBlockSites = 8;

// The stored forward messages: f32 on the exact profile, bf16 otherwise.
template <bool APPROX>
using AlphaT = std::conditional_t<APPROX, __nv_bfloat16, float>;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// A product operand as it is written to shared memory: rounded to bf16 on
// the approximate profiles, as it is on the exact one.
template <bool APPROX>
__device__ __forceinline__ float operand(float x) {
  if constexpr (APPROX) return round_bf16(x);
  else return x;
}

// An alpha element from / to f32. Conversions of values only: the kernels
// load and store alpha through their own __restrict__ parameters, since
// nvcc moves the loads of alpha past the stores of the outputs only then
// (with a helper that takes the pointer, even a __restrict__ one, the
// backward kernel fell from 126 to 79 registers on an H100 build).
__device__ __forceinline__ float alpha_to_float(float v) { return v; }
__device__ __forceinline__ float alpha_to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <bool APPROX>
__device__ __forceinline__ AlphaT<APPROX> float_to_alpha(float v) {
  if constexpr (APPROX) return __float2bfloat16_rn(v);
  else return v;
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

// The bf16 pair in one 32-bit word as two floats (element 2i in the low
// half): exact, a bf16 is the top half of an f32.
__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// Copy operator `op` into shared memory on the approximate profiles: its
// values rounded to bf16, held as f32. `M` is [G][KP][KP] f32 (fast,
// rounded here) or bf16 (turbo, already rounded by the host), so both
// profiles stage the same values.
__device__ __forceinline__ void stage_operator_bf16(float* __restrict__ sM,
                                                    const float* __restrict__ M,
                                                    bool bf16_store, int op,
                                                    int G, int KP) {
  if (op < 0 || op >= G) __trap();
  const size_t base = static_cast<size_t>(op) * KP * KP;
  float4* dst = reinterpret_cast<float4*>(sM);
  if (bf16_store) {
    const uint4* src = reinterpret_cast<const uint4*>(
        reinterpret_cast<const __nv_bfloat16*>(M) + base);
    for (int i = threadIdx.x; i < KP * KP / 8; i += kThreads) {
      const uint4 u = __ldg(src + i);
      dst[2 * i] = make_float4(bf16_lo(u.x), bf16_hi(u.x), bf16_lo(u.y), bf16_hi(u.y));
      dst[2 * i + 1] = make_float4(bf16_lo(u.z), bf16_hi(u.z), bf16_lo(u.w), bf16_hi(u.w));
    }
  } else {
    const float4* src = reinterpret_cast<const float4*>(M + base);
    for (int i = threadIdx.x; i < KP * KP / 4; i += kThreads) {
      const float4 v = __ldg(src + i);
      dst[i] = make_float4(round_bf16(v.x), round_bf16(v.y), round_bf16(v.z),
                           round_bf16(v.w));
    }
  }
}

// Stage an operator as the profile reads it.
template <bool APPROX>
__device__ __forceinline__ void stage(float* __restrict__ sM,
                                      const float* __restrict__ M,
                                      bool bf16_store, int op, int G, int KP) {
  if constexpr (APPROX) stage_operator_bf16(sM, M, bf16_store, op, G, KP);
  else stage_operator(sM, M, op, G, KP);
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

// Sum of v over the warp's 32 lanes by a fixed xor butterfly: every lane
// gets the same bits, and the order never changes from run to run.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = kPairs / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Bulk copies into shared memory, completed on an mbarrier (both kernels'
// operator rings).
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One thread: the barrier expects `bytes` more, and the bulk-copy engine
// moves them from global `src` to shared `dst` (both 16-byte aligned, a
// multiple of 16 bytes), completing on the barrier.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void wait_phase(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  }
}

// Call `f(std::integral_constant<int, RPW>{})` for the row count `rpw` in
// 1..16 (K <= 128): each instantiates its kernels for that RPW.
template <typename F, int... R>
int dispatch_rpw_impl(int rpw, F&& f, std::integer_sequence<int, R...>) {
  int rc = static_cast<int>(cudaErrorInvalidValue);
  (void)((rpw == R + 1 ? (rc = f(std::integral_constant<int, R + 1>{}), true)
                       : false) || ...);
  return rc;
}

template <typename F>
int dispatch_rpw(int rpw, F&& f) {
  return dispatch_rpw_impl(rpw, f, std::make_integer_sequence<int, 16>{});
}

// Launch-time check of a variant's shared memory: above 48 KB a kernel must
// opt in.
template <typename Kernel>
int allow_shared(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

}  // namespace fastsmc
