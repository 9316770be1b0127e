// Over-pairs sums of the backward kernel: add its per-block partials.
//
// Completes the over-pairs outputs of the Pallas TPU kernel
// `_make_bwd_kernel` (fastsmc_tpu/engine/kernels.py:267-268 posterior_sums,
// :279-291 major_minor_sums), which sums over all pairs inside its block.
// hmm_backward.cu leaves one partial per 32-pair block; this kernel computes
//   out[e] = sum_{b = 0 .. nblk-1} part[b][e]
// in that fixed order, in double, rounded once to float: two runs give the
// same bits, and there are no float atomics.
//
// Bound on an H100: device memory, nblk * E floats read once (~0.6 GB for
// E = 8192 x 72 at 256 blocks). Design: one thread per element e, so each
// step of the loop over b is one coalesced read across the warp.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kReduceThreads = 256;

__global__ void __launch_bounds__(kReduceThreads)
    block_reduce_kernel(const float* __restrict__ part,  // [nblk][E]
                        float* __restrict__ out,         // [E]
                        int nblk, int64_t E) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kReduceThreads + threadIdx.x;
  if (e >= E) return;
  double s = 0.0;
  for (int b = 0; b < nblk; ++b) s += static_cast<double>(part[b * E + e]);
  out[e] = static_cast<float>(s);
}

}  // namespace

// Launch the block reduction on `stream` (device `device`); returns the
// cudaError_t of the launch.
extern "C" int fastsmc_block_reduce(const float* part, float* out, int nblk,
                                    int64_t E, int device, void* stream) {
  if (nblk <= 0 || E <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t blocks = (E + kReduceThreads - 1) / kReduceThreads;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  block_reduce_kernel<<<static_cast<unsigned>(blocks), kReduceThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(part, out, nblk, E);
  return static_cast<int>(cudaGetLastError());
}
