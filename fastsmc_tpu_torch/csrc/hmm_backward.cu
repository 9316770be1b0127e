// Backward recursion + posterior combine of the batched pair HMM: array and
// sequence mode, on the exact, fast and turbo profiles.
//
// Replaces the Pallas TPU kernel `_make_bwd_kernel`
// (fastsmc_tpu/engine/kernels.py:185-293, launched at :681), with all six
// of its outputs, each selected per launch by a non-null pointer:
//   beta_{T-1} = 1/K on real states, 0 on padded ones;
//   array:    beta_pos = norm_mask(Mb[ops[pos]] @ (beta_{pos+1} * em_{pos+1}));
//   sequence: mid      = Mb[ops[pos]] @ (beta_{pos+1} * hem_pos),
//             beta_pos = norm_mask(Mb[rops[pos]] @ (mid * em_{pos+1}))
//             (kernels.py:227-230: homozygous half-step, then marker step);
//   post_pos   = alpha_pos * beta_pos / sum_k(alpha_pos * beta_pos);
// per pair p:
//   posterior[pos][k][p]   = post,
//   threshold_sums[pos][p] = sum_{k < state_threshold} post,
//   per_pair_mean[pos][p]  = sum_k post * exp_times[k],
//   per_pair_map[pos][p]   = argmax_k post (first maximum, stored as float);
// over pairs, as per-block partials that hmm_reduce.cu sums:
//   posterior_sums[blk][pos][k]      = sum_{p in blk} post,
//   major_minor_sums[blk][pos][c][k] = sum_{p in blk} post * w_c(p),
//   with the classes of obs at pos (HMM.cpp:1063-1069):
//   w00 = oz * (1 - oh), w01 = 1 - oz, w11 = oh.
// As in kernels.py:597-603, ops and the emission/observation rows are taken
// at pos+1 for the step that produces beta_pos, and mask[pos] says whether
// site t0+pos is a scaling site. On the approximate profiles
// (hmm_common.cuh) the product operands are rounded to bf16, alpha is read
// as bf16, and in array mode beta is normalised only at the last site of
// each kBlockSites-site block counted from the window's end
// (kernels.py:233-243); the combine renormalises every site.
//
// Bound on an H100: the same FP32 operator product as the forward pass
// (~5.2k FMA per pair and site) plus reading alpha and writing the
// posterior (~600 bytes per pair and site), still compute-bound; sequence
// mode does two products per site. Design:
// the forward kernel's tile (one block per 32 pairs, the window as a loop
// inside the block), walking pos = T-1 .. 0. beta stays in registers; the
// product's operand beta_{pos+1} * em_{pos+1} is the only thing written to
// shared memory. Per-pair outputs reduce across warps through shared
// memory, so the [T, K, P] posterior is written only when it is asked for.
// The TPU block holds every pair and sums over them in its body; here a
// block holds 32, so each warp sums its lanes with a fixed shuffle tree and
// writes one partial per block, and a second kernel adds the blocks in a
// fixed order: no float atomics, and two runs give the same bits. Lanes
// past P hold 0/0 = NaN posteriors; they are masked out of every sum. In
// sequence mode the half-step's result passes through shared memory as
// the second product's operand, after one barrier more per site.
#include <math.h>

#include "hmm_common.cuh"

namespace fastsmc {
namespace {

// The outputs only ASMC reads. The kernel takes posterior and threshold
// sums as __restrict__ parameters, and these in a plain struct, as nvcc
// schedules each instantiation best (on an H100: without __restrict__ the
// FastSMC one falls from 126 to 80 registers and runs 7 % slower; with it
// the ASMC one falls from 124 to 108 registers and runs 7-9 % slower).
struct AsmcOut {
  float* mean;      // [T][P]
  float* map;       // [T][P]
  float* psum;      // [nblk][T][KP] block partials
  float* mm;        // [nblk][T][3][KP] block partials
};

// Reduction buffers: beta norm, posterior norm and threshold sums; the full
// set adds the per-pair epilogue's means, MAP values and MAP states.
constexpr int kRedBuffers = 3;
constexpr int kRedBuffersFull = 6;

// FULL selects at compile time the outputs only ASMC reads (per-pair means
// and MAP states, the sums over pairs), as the TPU kernel selects its
// outputs when it is traced. The FastSMC path asks for posterior and
// threshold sums only, so its instantiation carries none of their
// registers, buffers or epilogues.
template <int RPW, bool FULL, bool SEQ, bool APPROX>
__global__ void __launch_bounds__(kThreads)
    hmm_backward_kernel(const float* __restrict__ Mb, int G,
                        const float* __restrict__ em,     // [T][3][KP]
                        const float* __restrict__ obs,    // [T][2][P]
                        const AlphaT<APPROX>* __restrict__ alpha,  // [T][KP][P]
                        const int* __restrict__ ops,      // [T]
                        const int* __restrict__ mask,     // [T]
                        const float* __restrict__ exp_times,  // [KP] or null
                        float* __restrict__ post,  // [T][KP][P] or null
                        float* __restrict__ th,    // [T][P] or null
                        AsmcOut out, int T, int P, int K, int state_threshold,
                        const int* __restrict__ rops,   // [T], SEQ only
                        const float* __restrict__ hem,  // [T][KP], SEQ only
                        bool op_bf16) {                 // Mb is bf16 (turbo)
  constexpr int KP = RPW * kWarps;
  constexpr bool kNormBlock = APPROX && !SEQ;  // kernels.py:396-398
  extern __shared__ float4 smem4[];
  float* sM = reinterpret_cast<float*>(smem4);  // [KP][KP] operator of gap pos
  float* sV = sM + KP * KP;                     // [KP][kPairs] beta*em at pos+1
  float* sRed0 = sV + KP * kPairs;              // beta normalisation
  float* sRed1 = sRed0 + kWarps * kPairs;       // posterior normalisation
  float* sTh = sRed1 + kWarps * kPairs;         // threshold sums
  float* sMean = sTh + kWarps * kPairs;         // FULL only: means, MAP
  float* sMapV = sMean + kWarps * kPairs;
  int* sMapK = reinterpret_cast<int*>(sMapV + kWarps * kPairs);
  // SEQ: the rate operator and the half-step, after the reduction buffers
  float* sM2 = sRed0 + (FULL ? kRedBuffersFull : kRedBuffers) * kWarps * kPairs;
  float* sMid = sM2 + KP * KP;
  const int lane = threadIdx.x % kPairs;
  const int warp = threadIdx.x / kPairs;
  const int p = blockIdx.x * kPairs + lane;
  const bool live = p < P;
  const size_t Pz = static_cast<size_t>(P);

  float et[RPW];
  if constexpr (FULL) {
#pragma unroll
    for (int i = 0; i < RPW; ++i)
      et[i] = out.mean ? exp_times[warp + kWarps * i] : 0.f;
  }

  // lastBeta = 1/K on real states (HMM.cpp:886-897), rounded from double
  // as the JAX package does
  const float beta0 = static_cast<float>(1.0 / static_cast<double>(K));
  float b[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) b[i] = (warp + kWarps * i) < K ? beta0 : 0.f;

  for (int pos = T - 1; pos >= 0; --pos) {
    if (pos < T - 1) {
      stage<APPROX>(sM, Mb, op_bf16, ops[pos], G, KP);
      if constexpr (SEQ) stage<APPROX>(sM2, Mb, op_bf16, rops[pos], G, KP);
      __syncthreads();  // operators and operand visible
      float acc[RPW];
      matvec<RPW>(acc, sM, sV, lane, warp);
      if constexpr (SEQ) {
        // marker step's operand: the half-step times em_{pos+1}
        const float* em_n = em + static_cast<size_t>(pos + 1) * 3 * KP;
        const size_t o = 2 * static_cast<size_t>(pos + 1) * Pz + p;
        const float oz = live ? obs[o] : 1.f;
        const float oh = live ? obs[o + Pz] : 0.f;
#pragma unroll
        for (int i = 0; i < RPW; ++i) {
          const int k = warp + kWarps * i;
          sMid[k * kPairs + lane] =
              operand<APPROX>(acc[i] * emission(em_n, k, KP, oz, oh));
        }
        __syncthreads();  // half-step visible; last step's sMid reads done
        matvec<RPW>(acc, sM2, sMid, lane, warp);
      }
      float inv = 1.f;
      if constexpr (kNormBlock) {
        if ((T - 1 - pos) % kBlockSites == kBlockSites - 1) {
          float part = 0.f;
#pragma unroll
          for (int i = 0; i < RPW; ++i) part += acc[i];
          inv = 1.f / column_sum(sRed0, part, lane, warp);  // kernels.py:240
        }
      } else {
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < RPW; ++i) part += acc[i];
        const float s = column_sum(sRed0, part, lane, warp);
        inv = mask[pos] != 0 ? 1.f / s : 1.f;  // kernels.py:242
      }
#pragma unroll
      for (int i = 0; i < RPW; ++i) b[i] = acc[i] * inv;
    }

    // combine (kernels.py:262-291)
    const AlphaT<APPROX>* alpha_t = alpha + static_cast<size_t>(pos) * KP * Pz;
    float q[RPW];
    float part = 0.f;
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int k = warp + kWarps * i;
      q[i] = live ? alpha_to_float(alpha_t[k * Pz + p]) * b[i] : 0.f;
      part += q[i];
    }
    const float s = column_sum(sRed1, part, lane, warp);
    float* post_t = post ? post + static_cast<size_t>(pos) * KP * Pz
                             : nullptr;
    float tpart = 0.f, mpart = 0.f, best = -INFINITY;
    int best_k = warp;
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int k = warp + kWarps * i;
      q[i] = q[i] / s;
      if (post_t && live) post_t[k * Pz + p] = q[i];
      if (k < state_threshold) tpart += q[i];
      if constexpr (FULL) {
        mpart += q[i] * et[i];
        if (q[i] > best) {  // rows ascend in k: keeps the first maximum
          best = q[i];
          best_k = k;
        }
      }
    }
    if constexpr (!FULL) {
      if (th) {
        const float tsum = column_sum(sTh, tpart, lane, warp);
        if (warp == 0 && live) th[static_cast<size_t>(pos) * Pz + p] = tsum;
      }
    } else if (th || out.mean || out.map) {
      const int slot = warp * kPairs + lane;
      sTh[slot] = tpart;
      sMean[slot] = mpart;
      sMapV[slot] = best;
      sMapK[slot] = best_k;
      __syncthreads();
      if (warp == 0 && live) {
        const size_t o = static_cast<size_t>(pos) * Pz + p;
        float tsum = 0.f, msum = 0.f;
        float bv = sMapV[lane];
        int bk = sMapK[lane];
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          tsum += sTh[w * kPairs + lane];
          msum += sMean[w * kPairs + lane];
          const float v = sMapV[w * kPairs + lane];
          const int kk = sMapK[w * kPairs + lane];
          if (v > bv || (v == bv && kk < bk)) {  // jnp.argmax: first maximum
            bv = v;
            bk = kk;
          }
        }
        if (th) th[o] = tsum;
        if (out.mean) out.mean[o] = msum;
        if (out.map) out.map[o] = static_cast<float>(bk);
      }
    }

    const float oz = live ? obs[(2 * static_cast<size_t>(pos)) * Pz + p] : 1.f;
    const float oh = live ? obs[(2 * static_cast<size_t>(pos) + 1) * Pz + p] : 0.f;

    // over-pairs sums: this block's partial, lane i storing row i's
    if constexpr (FULL) {
      if (out.psum || out.mm) {
        const size_t row = static_cast<size_t>(blockIdx.x) * T + pos;
        const float w00 = oz * (1.f - oh), w01 = 1.f - oz, w11 = oh;
#pragma unroll
        for (int i = 0; i < RPW; ++i) {
          const int k = warp + kWarps * i;
          const float qv = live ? q[i] : 0.f;
          if (out.psum) {
            const float v = warp_sum(qv);
            if (lane == i) out.psum[row * KP + k] = v;
          }
          if (out.mm) {
            const float v0 = warp_sum(qv * w00);
            const float v1 = warp_sum(qv * w01);
            const float v2 = warp_sum(qv * w11);
            if (lane == i) {
              float* mm_t = out.mm + row * 3 * KP;
              mm_t[k] = v0;
              mm_t[KP + k] = v1;
              mm_t[2 * KP + k] = v2;
            }
          }
        }
      }
    }

    // operand of the next (earlier) site's first product: beta_pos * em_pos,
    // or in sequence mode beta_pos * hem_{pos-1}
    if (pos > 0) {
      if constexpr (SEQ) {
        const float* hem_n = hem + static_cast<size_t>(pos - 1) * KP;
#pragma unroll
        for (int i = 0; i < RPW; ++i) {
          const int k = warp + kWarps * i;
          sV[k * kPairs + lane] = operand<APPROX>(b[i] * hem_n[k]);
        }
      } else {
        const float* em_t = em + static_cast<size_t>(pos) * 3 * KP;
#pragma unroll
        for (int i = 0; i < RPW; ++i) {
          const int k = warp + kWarps * i;
          sV[k * kPairs + lane] =
              operand<APPROX>(b[i] * emission(em_t, k, KP, oz, oh));
        }
      }
    }
  }
}

struct BackwardArgs {
  const float* Mb;
  int G;
  const float* em;
  const float* obs;
  const void* alpha;
  const int* ops;
  const int* rops;
  const float* hem;
  const int* mask;
  const float* exp_times;
  float* post;
  float* th;
  AsmcOut out;
  int T, P, K, state_threshold;
  bool op_bf16;
};

template <int RPW, bool FULL, bool SEQ, bool APPROX>
int launch_backward(const BackwardArgs& a, cudaStream_t stream) {
  constexpr int KP = RPW * kWarps;
  const size_t smem =
      shared_bytes(KP, FULL ? kRedBuffersFull : kRedBuffers) +
      (SEQ ? sizeof(float) * (KP * KP + KP * kPairs) : 0);
  auto* kernel = hmm_backward_kernel<RPW, FULL, SEQ, APPROX>;
  const int rc = allow_shared(kernel, smem);
  if (rc != 0) return rc;
  const dim3 grid((a.P + kPairs - 1) / kPairs);
  kernel<<<grid, kThreads, smem, stream>>>(
      a.Mb, a.G, a.em, a.obs, static_cast<const AlphaT<APPROX>*>(a.alpha),
      a.ops, a.mask, a.exp_times, a.post, a.th, a.out, a.T, a.P, a.K,
      a.state_threshold, a.rops, a.hem, a.op_bf16);
  return static_cast<int>(cudaGetLastError());
}

template <bool SEQ, bool APPROX>
int backward_variant(const BackwardArgs& a, int rpw, cudaStream_t stream) {
  const bool full = a.out.mean || a.out.map || a.out.psum || a.out.mm;
  return dispatch_rpw(rpw, [&](auto r) {
    constexpr int R = decltype(r)::value;
    return full ? launch_backward<R, true, SEQ, APPROX>(a, stream)
                : launch_backward<R, false, SEQ, APPROX>(a, stream);
  });
}

}  // namespace
}  // namespace fastsmc

// Launch the backward+combine kernel on `stream` (device `device`). Each
// output pointer may be null (output not wanted); `psum` and `mm` receive
// per-block partials over ceil(P / 32) blocks, summed by
// fastsmc_block_reduce. `exp_times` ([KP]) is read only for `mean`.
// `profile` is kExact, kFast or kTurbo (Mb f32, f32, bf16; alpha f32, bf16,
// bf16). Sequence mode when `rops` and `hem` are given, array mode when
// both are null. Returns the cudaError_t of the launch. KP must be a
// multiple of 8, at most 128, with K <= KP.
extern "C" int fastsmc_hmm_backward(const void* Mb, int profile, int G,
                                    const float* em, const float* obs,
                                    const void* alpha, const int* ops,
                                    const int* rops, const float* hem,
                                    const int* mask, const float* exp_times,
                                    float* post, float* th, float* mean,
                                    float* map, float* psum, float* mm, int T,
                                    int P, int K, int KP, int state_threshold,
                                    int device, void* stream) {
  using namespace fastsmc;
  if (T <= 0 || P <= 0 || G <= 0 || K <= 0 || K > KP || KP % kWarps != 0 ||
      (mean && !exp_times) || profile < kExact || profile > kTurbo ||
      (rops == nullptr) != (hem == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const BackwardArgs a{static_cast<const float*>(Mb), G, em, obs, alpha, ops,
                       rops, hem, mask, exp_times, post, th,
                       AsmcOut{mean, map, psum, mm}, T, P, K,
                       state_threshold, profile == kTurbo};
  const int rpw = KP / kWarps;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool seq = rops != nullptr;
  if (profile == kExact)
    return seq ? backward_variant<true, false>(a, rpw, s)
               : backward_variant<false, false>(a, rpw, s);
  return seq ? backward_variant<true, true>(a, rpw, s)
             : backward_variant<false, true>(a, rpw, s);
}
