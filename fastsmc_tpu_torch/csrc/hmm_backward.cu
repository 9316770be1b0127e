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
// (~5.2k FMA per pair and site, two products a site in sequence mode)
// plus reading alpha and writing the posterior (~600 bytes per pair and
// site): compute-bound on paper (67 TFLOP/s f32). What bounds this kernel
// is the shared-memory data path that feeds the product: an SM hands its
// lanes one 32-bit word each a clock, against four warp-FFMAs, and for
// every four j each thread loads nine 16-byte operator broadcasts (36
// words) and four operand words for 36 FFMA, so the product runs at most
// at 9 / 40 of the FP32 rate (PERF.md §6). Reusing an operator word
// for two pairs a lane halves its loads, but at the batches this kernel
// runs (8,192 pairs) leaves one block of 8 warps an SM, too few to hide
// the latencies, and was slower; it was taken out.
// Design: one block per 32 pairs (lane = pair) walks pos = T-1 .. 0; warp
// w owns the state rows w, w+8, ...; beta stays in registers; the
// product's operand beta_{pos+1} * em_{pos+1} is the only thing written to
// shared memory. What the design keeps off each site's chain:
//   - the operators arrive by bulk copy (cp.async.bulk, completed on an
//     mbarrier), issued ahead of their use: on the exact profile into a
//     ring of tiles the product reads (two in array mode, three in
//     sequence mode, where two operators a site are used), so no site
//     waits on L2 or on a staging barrier; on the approximate profiles into
//     one raw tile a site ahead, rounded (fast) or widened (turbo) into the
//     product's tile as it is used, the values the TPU kernel's bf16 pass
//     reads;
//   - each site's alpha and observations are loaded before its product, so
//     that their device-memory latency hides behind the FMAs.
// No sum changes its order: every product accumulator is one fmaf chain
// over j ascending from 0; each column sum adds the eight row groups'
// partials (w ascending); MAP keeps the first maximum; each block's
// over-pairs partial is its xor butterfly over the lanes. Per-pair outputs
// reduce across warps through shared memory, so the [T, K, P] posterior is
// written only when it is asked for. The TPU block holds every pair and
// sums over them in its body; here a block holds 32, so each warp sums its
// lanes with a fixed shuffle tree and writes one partial per block, and a
// second kernel adds the blocks in a fixed order: no float atomics, and
// two runs give the same bits. Lanes past P hold 0/0 = NaN posteriors;
// they are masked out of every sum. In sequence mode the half-step's
// result passes through shared memory as the second product's operand,
// after one barrier more per site.
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
// Dynamic shared memory a block may take on an H100 (227 KB).
constexpr size_t kMaxShared = 232448;

// Shared memory with `tiles` f32 operator tiles and `bars` mbarriers: the
// tiles [KP][KP], the product operand [KP][kPairs] (and the half-step in
// sequence mode), the reduction buffers [kWarps][kPairs].
__host__ __device__ constexpr size_t backward_shared(int KP, bool FULL,
                                                     bool SEQ, int tiles,
                                                     int bars) {
  return sizeof(float) * (static_cast<size_t>(tiles) * KP * KP +
                          (SEQ ? 2 : 1) * KP * kPairs +
                          (FULL ? kRedBuffersFull : kRedBuffers) * kWarps *
                              kPairs) +
         bars * sizeof(uint64_t);
}

// The operator tiles of one instantiation. Exact profile: a ring of
// kTiles tiles the product reads, each copied a tile ahead of its use, one
// mbarrier a tile; three in sequence mode where they fit, else two.
// Approximate profiles: kTiles product tiles (two in sequence mode) and
// one raw tile with its mbarrier; where the raw tile does not fit
// (sequence mode at the largest K) they stage each operator synchronously.
template <int KP, bool FULL, bool SEQ, bool APPROX>
struct Tiles {
  static constexpr int kTiles =
      APPROX ? (SEQ ? 2 : 1)
      : SEQ && backward_shared(KP, FULL, SEQ, 3, 3) <= kMaxShared ? 3 : 2;
  static constexpr int kRaw =
      APPROX && backward_shared(KP, FULL, SEQ, kTiles + 1, 1) <= kMaxShared;
  static constexpr int kBars = APPROX ? kRaw : kTiles;
  static constexpr size_t kShared =
      backward_shared(KP, FULL, SEQ, kTiles + kRaw, kBars);
};

// The raw tile as the product reads it: rounded to bf16 (fast, f32 stored)
// or widened (turbo, bf16 stored), the values stage_operator_bf16 gives.
__device__ __forceinline__ void round_tile(float* __restrict__ dst,
                                           const float* __restrict__ raw,
                                           bool bf16_store, int KP) {
  float4* out = reinterpret_cast<float4*>(dst);
  if (bf16_store) {
    const uint4* src = reinterpret_cast<const uint4*>(raw);
    for (int i = threadIdx.x; i < KP * KP / 8; i += kThreads) {
      const uint4 u = src[i];
      out[2 * i] = make_float4(bf16_lo(u.x), bf16_hi(u.x), bf16_lo(u.y),
                               bf16_hi(u.y));
      out[2 * i + 1] = make_float4(bf16_lo(u.z), bf16_hi(u.z), bf16_lo(u.w),
                                   bf16_hi(u.w));
    }
  } else {
    const float4* src = reinterpret_cast<const float4*>(raw);
    for (int i = threadIdx.x; i < KP * KP / 4; i += kThreads) {
      const float4 v = src[i];
      out[i] = make_float4(round_bf16(v.x), round_bf16(v.y), round_bf16(v.z),
                           round_bf16(v.w));
    }
  }
}

// acc[i] = sum_j sM[k_i][j] * sV[j][lane] for this thread's rows
// k_i = warp + kWarps * i: one fmaf chain over j ascending from 0 per
// accumulator, each operator row read as 16-byte broadcasts, four j a
// load.
template <int RPW>
__device__ __forceinline__ void product(float (&acc)[RPW],
                                        const float* __restrict__ sM,
                                        const float* __restrict__ sV,
                                        int lane, int warp) {
  constexpr int KP = RPW * kWarps;
#pragma unroll
  for (int i = 0; i < RPW; ++i) acc[i] = 0.f;
#pragma unroll 2
  for (int j = 0; j < KP; j += 4) {
    float v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = sV[(j + q) * kPairs + lane];
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const float4 m =
          *reinterpret_cast<const float4*>(sM + (warp + kWarps * i) * KP + j);
      acc[i] = fmaf(m.x, v[0], acc[i]);
      acc[i] = fmaf(m.y, v[1], acc[i]);
      acc[i] = fmaf(m.z, v[2], acc[i]);
      acc[i] = fmaf(m.w, v[3], acc[i]);
    }
  }
}

// Two blocks an SM (at most 128 registers) where the rows fit, up to 80
// states; without it ptxas caps some instantiations at 64 or 80 registers
// and spills, or takes more than 128 and leaves one block an SM.
template <int RPW>
constexpr int kMinBlocks = RPW <= 10 ? 2 : 1;

// FULL selects at compile time the outputs only ASMC reads (per-pair means
// and MAP states, the sums over pairs), as the TPU kernel selects its
// outputs when it is traced. The FastSMC path asks for posterior and
// threshold sums only, so its instantiation carries none of their
// registers, buffers or epilogues.
template <int RPW, bool FULL, bool SEQ, bool APPROX>
__global__ void __launch_bounds__(kThreads, kMinBlocks<RPW>)
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
  // alpha loaded before the product, except in the approximate array
  // kernel with the ASMC outputs: there the early loads make ptxas spill
  // at 128 registers (28 bytes at K=69)
  constexpr bool kEarlyAlpha = !(FULL && APPROX && !SEQ);
  using L = Tiles<KP, FULL, SEQ, APPROX>;
  constexpr int kTiles = L::kTiles;
  extern __shared__ float4 smem4[];
  float* sM = reinterpret_cast<float*>(smem4);  // kTiles operators [KP][KP]
  float* sRaw = sM + kTiles * KP * KP;          // APPROX: the stored operator
  float* sV = sRaw + L::kRaw * KP * KP;         // [KP][kPairs] beta*em at pos+1
  float* sMid = sV + KP * kPairs;               // SEQ: [KP][kPairs] half-step
  float* sRed0 = sMid + (SEQ ? KP * kPairs : 0);  // beta normalisation
  float* sRed1 = sRed0 + kWarps * kPairs;       // posterior normalisation
  float* sTh = sRed1 + kWarps * kPairs;         // threshold sums
  float* sMean = sTh + kWarps * kPairs;         // FULL only: means, MAP
  float* sMapV = sMean + kWarps * kPairs;
  int* sMapK = reinterpret_cast<int*>(sMapV + kWarps * kPairs);
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      sRed0 + (FULL ? kRedBuffersFull : kRedBuffers) * kWarps * kPairs);
  const int lane = threadIdx.x % kPairs;
  const int warp = threadIdx.x / kPairs;
  const int p = blockIdx.x * kPairs + lane;
  const bool live = p < P;
  const size_t Pz = static_cast<size_t>(P);

  // The operator tiles, in the order the sites use them (array: ops[T-2],
  // ops[T-3], ...; sequence: ops[T-2], rops[T-2], ops[T-3], ...). Exact:
  // tile n lands in slot n % kTiles, on that slot's barrier, as its
  // (n / kTiles)-th copy; before tile n is used, and after the barrier that
  // ends every read of tile n - 1, one thread issues tile n + kTiles - 1
  // into the slot tile n - 1 held. Approximate: tile n lands in the raw
  // tile as the barrier's n-th copy; after the barrier that ends its
  // rounding into a product tile, one thread issues tile n + 1.
  const int n_tiles = (T - 1) * (SEQ ? 2 : 1);
  constexpr bool kCopy = !APPROX || L::kRaw;  // operators by bulk copy
  constexpr int kAhead = APPROX ? 1 : kTiles - 1;  // copies in flight
  auto op_of = [=](int n) {
    const int site = T - 2 - (SEQ ? n / 2 : n);
    return SEQ && (n & 1) ? rops[site] : ops[site];
  };
  auto issue = [=](int n) {
    const int op = op_of(n);
    if (op < 0 || op >= G) __trap();  // a caller bug: stop the kernel
    const size_t at = static_cast<size_t>(op) * KP * KP;
    if constexpr (APPROX) {
      if (op_bf16)
        bulk_copy(sRaw, reinterpret_cast<const __nv_bfloat16*>(Mb) + at,
                  sizeof(__nv_bfloat16) * KP * KP, bars);
      else
        bulk_copy(sRaw, Mb + at, sizeof(float) * KP * KP, bars);
    } else {
      bulk_copy(sM + (n % kTiles) * KP * KP, Mb + at, sizeof(float) * KP * KP,
                &bars[n % kTiles]);
    }
  };
  // tile n: landed (exact), or landed and rounded into product tile `slot`,
  // or staged there (approximate; the caller's barrier makes it visible)
  auto tile = [=](int n, int slot) -> const float* {
    if constexpr (!kCopy) {
      stage<APPROX>(sM + slot * KP * KP, Mb, op_bf16, op_of(n), G, KP);
      return sM + slot * KP * KP;
    } else if constexpr (APPROX) {
      wait_phase(bars, n & 1);
      round_tile(sM + slot * KP * KP, sRaw, op_bf16, KP);
      return sM + slot * KP * KP;
    } else {
      wait_phase(&bars[n % kTiles], (n / kTiles) & 1);
      return sM + (n % kTiles) * KP * KP;
    }
  };
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < L::kBars; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   :: "r"(smem_u32(&bars[s])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int n = 0; kCopy && n < kAhead && n < n_tiles; ++n) issue(n);
  }
  __syncthreads();  // barriers initialised

  // lastBeta = 1/K on real states (HMM.cpp:886-897), rounded from double
  // as the JAX package does
  const float beta0 = static_cast<float>(1.0 / static_cast<double>(K));
  float b[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) b[i] = (warp + kWarps * i) < K ? beta0 : 0.f;

  for (int pos = T - 1; pos >= 0; --pos) {
    // this site's alpha and observations, loaded before the product so
    // that their latency hides behind it
    const AlphaT<APPROX>* alpha_t = alpha + static_cast<size_t>(pos) * KP * Pz;
    AlphaT<APPROX> a[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i)
      if constexpr (kEarlyAlpha)
        a[i] = live ? alpha_t[(warp + kWarps * i) * Pz + p]
                    : float_to_alpha<APPROX>(0.f);
    const float oz = live ? obs[(2 * static_cast<size_t>(pos)) * Pz + p] : 1.f;
    const float oh = live ? obs[(2 * static_cast<size_t>(pos) + 1) * Pz + p] : 0.f;

    if (pos < T - 1) {
      float acc[RPW];
      const int n = (T - 2 - pos) * (SEQ ? 2 : 1);
      if (threadIdx.x == 0 && !APPROX && n + kAhead < n_tiles)
        issue(n + kAhead);
      const float* m = tile(n, 0);
      __syncthreads();  // operand (and a rounded or staged tile) visible
      if (threadIdx.x == 0 && APPROX && kCopy && n + 1 < n_tiles) issue(n + 1);
      product<RPW>(acc, m, sV, lane, warp);
      if constexpr (SEQ) {
        // marker step's operand: the half-step times em_{pos+1}
        const float* em_n = em + static_cast<size_t>(pos + 1) * 3 * KP;
        const size_t o = 2 * static_cast<size_t>(pos + 1) * Pz + p;
        const float ozn = live ? obs[o] : 1.f;
        const float ohn = live ? obs[o + Pz] : 0.f;
#pragma unroll
        for (int i = 0; i < RPW; ++i) {
          const int k = warp + kWarps * i;
          sMid[k * kPairs + lane] =
              operand<APPROX>(acc[i] * emission(em_n, k, KP, ozn, ohn));
        }
        const float* m2 = APPROX ? tile(n + 1, 1) : nullptr;
        __syncthreads();  // half-step visible; every read of tile n done
        if (threadIdx.x == 0 && kCopy && n + 1 + kAhead < n_tiles)
          issue(n + 1 + kAhead);
        product<RPW>(acc, APPROX ? m2 : tile(n + 1, 0), sMid, lane, warp);
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
    float q[RPW];
    float part = 0.f;
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      q[i] = live ? alpha_to_float(kEarlyAlpha
                                       ? a[i]
                                       : alpha_t[(warp + kWarps * i) * Pz + p]) *
                        b[i]
                  : 0.f;
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
        if (out.mean) mpart += q[i] * exp_times[k];
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
  constexpr size_t smem = Tiles<RPW * kWarps, FULL, SEQ, APPROX>::kShared;
  static_assert(smem <= kMaxShared, "operator tiles exceed shared memory");
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
