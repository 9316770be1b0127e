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
// approximate profiles the product operands are rounded to bf16, alpha is
// stored as bf16, and in array mode norm runs only at the last site of
// each kBlockSites-site block (kernels.py:135-148).
//
// Bound on an H100: the per-site K x K operator product (two in sequence
// mode), ~5.2k multiply-adds per pair and site, against ~300 bytes of alpha
// written (~150 in bf16). Fed from shared memory to the FP32 pipe, one
// 32-bit word a lane a clock caps such a product at 22.5 % of FP32 issue
// (PERF.md §6), so the exact branches and the bf16 sequence branch run the
// product on the tensor cores with mma.sync:
//   C[p][i] = sum_j A[p][j] * B[j][i],  A = the carry (pairs x states),
//   B = Mf[op]^T, so the operator's row-major [i][j] is the "col" B operand.
// Pairs are the M dimension: a warp owns one 16-pair m-tile and all KP
// states (KP / 8 n-tiles), so each pair's sum over states stays inside the
// warp (the thread's own values, then two xor shuffles over its quad) and
// no block-wide barrier sits on a site's chain.
//   - exact: 3xTF32 on m16n8k8. Each operand is split x = hi + lo, both
//     rounded to TF32 (cvt.rna); the operator's split is made once on the
//     host (DecodeTables.Mf_hi / Mf_lo), the carry's in registers; the
//     small products lo*hi + hi*lo and the large hi*hi accumulate in f32
//     in two chains, added at the end. An accumulator holds
//     states 2q, 2q+1 of each 8-state group where the A fragment wants q,
//     q+4: the k index is read through that fixed permutation, which makes
//     the B fragment two adjacent floats of an operator row (one 8-byte
//     load) and needs no change to the table.
//   - bf16 sequence mode: m16n8k16 (and one m16n8k8 step where KP / 8 is
//     odd, so K is padded only to a multiple of 8) with f32 accumulation.
//     The accumulators of two adjacent n-tiles, rounded to bf16, are the A
//     fragment of the next product's k-step: the carry never leaves the
//     registers, nor does the half-step.
//   - both: the operator's diagonal is added last by an f32 fmaf (below).
// The operators reach shared memory by bulk copy (cp.async.bulk, completed
// on a "full" mbarrier per ring slot) from one producer warp that runs
// ahead of the consumer warps by up to the ring's depth; each consumer
// thread arrives on the slot's "empty" mbarrier when it has read it, and
// the producer refills the slot only then. A ring entry is one operator
// (array: one a site; sequence: the half-step's, then the marker step's)
// with the site's emission rows [3][KP] (sequence half-step entries: the
// homozygous emissions [KP]) beside it. Each site's observations are loaded
// a site ahead. Alpha is stored straight from the accumulators: a quad-row
// group of one state is 8 consecutive pairs. Every sum is in a fixed order
// and no sum crosses a warp or a pair, so two runs give the same bits and a
// pair's alpha does not depend on the batch around it.
// The bf16 array branch runs its products on the FP32 pipe, in the plain
// version's order of sums (on tensor cores it cannot hold its gate against
// the plain version): hmm_forward_tile_kernel, a register tile a lane, one
// warp a pair group's whole recursion, operators by bulk copy (below).
#include "hmm_common.cuh"

namespace fastsmc {
namespace {

constexpr int kWarpPairs = 16;  // one mma m-tile
constexpr int kMaxFwdWarps = 4;  // consumer warps a block, at most
constexpr int kMaxRing = 4;
// Dynamic shared memory a block may take on an H100 (227 KB).
constexpr size_t kFwdMaxShared = 232448;

// Bytes of one ring entry: the operator tile(s) and three KP-float rows.
__host__ __device__ constexpr size_t tile_bytes(int KP, bool approx) {
  return (approx ? 1 : 2) * sizeof(float) * static_cast<size_t>(KP) * KP;
}
__host__ __device__ constexpr size_t entry_bytes(int KP, bool approx) {
  return tile_bytes(KP, approx) + 3 * sizeof(float) * KP;
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// Two floats rounded to bf16 (nearest even) in one word, `lo` in the low
// half: the order of k in a bf16x2 fragment register.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16_k16(float (&d)[4], uint32_t a0,
                                             uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint32_t b0,
                                             uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16_k8(float (&d)[4], uint32_t a0,
                                            uint32_t a1, uint32_t b0) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// The fragments of one thread (lane = 4 g + q). Carry and accumulator
// c[nt][r]: pair row g (r = 0, 1) or g + 8 (r = 2, 3) of the warp's
// m-tile, state 8 nt + 2 q + (r & 1).
//
// The diagonal M[i][i] of every operator is left out of the tensor-core
// sums and added last, per state, by one f32 fmaf. The tensor cores add a
// k-step's products and the accumulator with truncation (toward zero), so
// each sum they hold loses up to a few units in its last place, always
// downward; the operators are near the identity, and with the dominant
// term inside, that bias is relative to the whole sum and the recursion
// amplifies it (alpha 1.0e-5 from the plain f32 version at T=8192 on an
// H100; PERF.md §6). Off the diagonal it is relative to the small
// off-diagonal part only (4.9e-6; an f64-summed plain version reads the
// same).

// acc = carry @ M^T on 3xTF32. `hi`, `lo`: the operator's [KP][KP] split.
template <int NT>
__device__ __forceinline__ void product_3xtf32(float (&acc)[NT][4],
                                               const float (&c)[NT][4],
                                               const float* __restrict__ hi,
                                               const float* __restrict__ lo,
                                               int g, int q) {
  constexpr int KP = 8 * NT;
  float sm[NT][4];  // the small terms: a chain of their own
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[nt][r] = sm[nt][r] = 0.f;
#pragma unroll
  for (int kk = 0; kk < NT; ++kk) {
    // A fragment (g, q), (g+8, q), (g, q+4), (g+8, q+4): logical k q is
    // state 8 kk + 2 q, logical k q + 4 is state 8 kk + 2 q + 1
    const float x[4] = {c[kk][0], c[kk][2], c[kk][1], c[kk][3]};
    uint32_t ah[4], al[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      ah[r] = tf32_rna(x[r]);
      al[r] = tf32_rna(x[r] - __uint_as_float(ah[r]));
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      // B fragment (q, g), (q+4, g) under the same permutation: M[8 nt +
      // g][8 kk + 2 q] and the float after it
      const int o = (8 * nt + g) * KP + 8 * kk + 2 * q;
      const float2 h = *reinterpret_cast<const float2*>(hi + o);
      const float2 l = *reinterpret_cast<const float2*>(lo + o);
      uint32_t h0 = __float_as_uint(h.x), h1 = __float_as_uint(h.y);
      uint32_t l0 = __float_as_uint(l.x), l1 = __float_as_uint(l.y);
      if (nt == kk) {  // the diagonal M[8 nt + g][8 nt + g] comes last
        if (g == 2 * q) h0 = l0 = 0u;
        if (g == 2 * q + 1) h1 = l1 = 0u;
      }
      mma_tf32(sm[nt], al, h0, h1);
      mma_tf32(sm[nt], ah, l0, l1);
      mma_tf32(acc[nt], ah, h0, h1);
    }
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[nt][r] += sm[nt][r];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = (8 * nt + 2 * q + h) * (KP + 1);
      const float d = hi[k] + lo[k];  // exact: lo lies below hi's last bit
      acc[nt][h] = fmaf(d, c[nt][h], acc[nt][h]);
      acc[nt][2 + h] = fmaf(d, c[nt][2 + h], acc[nt][2 + h]);
    }
}

// Two adjacent operator values (k, k + 1) of one row as a bf16x2 word: the
// bf16 table's own (turbo), or the f32 table's rounded (fast).
template <bool BF16_STORE>
__device__ __forceinline__ uint32_t operator_pair(const void* tile, int o) {
  if constexpr (BF16_STORE) {
    return *reinterpret_cast<const uint32_t*>(
        static_cast<const __nv_bfloat16*>(tile) + o);
  } else {
    const float2 v =
        *reinterpret_cast<const float2*>(static_cast<const float*>(tile) + o);
    return pack_bf16(v.x, v.y);
  }
}

// The operator's element `k` as the bf16 products read it.
template <bool BF16_STORE>
__device__ __forceinline__ float operator_value(const void* tile, int k) {
  if constexpr (BF16_STORE)
    return __bfloat162float(static_cast<const __nv_bfloat16*>(tile)[k]);
  else
    return round_bf16(static_cast<const float*>(tile)[k]);
}

// acc = bf16(carry) @ bf16(M)^T with f32 accumulation.
template <int NT, bool BF16_STORE>
__device__ __forceinline__ void product_bf16(float (&acc)[NT][4],
                                             const float (&c)[NT][4],
                                             const void* tile, int g, int q) {
  constexpr int KP = 8 * NT;
  // the half of a B word (k = 2q, 2q+1 of an 8-state group) that holds the
  // diagonal of row g of that group: cleared, the diagonal comes last
  const uint32_t dmask = (g == 2 * q ? 0xffff0000u : 0xffffffffu) &
                         (g == 2 * q + 1 ? 0x0000ffffu : 0xffffffffu);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[nt][r] = 0.f;
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    // states 16 kk .. 16 kk + 15: the accumulators of n-tiles 2 kk, 2 kk + 1
    const uint32_t a0 = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
    const uint32_t a1 = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
    const uint32_t a2 = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    const uint32_t a3 = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int o = (8 * nt + g) * KP + 16 * kk + 2 * q;
      uint32_t b0 = operator_pair<BF16_STORE>(tile, o);
      uint32_t b1 = operator_pair<BF16_STORE>(tile, o + 8);
      if (nt == 2 * kk) b0 &= dmask;
      if (nt == 2 * kk + 1) b1 &= dmask;
      mma_bf16_k16(acc[nt], a0, a1, a2, a3, b0, b1);
    }
  }
  if constexpr (NT % 2 == 1) {
    // the last 8 states: one k8 step, no padding to a multiple of 16
    const uint32_t a0 = pack_bf16(c[NT - 1][0], c[NT - 1][1]);
    const uint32_t a1 = pack_bf16(c[NT - 1][2], c[NT - 1][3]);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      uint32_t b0 = operator_pair<BF16_STORE>(
          tile, (8 * nt + g) * KP + 8 * (NT - 1) + 2 * q);
      if (nt == NT - 1) b0 &= dmask;
      mma_bf16_k8(acc[nt], a0, a1, b0);
    }
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float d =
          operator_value<BF16_STORE>(tile, (8 * nt + 2 * q + h) * (KP + 1));
      acc[nt][h] = fmaf(d, round_bf16(c[nt][h]), acc[nt][h]);
      acc[nt][2 + h] = fmaf(d, round_bf16(c[nt][2 + h]), acc[nt][2 + h]);
    }
}

// The product on ring entry `e` as the profile computes it.
template <int NT, bool APPROX>
__device__ __forceinline__ void product(float (&acc)[NT][4],
                                        const float (&c)[NT][4],
                                        const char* e, bool op_bf16, int g,
                                        int q) {
  constexpr int KP = 8 * NT;
  if constexpr (APPROX) {
    if (op_bf16)
      product_bf16<NT, true>(acc, c, e, g, q);
    else
      product_bf16<NT, false>(acc, c, e, g, q);
  } else {
    const float* hi = reinterpret_cast<const float*>(e);
    product_3xtf32<NT>(acc, c, hi, hi + KP * KP, g, q);
  }
}

// Multiply c by 1/(its sum over states) for each of the thread's two
// pairs: the thread's states in order, then the quad's xor butterfly (all
// four lanes get the same bits).
template <int NT>
__device__ __forceinline__ void normalise(float (&c)[NT][4]) {
  float sa = 0.f, sb = 0.f;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    sa += c[nt][0];
    sa += c[nt][1];
    sb += c[nt][2];
    sb += c[nt][3];
  }
  sa += __shfl_xor_sync(0xffffffffu, sa, 1);
  sb += __shfl_xor_sync(0xffffffffu, sb, 1);
  sa += __shfl_xor_sync(0xffffffffu, sa, 2);
  sb += __shfl_xor_sync(0xffffffffu, sb, 2);
  const float ia = 1.f / sa, ib = 1.f / sb;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    c[nt][0] *= ia;
    c[nt][1] *= ia;
    c[nt][2] *= ib;
    c[nt][3] *= ib;
  }
}

// One thread's observations of one site: pair rows g and g + 8.
struct Obs {
  float oza, oha, ozb, ohb;
};

__device__ __forceinline__ Obs load_obs(const float* __restrict__ obs, int t,
                                        size_t P, int pa, int pb, bool la,
                                        bool lb) {
  const float* o = obs + 2 * static_cast<size_t>(t) * P;
  return Obs{la ? o[pa] : 1.f, la ? o[P + pa] : 0.f, lb ? o[pb] : 1.f,
             lb ? o[P + pb] : 0.f};
}

// The block: 1 to kMaxFwdWarps consumer warps of 16 pairs each (see
// forward_warps), then one producer warp whose lane 0 issues the ring's
// bulk copies. Shared memory: `ring` entries of entry_bytes(KP, APPROX),
// then `ring` full and `ring` empty mbarriers.
template <int NT, bool SEQ, bool APPROX>
__global__ void __launch_bounds__((kMaxFwdWarps + 1) * 32)
    hmm_forward_kernel(const float* __restrict__ Mf,   // [G][KP][KP]; exact: hi
                       const float* __restrict__ Mlo,  // exact: lo, else null
                       int G,
                       const float* __restrict__ em,   // [T][3][KP]
                       const float* __restrict__ obs,  // [T][2][P]
                       const float* __restrict__ isp,  // [KP]
                       const int* __restrict__ ops,    // [T]
                       const int* __restrict__ mask,   // [T]
                       AlphaT<APPROX>* __restrict__ alpha,  // [T][KP][P]
                       int T, int P,
                       const int* __restrict__ rops,   // [T], SEQ only
                       const float* __restrict__ hem,  // [T][KP], SEQ only
                       bool op_bf16,                   // Mf is bf16 (turbo)
                       int ring) {
  static_assert(SEQ || !APPROX, "the bf16 array branch is the tile kernel");
  constexpr int KP = 8 * NT;
  constexpr size_t kTile = tile_bytes(KP, APPROX);
  constexpr size_t kEntry = entry_bytes(KP, APPROX);
  constexpr int kCopies = APPROX ? 2 : 3;  // bulk copies an entry
  extern __shared__ float4 smem4[];
  char* entries = reinterpret_cast<char*>(smem4);
  uint64_t* full = reinterpret_cast<uint64_t*>(entries + ring * kEntry);
  uint64_t* empty = full + ring;
  const int n_warps = blockDim.x / 32 - 1;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n_entries = (T - 1) * (SEQ ? 2 : 1);

  if (threadIdx.x == 0) {
    for (int s = 0; s < ring; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                   :: "r"(smem_u32(&full[s])), "r"(kCopies) : "memory");
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                   :: "r"(smem_u32(&empty[s])), "r"(32 * n_warps)
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();  // barriers initialised; the only block-wide barrier

  if (warp == n_warps) {
    // producer: entry n into slot n % ring once every consumer has
    // released that slot's previous entry
    if (lane == 0) {
      for (int n = 0; n < n_entries; ++n) {
        const int s = n % ring;
        const int use = n / ring;
        if (use > 0) wait_phase(&empty[s], (use - 1) & 1);
        const int site = 1 + (SEQ ? n / 2 : n);
        const bool half_step = SEQ && (n & 1) == 0;
        const int op = SEQ && !half_step ? rops[site] : ops[site];
        if (op < 0 || op >= G) __trap();  // a caller bug: stop the kernel
        char* e = entries + s * kEntry;
        const size_t at = static_cast<size_t>(op) * KP * KP;
        if constexpr (APPROX) {
          if (op_bf16)
            bulk_copy(e, reinterpret_cast<const __nv_bfloat16*>(Mf) + at,
                      sizeof(__nv_bfloat16) * KP * KP, &full[s]);
          else
            bulk_copy(e, Mf + at, sizeof(float) * KP * KP, &full[s]);
        } else {
          bulk_copy(e, Mf + at, sizeof(float) * KP * KP, &full[s]);
          bulk_copy(e + kTile / 2, Mlo + at, sizeof(float) * KP * KP,
                    &full[s]);
        }
        if (half_step)
          bulk_copy(e + kTile, hem + static_cast<size_t>(site) * KP,
                    sizeof(float) * KP, &full[s]);
        else
          bulk_copy(e + kTile, em + static_cast<size_t>(site) * 3 * KP,
                    sizeof(float) * 3 * KP, &full[s]);
      }
    }
    return;
  }

  const int g = lane >> 2;
  const int q = lane & 3;
  const int pa = (blockIdx.x * n_warps + warp) * kWarpPairs + g;
  const int pb = pa + 8;
  const bool la = pa < P, lb = pb < P;
  const size_t Pz = static_cast<size_t>(P);

  auto store = [&](int t, const float (&c)[NT][4]) {
    AlphaT<APPROX>* alpha_t = alpha + static_cast<size_t>(t) * KP * Pz;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const size_t row = static_cast<size_t>(8 * nt + 2 * q + h) * Pz;
        if (la) alpha_t[row + pa] = float_to_alpha<APPROX>(c[nt][h]);
        if (lb) alpha_t[row + pb] = float_to_alpha<APPROX>(c[nt][2 + h]);
      }
  };
  // ring entry n: wait until it has landed; release it once read
  auto landed = [&](int n) -> const char* {
    const int s = n % ring;
    wait_phase(&full[s], (n / ring) & 1);
    return entries + s * kEntry;
  };
  auto release = [&](int n) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
                 :: "r"(smem_u32(&empty[n % ring])) : "memory");
  };

  float c[NT][4];
  {
    // site 0 (kernels.py:152-156)
    const Obs o = load_obs(obs, 0, Pz, pa, pb, la, lb);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = 8 * nt + 2 * q + h;
        c[nt][h] = isp[k] * emission(em, k, KP, o.oza, o.oha);
        c[nt][2 + h] = isp[k] * emission(em, k, KP, o.ozb, o.ohb);
      }
    normalise<NT>(c);
    store(0, c);
  }
  Obs o = T > 1 ? load_obs(obs, 1, Pz, pa, pb, la, lb) : Obs{};
  for (int t = 1; t < T; ++t) {
    // the next site's observations and mask, loaded before this site's
    // product so that their latency hides behind it
    const Obs o_next =
        t + 1 < T ? load_obs(obs, t + 1, Pz, pa, pb, la, lb) : Obs{};
    const bool scale = mask[t] != 0;  // kernels.py:147
    int n = (t - 1) * (SEQ ? 2 : 1);
    float acc[NT][4];
    const char* e = landed(n);
    product<NT, APPROX>(acc, c, e, op_bf16, g, q);
    if constexpr (SEQ) {
      // homozygous half-step (kernels.py:129-133); its result is the
      // marker step's carry
      const float* hem_t = reinterpret_cast<const float*>(e + kTile);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float2 hv =
            *reinterpret_cast<const float2*>(hem_t + 8 * nt + 2 * q);
        c[nt][0] = acc[nt][0] * hv.x;
        c[nt][1] = acc[nt][1] * hv.y;
        c[nt][2] = acc[nt][2] * hv.x;
        c[nt][3] = acc[nt][3] * hv.y;
      }
      release(n);
      e = landed(++n);
      product<NT, APPROX>(acc, c, e, op_bf16, g, q);
    }
    const float* em_t = reinterpret_cast<const float*>(e + kTile);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int k = 8 * nt + 2 * q;
      const float2 e0 = *reinterpret_cast<const float2*>(em_t + k);
      const float2 e1 = *reinterpret_cast<const float2*>(em_t + KP + k);
      const float2 e2 = *reinterpret_cast<const float2*>(em_t + 2 * KP + k);
      // emission(): em1 + em0minus1 * oz + em2minus0 * oh (HMM.cpp:827-828)
      c[nt][0] = acc[nt][0] * (e0.x + e1.x * o.oza + e2.x * o.oha);
      c[nt][1] = acc[nt][1] * (e0.y + e1.y * o.oza + e2.y * o.oha);
      c[nt][2] = acc[nt][2] * (e0.x + e1.x * o.ozb + e2.x * o.ohb);
      c[nt][3] = acc[nt][3] * (e0.y + e1.y * o.ozb + e2.y * o.ohb);
    }
    release(n);
    if (scale) normalise<NT>(c);
    store(t, c);
    o = o_next;
  }
}

// The bf16 array branch: FFMA products on a register tile. On tensor cores
// this branch moves alpha as far from the plain f32 version as a plain
// version with f64 sums does (6.0e-3 to 1.7e-2 at T=8192, P=8192 over three
// random batches, with the diagonal added last, against APPROX_ATOL's 5e-3;
// NVIDIA H100 80GB HBM3, 700 W; PERF.md §6): the carry, rounded to bf16 at
// every site and normalised only once a block, follows whichever f32 sums it
// is given, and only sums in the plain version's order stay on its
// trajectory. So each alpha element is one fmaf chain over j ascending from
// 0.f, on the FP32 pipe, and the rest is laid out to feed that pipe.
//
// Bound: fed from shared memory, a lane receives one 32-bit word a
// wavefront, and an SM serves one wavefront a clock against four
// warp-FFMAs; a uniform 16-byte load still takes four wavefronts. So a lane
// that holds R rows x C pairs of accumulators loads R operator and C carry
// words a j for R C FFMAs, and the product is shared-memory-bound unless
// (R + C) / (R C) <= 1/4 (one pair a lane, R = 9: 10/9; 9 x 4: 13/36;
// 9 x 8: 17/72).
//
// The design:
//   - a warp owns 4 C pairs and all KP states, so a pair's whole recursion
//     stays inside one warp: lane (a, b) = (lane % 8, lane / 8) holds the
//     state rows a + 8 i (i < RPW) of the C pairs 4 C w + C b + cc. The
//     carry goes through the warp's own [KP][S] shared buffer, between two
//     __syncwarp; no barrier spans warps;
//   - the operators by bulk copy a site ahead: a producer warp fills ring
//     slots (the site's operator and emission rows) on full/empty mbarriers
//     for the block's W consumer warps, as in the tensor-core kernel. The
//     table (tables.tile_operators) is the operators rounded to bf16 and
//     transposed, [j][k], the same f32 values on fast and turbo: the 8 row
//     groups of a warp read 8 consecutive words of row j, in 8 banks;
//   - the normalising sums are column_sum's: each row group's rows added in
//     order in its lane, then the 8 groups added in order (shuffles);
//   - C and W come from P and the SM count (tile_shape), and no sum depends
//     on them, so neither do the bits, nor a pair's alpha on its batch.

constexpr int kTileMaxRing = 4;
constexpr int kTileMaxWarps = 8;     // consumer warps a block, at most
constexpr int kTileMaxAcc = 72;      // accumulators a lane, at most (R C)
constexpr int kTileRowGroups = 8;    // a = lane % 8: rows a + 8 i
constexpr int kTilePairGroups = 4;   // b = lane / 8: C pairs each

// Floats per row of a warp's carry: past its 4 C pairs to an odd multiple
// of 4, so that the 8 row groups' stores of one pair group fall in 8
// distinct groups of 4 banks.
__host__ __device__ constexpr int tile_stride(int C) {
  return 4 * (C + 1 + (C & 1));
}

// Bytes of one ring slot: the operator [KP][KP] and the emission rows
// [3][KP], f32.
__host__ __device__ constexpr size_t tile_slot_bytes(int KP) {
  return sizeof(float) * (static_cast<size_t>(KP) * KP + 3 * KP);
}

// C adjacent floats of shared memory as 16-, 8- or 4-byte accesses.
template <int C>
__device__ __forceinline__ void load_pairs(float (&v)[C], const float* p) {
  if constexpr (C % 4 == 0) {
#pragma unroll
    for (int q = 0; q < C; q += 4) {
      const float4 x = *reinterpret_cast<const float4*>(p + q);
      v[q] = x.x, v[q + 1] = x.y, v[q + 2] = x.z, v[q + 3] = x.w;
    }
  } else if constexpr (C == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x, v[1] = x.y;
  } else {
    v[0] = *p;
  }
}

template <int C>
__device__ __forceinline__ void store_pairs(float* p, const float (&v)[C]) {
  if constexpr (C % 4 == 0) {
#pragma unroll
    for (int q = 0; q < C; q += 4)
      *reinterpret_cast<float4*>(p + q) =
          make_float4(v[q], v[q + 1], v[q + 2], v[q + 3]);
  } else if constexpr (C == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

// Alpha of the C adjacent pairs p0, p0 + 1, ... of one state row: one
// 2C-byte store where all are live and it is aligned (`vec`), else pair by
// pair, live pairs only.
template <int C>
__device__ __forceinline__ void store_alpha(__nv_bfloat16* row, int p0, int P,
                                            bool vec, const float (&v)[C]) {
  if (vec) {
    if constexpr (C == 8)
      *reinterpret_cast<uint4*>(row + p0) =
          make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                     pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
    else if constexpr (C == 4)
      *reinterpret_cast<uint2*>(row + p0) =
          make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
    else if constexpr (C == 2)
      *reinterpret_cast<uint32_t*>(row + p0) = pack_bf16(v[0], v[1]);
    else
      row[p0] = float_to_alpha<true>(v[0]);
  } else {
#pragma unroll
    for (int cc = 0; cc < C; ++cc)
      if (p0 + cc < P) row[p0 + cc] = float_to_alpha<true>(v[cc]);
  }
}

// acc[i][cc] = sum_j Mt[j][a + 8 i] * sC[j][C b + cc], one fmaf chain over
// j ascending from 0.f. The operands of step j + 1 are loaded into a second
// register set while step j's products issue: where a scheduler holds one
// warp (P=8192 on 132 SMs), no other warp hides the shared-memory latency.
template <int RPW, int C>
__device__ __forceinline__ void tile_product(float (&acc)[RPW][C],
                                             const float* __restrict__ Mt,
                                             const float* __restrict__ sC,
                                             int a, int b) {
  constexpr int KP = RPW * kTileRowGroups;
  constexpr int S = tile_stride(C);
  auto load = [&](int j, float (&m)[RPW], float (&v)[C]) {
    load_pairs<C>(v, sC + j * S + b * C);
#pragma unroll
    for (int i = 0; i < RPW; ++i) m[i] = Mt[j * KP + a + kTileRowGroups * i];
  };
  auto step = [&](const float (&m)[RPW], const float (&v)[C]) {
#pragma unroll
    for (int i = 0; i < RPW; ++i)
#pragma unroll
      for (int cc = 0; cc < C; ++cc) acc[i][cc] = fmaf(m[i], v[cc], acc[i][cc]);
  };
#pragma unroll
  for (int i = 0; i < RPW; ++i)
#pragma unroll
    for (int cc = 0; cc < C; ++cc) acc[i][cc] = 0.f;
  float m0[RPW], v0[C], m1[RPW], v1[C];
  load(0, m0, v0);
#pragma unroll 1
  for (int j = 0; j < KP - 2; j += 2) {
    load(j + 1, m1, v1);
    step(m0, v0);
    load(j + 2, m0, v0);
    step(m1, v1);
  }
  load(KP - 1, m1, v1);
  step(m0, v0);
  step(m1, v1);
}

// column_sum for each of the lane's pairs: `part` (the lane's rows, in
// order) of row groups 0, 1, ..., 7 added in order, from 0.f.
template <int C>
__device__ __forceinline__ void group_sums(const float (&part)[C], float (&s)[C],
                                           int b) {
#pragma unroll
  for (int cc = 0; cc < C; ++cc) {
    s[cc] = 0.f;
#pragma unroll
    for (int g = 0; g < kTileRowGroups; ++g)
      s[cc] += __shfl_sync(0xffffffffu, part[cc], kTileRowGroups * b + g);
  }
}

// The block: W = blockDim.x / 32 - 1 consumer warps (see the design above),
// then one producer warp whose lane 0 issues the ring's bulk copies. Shared
// memory: `ring` slots of tile_slot_bytes, the consumer warps' carries
// [W][KP][S], then `ring` full and `ring` empty mbarriers.
template <int RPW, int C>
__global__ void __launch_bounds__((kTileMaxWarps + 1) * 32)
    hmm_forward_tile_kernel(const float* __restrict__ Mt,   // [G][KP][KP], [j][k]
                            int G,
                            const float* __restrict__ em,   // [T][3][KP]
                            const float* __restrict__ obs,  // [T][2][P]
                            const float* __restrict__ isp,  // [KP]
                            const int* __restrict__ ops,    // [T]
                            __nv_bfloat16* __restrict__ alpha,  // [T][KP][P]
                            int T, int P, int ring) {
  constexpr int KP = RPW * kTileRowGroups;
  constexpr int S = tile_stride(C);
  constexpr size_t kSlot = tile_slot_bytes(KP);
  extern __shared__ float4 smem4[];
  const int n_warps = blockDim.x / 32 - 1;
  char* slots = reinterpret_cast<char*>(smem4);
  float* carries = reinterpret_cast<float*>(slots + ring * kSlot);
  uint64_t* full = reinterpret_cast<uint64_t*>(carries + n_warps * KP * S);
  uint64_t* empty = full + ring;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ring; ++s) {
      // two bulk copies fill a slot: the operator and the emission rows
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                   :: "r"(smem_u32(&full[s])), "r"(2) : "memory");
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                   :: "r"(smem_u32(&empty[s])), "r"(32 * n_warps)
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();  // barriers initialised; the only block-wide barrier

  if (warp == n_warps) {
    // producer: ring entry n (site n + 1) into slot n % ring once every
    // consumer has released that slot's previous entry
    if (lane == 0) {
      for (int n = 0; n + 1 < T; ++n) {
        const int s = n % ring;
        if (n >= ring) wait_phase(&empty[s], (n / ring - 1) & 1);
        const int op = ops[n + 1];
        if (op < 0 || op >= G) __trap();  // a caller bug: stop the kernel
        char* e = slots + s * kSlot;
        bulk_copy(e, Mt + static_cast<size_t>(op) * KP * KP,
                  sizeof(float) * KP * KP, &full[s]);
        bulk_copy(e + sizeof(float) * KP * KP,
                  em + static_cast<size_t>(n + 1) * 3 * KP,
                  sizeof(float) * 3 * KP, &full[s]);
      }
    }
    return;
  }

  const int a = lane % kTileRowGroups;
  const int b = lane / kTileRowGroups;
  const int p0 = (blockIdx.x * n_warps + warp) * kTilePairGroups * C + b * C;
  const bool vec = P % C == 0 && p0 + C <= P;
  const size_t Pz = static_cast<size_t>(P);
  float* sC = carries + warp * KP * S;  // this warp's carry [KP][S]

  // a site's observations of this lane's pairs; dead pairs read oz=1, oh=0
  auto load_obs = [&](int t, float (&oz)[C], float (&oh)[C]) {
    const float* o = obs + 2 * static_cast<size_t>(t) * Pz;
#pragma unroll
    for (int cc = 0; cc < C; ++cc) {
      const bool live = p0 + cc < P;
      oz[cc] = live ? o[p0 + cc] : 1.f;
      oh[cc] = live ? o[Pz + p0 + cc] : 0.f;
    }
  };
  // alpha of site t, and the carry the next site's product reads
  auto store = [&](int t, const float (&c)[RPW][C]) {
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int k = a + kTileRowGroups * i;
      store_alpha<C>(alpha + (static_cast<size_t>(t) * KP + k) * Pz, p0, P,
                     vec, c[i]);
      float r[C];
#pragma unroll
      for (int cc = 0; cc < C; ++cc) r[cc] = operand<true>(c[i][cc]);
      store_pairs<C>(sC + k * S + b * C, r);
    }
  };

  float c[RPW][C];
  float oz[C], oh[C];
  {
    // site 0 (kernels.py:152-156)
    load_obs(0, oz, oh);
    float part[C], s[C];
#pragma unroll
    for (int cc = 0; cc < C; ++cc) part[cc] = 0.f;
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int k = a + kTileRowGroups * i;
#pragma unroll
      for (int cc = 0; cc < C; ++cc) {
        c[i][cc] = isp[k] * emission(em, k, KP, oz[cc], oh[cc]);
        part[cc] += c[i][cc];
      }
    }
    group_sums<C>(part, s, b);
#pragma unroll
    for (int i = 0; i < RPW; ++i)
#pragma unroll
      for (int cc = 0; cc < C; ++cc) c[i][cc] = c[i][cc] / s[cc];
    store(0, c);
  }
  if (T > 1) load_obs(1, oz, oh);
  __syncwarp();  // the carry visible to the warp
  for (int t = 1; t < T; ++t) {
    const int n = t - 1;  // the site's ring entry
    // the next site's observations, loaded before this site's product so
    // that their latency hides behind it
    float oz_next[C], oh_next[C];
#pragma unroll
    for (int cc = 0; cc < C; ++cc) oz_next[cc] = 1.f, oh_next[cc] = 0.f;
    if (t + 1 < T) load_obs(t + 1, oz_next, oh_next);
    wait_phase(&full[n % ring], (n / ring) & 1);
    const float* Mt_t =
        reinterpret_cast<const float*>(slots + (n % ring) * kSlot);
    float acc[RPW][C];
    tile_product<RPW, C>(acc, Mt_t, sC, a, b);
    const float* em_t = Mt_t + KP * KP;
#pragma unroll
    for (int i = 0; i < RPW; ++i)
#pragma unroll
      for (int cc = 0; cc < C; ++cc)
        c[i][cc] = acc[i][cc] * emission(em_t, a + kTileRowGroups * i, KP,
                                         oz[cc], oh[cc]);
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
                 :: "r"(smem_u32(&empty[n % ring])) : "memory");
    if (t % kBlockSites == kBlockSites - 1) {
      // block normalisation (kernels.py:145, :396-398)
      float part[C], s[C];
#pragma unroll
      for (int cc = 0; cc < C; ++cc) part[cc] = 0.f;
#pragma unroll
      for (int i = 0; i < RPW; ++i)
#pragma unroll
        for (int cc = 0; cc < C; ++cc) part[cc] += c[i][cc];
      group_sums<C>(part, s, b);
#pragma unroll
      for (int cc = 0; cc < C; ++cc) {
        const float inv = 1.f / s[cc];
#pragma unroll
        for (int i = 0; i < RPW; ++i) c[i][cc] = c[i][cc] * inv;
      }
    }
    __syncwarp();  // the warp's reads of the carry done
    store(t, c);
    __syncwarp();  // the new carry visible
#pragma unroll
    for (int cc = 0; cc < C; ++cc) oz[cc] = oz_next[cc], oh[cc] = oh_next[cc];
  }
}

struct ForwardArgs {
  const float* Mf;
  const float* Mlo;
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
  int sms;  // the device's multiprocessors
};

// Consumer warps a block: 4 where the batch gives each multiprocessor at
// least three 16-pair warps, 2 below that (more blocks, fewer warps
// sharing an SM's shared-memory bandwidth; PERF.md §6 has the timings of
// 1, 2 and 4).
int forward_warps(int P, int sms) {
  const int warps = (P + kWarpPairs - 1) / kWarpPairs;
  return warps >= 3 * sms ? 4 : 2;
}

// Ring depth: as many entries (at most kMaxRing) as fit beside the other
// blocks an SM must hold for the whole grid to be resident; at least one.
int ring_depth(size_t entry, int blocks, int sms) {
  const int per_sm = (blocks + sms - 1) / sms;
  const size_t room = kFwdMaxShared / (per_sm > 0 ? per_sm : 1);
  const size_t bars = 2 * sizeof(uint64_t) * kMaxRing;
  int r = room > bars ? static_cast<int>((room - bars) / entry) : 0;
  if (r > kMaxRing) r = kMaxRing;
  if (r < 1) r = 1;
  return r;
}

// The tile kernel's shape: C pairs a lane (1, 2, 4 or 8, at most
// kTileMaxAcc accumulators) and W consumer warps a block (W = the warps an
// SM must hold, at most kTileMaxWarps), whichever C gives the least time a
// site on the busiest SM in a model of its work: each of the SM's four
// schedulers issues its warps' instructions one a clock (a warp-site: KP x
// (R C FFMA + R operator loads + the carry's loads + 1)), and its shared
// memory serves one wavefront a clock (a warp-site: KP x (R + C)). Ties go
// to the larger C, whose product leaves shared memory more slack.
struct TileShape {
  int C, W;
};

template <int RPW>
TileShape tile_shape(int P, int sms) {
  constexpr int KP = RPW * kTileRowGroups;
  TileShape best{1, 1};
  double best_cost = 0.0;
  for (int C = 1; C <= 8 && RPW * C <= kTileMaxAcc; C *= 2) {
    const int warps = (P + kTilePairGroups * C - 1) / (kTilePairGroups * C);
    int W = (warps + sms - 1) / sms;
    if (W > kTileMaxWarps) W = kTileMaxWarps;
    const int blocks = (warps + W - 1) / W;
    const int per_sm = (blocks + sms - 1) / sms * W;  // warps, busiest SM
    const double issue = ((per_sm + 3) / 4) * KP *
                         (RPW * C + RPW + (C + 3) / 4 + 1.0);
    const double shared = per_sm * KP * (RPW + C + 0.0);
    const double cost = issue > shared ? issue : shared;
    if (C == 1 || cost <= best_cost) best = TileShape{C, W}, best_cost = cost;
  }
  return best;
}

// The tile kernel at C pairs a lane and W warps a block. Ring depth: as
// many slots (at most kTileMaxRing) as fit beside the other blocks an SM
// must hold for the whole grid to be resident; two wherever two fit alone.
template <int RPW, int C>
int launch_forward_tile_c(const ForwardArgs& a, int W, cudaStream_t stream) {
  constexpr int KP = RPW * kTileRowGroups;
  constexpr size_t slot = tile_slot_bytes(KP);
  const size_t fixed = sizeof(float) * W * KP * tile_stride(C) +
                       2 * sizeof(uint64_t) * kTileMaxRing;
  const int warps = (a.P + kTilePairGroups * C - 1) / (kTilePairGroups * C);
  const int blocks = (warps + W - 1) / W;
  const size_t room = kFwdMaxShared / ((blocks + a.sms - 1) / a.sms);
  int ring = room > fixed ? static_cast<int>((room - fixed) / slot) : 0;
  if (ring > kTileMaxRing) ring = kTileMaxRing;
  if (ring < 2) ring = fixed + 2 * slot <= kFwdMaxShared ? 2 : 1;
  const size_t smem = ring * slot + sizeof(float) * W * KP * tile_stride(C) +
                      2 * ring * sizeof(uint64_t);
  if (smem > kFwdMaxShared) return static_cast<int>(cudaErrorInvalidValue);
  auto* kernel = hmm_forward_tile_kernel<RPW, C>;
  const int rc = allow_shared(kernel, smem);
  if (rc != 0) return rc;
  kernel<<<blocks, 32 * (W + 1), smem, stream>>>(
      a.Mf, a.G, a.em, a.obs, a.isp, a.ops,
      static_cast<__nv_bfloat16*>(a.alpha), a.T, a.P, ring);
  return static_cast<int>(cudaGetLastError());
}

// The tile kernel: the bf16 array branch.
template <int RPW>
int launch_forward_tile(const ForwardArgs& a, cudaStream_t stream) {
  const TileShape s = tile_shape<RPW>(a.P, a.sms);
  if constexpr (RPW * 8 <= kTileMaxAcc)
    if (s.C == 8) return launch_forward_tile_c<RPW, 8>(a, s.W, stream);
  if constexpr (RPW * 4 <= kTileMaxAcc)
    if (s.C == 4) return launch_forward_tile_c<RPW, 4>(a, s.W, stream);
  if (s.C == 2) return launch_forward_tile_c<RPW, 2>(a, s.W, stream);
  return launch_forward_tile_c<RPW, 1>(a, s.W, stream);
}

// The tensor-core kernel: the exact branches and the bf16 sequence branch.
template <int NT, bool SEQ, bool APPROX>
int launch_forward_mma(const ForwardArgs& a, cudaStream_t stream) {
  constexpr int KP = 8 * NT;
  constexpr size_t entry = entry_bytes(KP, APPROX);
  static_assert(entry + 2 * sizeof(uint64_t) <= kFwdMaxShared,
                "one ring entry exceeds shared memory");
  const int warps = forward_warps(a.P, a.sms);
  const int blocks = (a.P + warps * kWarpPairs - 1) / (warps * kWarpPairs);
  const int ring = ring_depth(entry, blocks, a.sms);
  const size_t smem = ring * entry + 2 * ring * sizeof(uint64_t);
  auto* kernel = hmm_forward_kernel<NT, SEQ, APPROX>;
  const int rc = allow_shared(kernel, smem);
  if (rc != 0) return rc;
  kernel<<<blocks, 32 * (warps + 1), smem, stream>>>(
      a.Mf, a.Mlo, a.G, a.em, a.obs, a.isp, a.ops, a.mask,
      static_cast<AlphaT<APPROX>*>(a.alpha), a.T, a.P, a.rops, a.hem,
      a.op_bf16, ring);
  return static_cast<int>(cudaGetLastError());
}

template <int NT, bool SEQ, bool APPROX>
int launch_forward(const ForwardArgs& a, cudaStream_t stream) {
  if constexpr (APPROX && !SEQ)
    return launch_forward_tile<NT>(a, stream);
  else
    return launch_forward_mma<NT, SEQ, APPROX>(a, stream);
}

template <bool SEQ, bool APPROX>
int forward_variant(const ForwardArgs& a, int nt, cudaStream_t stream) {
  return dispatch_rpw(nt, [&](auto r) {
    return launch_forward<decltype(r)::value, SEQ, APPROX>(a, stream);
  });
}

}  // namespace
}  // namespace fastsmc

// Launch the forward kernel on `stream` (device `device`); returns the
// cudaError_t of the launch. `profile` is kExact, kFast or kTurbo: on
// kExact `Mf` and `Mlo` are the operators' TF32 split (hi, lo; f32 values
// with the low 13 mantissa bits zero, Mf = hi + lo); on kFast and kTurbo
// `Mlo` is null, and `Mf` is in sequence mode the operators (f32 on kFast,
// bf16 on kTurbo), in array mode their bf16 values transposed, f32 [G][j][k]
// on both (tables.tile_operators). Alpha is f32 on kExact, bf16 otherwise.
// Sequence mode when `rops` and `hem` are given, array mode when both are
// null. KP must be a multiple of 8, at most 128.
extern "C" int fastsmc_hmm_forward(const void* Mf, const float* Mlo,
                                   int profile, int G, const float* em,
                                   const float* obs, const float* isp,
                                   const int* ops, const int* rops,
                                   const float* hem, const int* mask,
                                   void* alpha, int T, int P, int KP,
                                   int device, void* stream) {
  using namespace fastsmc;
  if (T <= 0 || P <= 0 || G <= 0 || KP % 8 != 0 || profile < kExact ||
      profile > kTurbo || (profile == kExact) != (Mlo != nullptr) ||
      (rops == nullptr) != (hem == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  int sms = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const ForwardArgs a{static_cast<const float*>(Mf), Mlo, G, em, obs, isp,
                      ops, rops, hem, mask, alpha, T, P,
                      profile == kTurbo, sms};
  const int nt = KP / 8;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool seq = rops != nullptr;
  if (profile == kExact)
    return seq ? forward_variant<true, false>(a, nt, s)
               : forward_variant<false, false>(a, nt, s);
  return seq ? forward_variant<true, true>(a, nt, s)
             : forward_variant<false, true>(a, nt, s);
}
