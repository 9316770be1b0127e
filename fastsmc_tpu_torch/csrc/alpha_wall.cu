// The alpha-wall probe's two kernels: a forward pass that stores alpha and a
// backward-shaped pass that reads it, each with and without the alpha
// traffic, so that their times tell whether the alpha round trip through
// device memory or the operator products bound a decode pass.
//
// Replaces the Pallas TPU kernels of scripts/alpha_wall_probe.py:
// `make_fwd` (:74-108, launched at :129) and `make_bwd` (:137-155,
// launched at :175). Both run over T sites for P pairs with KC = 128 state
// rows, an operator M[ops[t]] ([G][KC][KC] bf16) per site, the emission
//   em(t)[k] = em[t][0][k] + em[t][1][k] * obs[t][0][p] + em[t][2][k] * obs[t][1][p]
// and products bf16(M) @ bf16(v) accumulated in f32, both on the tensor
// cores (wgmma).
// Forward (make_fwd):
//   c_0 = isp * em(0);  c_t = (M[ops[t]] @ bf16(c_{t-1})) * em(t);
//   each c_t is divided by its column sum, or with NORM_BLOCK only at the
//   last site of each S-site block counted from site 0 (so site 0 itself is
//   not, unless S == 1); STORE_EVERY stores bf16(c_t[:KA]) at every site
//   ([T][KA][P]), otherwise only at each block's last site ([T/S][KA][P]).
// Backward (make_bwd), from site T-1 down to 0, the carry starting at 1/KC
// (the Pallas kernel leaves its carry uninitialised; see probes/
// alpha_wall.py):
//   c = M[ops[r]] @ bf16(carry * em(r));
//   carry = c / colsum(c), or with NORM_BLOCK c except at the block's last
//   step (r % S == 0);
//   a = alpha[r] (READ_EVERY) or alpha[r / S], as f32;
//   post = a * (NORM_BLOCK ? c[:KA] : carry[:KA]);
//   out[r][p] = sum_{k < min(10, KA)} post[k] / sum_{k < KA} post[k]
//   (the probe divides each row by the sum, then adds the ten; here the ten
//   are added first, one division less: they differ in the last f32 bits);
//   where asked, the raw carry [KC][P] after site carry_site: the output is
//   renormalised per column, so only the carry shows where the pass
//   normalises.
//
// Bound on an H100: per pair and site a 128 x 128 product (16k FMA, 32k
// FLOP) against 144 bytes of bf16 alpha written or read (18 when once per
// block). At T=4096, KA=72, P=8192 alpha is 4.83 GB a pass (1.44 ms at
// 3.35 TB/s), the products 1.10 TFLOP (1.11 ms at 989 TFLOP/s bf16; 16.4 ms
// on the FP32 pipe, which is why both kernels leave it): the every-site
// variants are memory-bound, the once-a-block ones bound by their products.
// Measured, neither sets a pass: the per-site chain of one warpgroup a block
// does (8 wgmma, then the epilogue on the FP32 pipe that makes the next
// site's operand), one warp a scheduler at P=8192: 4.5-5.9 ms a forward
// pass, 7.4 a backward one (PERF.md §6). Both kernels share one design
// (the backward's note, below, gives it in full): a warpgroup owns 64 pairs
// with the carry in wgmma's accumulator layout, a producer warp stages each
// site's operator by TMA and its emission rows sites ahead (the backward
// also its alpha tile, the forward the block's observations), and every sum
// over states is the thread's own values, then its quad: no block barrier
// sits on a site's chain.
#include <cuda.h>

#include "hmm_common.cuh"

namespace fastsmc {
namespace {

constexpr int kStates = 128;                   // KC
constexpr int kPostRows = 10;                  // rows summed into out

// The backward kernel on the tensor cores.
//
// Replaces `make_bwd` (scripts/alpha_wall_probe.py:137-155). Bound on an
// H100: alpha's read, T x KA x P bf16 (4.83 GB at T=4096, KA=72, P=8192:
// 1.44 ms at 3.35 TB/s; 1.57 ms with the other inputs and the output),
// against 1.10 TFLOP of products (1.11 ms at 989 TFLOP/s bf16; 16.4 ms on
// the FP32 pipe, which is why the products leave it). The design:
//   - pairs are the M dimension of wgmma m64n128k16 (bf16 operands, f32
//     sums): a block's four consumer warps are one warpgroup of 64 pairs,
//     a warp 16 of them (an m-tile) and all 128 states, 8 wgmma a site.
//     Thread (g, q) = (lane / 4, lane % 4) holds states 8 nt + 2 q + h of
//     m-tile rows g and g + 8 (pairs 2 g and 2 g + 1 of the warp's 16), in
//     mma.sync's accumulator layout, which wgmma's is too: the carry, times
//     the emission and rounded to bf16, is each k-step's A fragment in
//     registers, made while the wgmma of the k-steps before it run, so the
//     carry never leaves the registers. With mma.sync in the same layout
//     (one warp or two an m-tile) the HMMA and ldmatrix that one warp a
//     scheduler had to issue set the time;
//   - B is M[ops[r]] as stored, row-major [n][k] (K-major): a producer warp
//     copies it by two TMA tile loads a site (k 0-63 and 64-127, 128B
//     swizzle: the canonical layout that wgmma reads, without a bank
//     conflict) into a ring of slots up to kMaxRing sites ahead, with the
//     site's emission rows and the block's alpha tile [KA][64 pairs] by
//     16-byte cp.async; full / empty mbarriers, as in hmm_forward.cu's mma
//     kernel. Alpha thus arrives sites ahead of its use, and its read costs
//     bandwidth, not latency. Where P % 8 != 0 alpha's rows are not 16-byte
//     aligned, and the producer loads and stores them element by element
//     (correct, slower: the probe is timed at P=8192);
//   - each pair's column sum and its two output sums (states k < 10 and
//     k < KA) are the thread's own values, then two xor shuffles over its
//     quad: no block barrier sits on a site's chain;
//   - each staged operator serves the block's 64 pairs: at P=8192, 128
//     blocks read 17 GB of operator a pass from L2 (34 GB at 32 pairs a
//     block), while alpha's 4.83 GB come from device memory.
// The products run on the tensor cores only; the FP32 pipe does the
// emission (two FFMA a state and pair, the plain version's bits for 0/1
// observations), the normalisation and the output sums. The sums over
// states run in another order than the plain version's, and the tensor
// cores add with truncation, so the carry stays within bf16 level of it.

constexpr int kNTiles = kStates / 8;                  // n-tiles of 8 states
constexpr int kKSteps = kStates / 16;                 // k-steps of 16 states
// both kernels' block: one warpgroup of consumer warps (16 pairs each), then
// one producer warp
constexpr int kWgWarps = 4;
constexpr int kWgPairs = 16 * kWgWarps;               // pairs a block
constexpr int kHalfBytes = kStates * 128;             // 64 k of 128 rows, bf16
constexpr int kOpBytes = 2 * kHalfBytes;              // the operator, 32 KB
constexpr int kEmBytes = 3 * kStates * sizeof(float); // the site's emission rows
// a row of a slot's alpha tile (64 pairs, bf16), padded by 16 bytes so that
// the rows 2 apart that a quad reads start 8 banks apart
constexpr int kAlphaRow = 2 * kWgPairs + 16;
// a slot: the operator (1024-byte aligned for the swizzle), the emission
// rows and `tile` bytes more, rounded up to 1024 bytes
constexpr int slot_bytes(int tile) {
  return (kOpBytes + kEmBytes + tile + 1023) / 1024 * 1024;
}
// the backward's slot also holds alpha's tile, 128 rows (those from KA on
// stay 0); the forward's the block's observations, two rows of 64 pairs
constexpr int kObsBytes = 2 * kWgPairs * sizeof(float);
constexpr int kBwdSlotBytes = slot_bytes(kStates * kAlphaRow);
constexpr int kFwdSlotBytes = slot_bytes(kObsBytes);   // 35 KB
// the forward's store tiles: two a consumer warp, [KC][16 pairs] bf16 each
constexpr int kTileRow = 16 * sizeof(__nv_bfloat16);
constexpr int kTileBytes = kStates * kTileRow;
constexpr int kFwdTiles = 2 * kWgWarps * kTileBytes;  // 32 KB
constexpr int kMaxRing = 4;
constexpr size_t kMaxShared = 232448;  // dynamic shared memory a block may take

// Two floats rounded to bf16 (nearest even) in one word, `lo` in the low
// half: the order of k in a bf16x2 fragment register.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The wgmma descriptor of a K-major, 128B-swizzled bf16 tile at shared
// address `addr` (1024-byte aligned, plus 32 bytes a k-step): 8-row groups
// 1024 bytes apart.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr >> 4) & 0x3fff) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}

// c (+)= A @ B for one k-step: A [64 pairs][16 k] from each warp's
// registers, B [16 k][128 n] from shared memory (`desc`); c overwritten
// where `accumulate` is 0.
__device__ __forceinline__ void wgmma_k16(float (&c)[kNTiles][4],
                                          const uint32_t (&a)[4],
                                          uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %68, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %69, p, 1, 1, 0;\n}\n"
      : "+f"(c[0][0]), "+f"(c[0][1]), "+f"(c[0][2]), "+f"(c[0][3]),
        "+f"(c[1][0]), "+f"(c[1][1]), "+f"(c[1][2]), "+f"(c[1][3]),
        "+f"(c[2][0]), "+f"(c[2][1]), "+f"(c[2][2]), "+f"(c[2][3]),
        "+f"(c[3][0]), "+f"(c[3][1]), "+f"(c[3][2]), "+f"(c[3][3]),
        "+f"(c[4][0]), "+f"(c[4][1]), "+f"(c[4][2]), "+f"(c[4][3]),
        "+f"(c[5][0]), "+f"(c[5][1]), "+f"(c[5][2]), "+f"(c[5][3]),
        "+f"(c[6][0]), "+f"(c[6][1]), "+f"(c[6][2]), "+f"(c[6][3]),
        "+f"(c[7][0]), "+f"(c[7][1]), "+f"(c[7][2]), "+f"(c[7][3]),
        "+f"(c[8][0]), "+f"(c[8][1]), "+f"(c[8][2]), "+f"(c[8][3]),
        "+f"(c[9][0]), "+f"(c[9][1]), "+f"(c[9][2]), "+f"(c[9][3]),
        "+f"(c[10][0]), "+f"(c[10][1]), "+f"(c[10][2]), "+f"(c[10][3]),
        "+f"(c[11][0]), "+f"(c[11][1]), "+f"(c[11][2]), "+f"(c[11][3]),
        "+f"(c[12][0]), "+f"(c[12][1]), "+f"(c[12][2]), "+f"(c[12][3]),
        "+f"(c[13][0]), "+f"(c[13][1]), "+f"(c[13][2]), "+f"(c[13][3]),
        "+f"(c[14][0]), "+f"(c[14][1]), "+f"(c[14][2]), "+f"(c[14][3]),
        "+f"(c[15][0]), "+f"(c[15][1]), "+f"(c[15][2]), "+f"(c[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(accumulate),
        "l"(desc));
}

// One TMA tile load of the operator map into shared `dst`, completing on
// the barrier: the box at (column c0, row c1).
__device__ __forceinline__ void tma_tile(void* dst, const CUtensorMap* map,
                                         int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0),
         "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// One TMA store of the shared tile `src` to the box at (column c0, row c1)
// of `map`, in a bulk group of its own.
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%1, %2}], "
      "[%3];"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(smem_u32(src))
      : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// The barrier expects `bytes` more (one arrival).
__device__ __forceinline__ void expect_bytes(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// 16 bytes from global `src` to shared `dst` (both 16-byte aligned),
// asynchronously.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

// One arrival on the barrier once this thread's cp.async copies so far
// have landed, and one now (release: this thread's shared stores so far).
__device__ __forceinline__ void arrive_after_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];"
               :: "r"(smem_u32(bar)) : "memory");
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem_u32(bar)) : "memory");
}

// em0 + em1 * oz + em2 * oh (HMM.cpp:827-828): the plain version's bits
// wherever oz and oh are 0 or 1, as the probe's observations are.
__device__ __forceinline__ float emission_of(float e0, float e1, float e2,
                                             float oz, float oh) {
  return fmaf(e2, oh, fmaf(e1, oz, e0));
}

// Sum of v's 16 values as a tree: v[i] + v[i + 8], then + 4, + 2, + 1.
__device__ __forceinline__ float tree_sum(float (&v)[kNTiles]) {
  static_assert(kNTiles == 16, "the tree is written out for 16 n-tiles");
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = __fadd_rn(v[i], v[i + 8]);
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = __fadd_rn(v[i], v[i + 4]);
  v[0] = __fadd_rn(v[0], v[2]);
  v[1] = __fadd_rn(v[1], v[3]);
  return __fadd_rn(v[0], v[1]);
}

// Sum over the thread's quad (the four lanes of one pair row): two xor
// shuffles, the same bits in every lane.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// One thread's observations of one site: its pairs a and b.
struct Obs {
  float oza, oha, ozb, ohb;
};

__device__ __forceinline__ Obs load_obs(const float* __restrict__ obs, int t,
                                        size_t P, int pa, int pb, bool la,
                                        bool lb) {
  const float* o = obs + 2 * static_cast<size_t>(t) * P;
  return Obs{la ? o[pa] : 0.f, la ? o[P + pa] : 0.f, lb ? o[pb] : 0.f,
             lb ? o[P + pb] : 0.f};
}

// The producer warp's staging of site r's operator `op` and emission rows
// into slot `e`: the operator by two TMA tile loads (lane 0, whose arrival
// on `full` expects their bytes; where `op` < 0 no operator, and the arrival
// expects none), the emission rows by 16-byte cp.async.
__device__ __forceinline__ void stage_operator_em(char* e, uint64_t* full,
                                                  const CUtensorMap* map,
                                                  int op,
                                                  const float* __restrict__ em,
                                                  int r, int lane) {
  if (lane == 0) {
    expect_bytes(full, op < 0 ? 0 : kOpBytes);
    if (op >= 0) {
      tma_tile(e, map, 0, op * kStates, full);
      tma_tile(e + kHalfBytes, map, kStates / 2, op * kStates, full);
    }
  }
  const char* em_r =
      reinterpret_cast<const char*>(em + static_cast<size_t>(r) * 3 * kStates);
  for (int i = lane; i < kEmBytes / 16; i += 32)
    cp_async16(e + kOpBytes + 16 * i, em_r + 16 * i);
}

// The backward's staging of site r into slot `e`: the operator and the
// emission rows, then alpha's KA rows of the block's pairs from p0 (16-byte
// copies where `vec`: P % 8 == 0; element by element otherwise, dead pairs
// 0). Ends with its lane's two arrivals on `full` (and lane 0's third, which
// expects the operator's bytes).
template <bool READ_EVERY>
__device__ __forceinline__ void stage_site(
    char* e, uint64_t* full, const CUtensorMap* map, int op,
    const float* __restrict__ em, const __nv_bfloat16* __restrict__ alpha,
    int r, int S, int P, int KA, int p0, bool vec, int lane) {
  stage_operator_em(e, full, map, op, em, r, lane);
  char* at = e + kOpBytes + kEmBytes;
  const unsigned short* a_r = reinterpret_cast<const unsigned short*>(alpha) +
                              static_cast<size_t>(READ_EVERY ? r : r / S) * KA * P + p0;
  if (vec) {
    // 8 chunks of 8 pairs a row; chunks past P stay stale (dead lanes)
    for (int i = lane; i < KA * 8; i += 32) {
      const int row = i >> 3, ch = i & 7;
      if (p0 + 8 * ch < P)
        cp_async16(at + row * kAlphaRow + 16 * ch,
                   a_r + static_cast<size_t>(row) * P + 8 * ch);
    }
  } else {
    // 16 elements a lane in flight, then their stores
    const int total = KA * kWgPairs;
    for (int i0 = lane; i0 < total; i0 += 32 * 16) {
      unsigned short v[16];
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        const int i = i0 + 32 * u, j = i % kWgPairs;
        v[u] = i < total && p0 + j < P
                   ? __ldg(a_r + static_cast<size_t>(i / kWgPairs) * P + j)
                   : static_cast<unsigned short>(0);
      }
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        const int i = i0 + 32 * u;
        if (i < total)
          *reinterpret_cast<unsigned short*>(at + (i / kWgPairs) * kAlphaRow +
                                             2 * (i % kWgPairs)) = v[u];
      }
    }
  }
  arrive_after_copies(full);
}

// Thread 0 initialises the ring's barriers: a slot is full after the
// operator's expected bytes and two arrivals a producer lane, empty after
// one arrival a consumer thread.
__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty,
                                          int ring) {
  if (threadIdx.x != 0) return;
  for (int s = 0; s < ring; ++s) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                 :: "r"(smem_u32(&full[s])), "r"(1 + 64) : "memory");
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                 :: "r"(smem_u32(&empty[s])), "r"(32 * kWgWarps)
                 : "memory");
  }
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// The block: one warpgroup of kWgWarps consumer warps (16 pairs each),
// then one producer warp. Shared memory, from a 1024-byte aligned base:
// `ring` slots of kBwdSlotBytes, then `ring` full and `ring` empty mbarriers.
template <bool READ_EVERY, bool NORM_BLOCK>
__global__ void __launch_bounds__((kWgWarps + 1) * 32)
    alpha_wall_backward_kernel(const __grid_constant__ CUtensorMap map,
                               int G,
                               const float* __restrict__ em,   // [T][3][KC]
                               const float* __restrict__ obs,  // [T][2][P]
                               const __nv_bfloat16* __restrict__ alpha,
                               const int* __restrict__ ops,    // [T]
                               float* __restrict__ out,        // [T][P]
                               float* __restrict__ carry_out,  // [KC][P] or null
                               int carry_site, int T, int P, int KA, int S,
                               int ring, bool vec) {
  extern __shared__ float4 smem4[];
  char* slots = reinterpret_cast<char*>(
      (reinterpret_cast<uintptr_t>(smem4) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(slots + ring * kBwdSlotBytes);
  uint64_t* empty = full + ring;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int p0 = blockIdx.x * kWgPairs;

  // rows KA .. KC - 1 of every slot's alpha tile are never staged: 0
  const int zero_words = (kStates - KA) * kAlphaRow / 4;
  for (int i = threadIdx.x; i < ring * zero_words; i += blockDim.x)
    reinterpret_cast<uint32_t*>(slots + (i / zero_words) * kBwdSlotBytes +
                                kOpBytes + kEmBytes + KA * kAlphaRow)[i % zero_words] = 0u;
  init_ring(full, empty, ring);
  __syncthreads();  // barriers initialised; the only block-wide barrier

  if (warp == kWgWarps) {
    // producer: site T-1-n into slot n % ring once every consumer has
    // released that slot's previous site
    for (int n = 0; n < T; ++n) {
      const int s = n % ring;
      const int use = n / ring;
      if (use > 0) wait_phase(&empty[s], (use - 1) & 1);
      const int r = T - 1 - n;
      const int op = ops[r];
      if (op < 0 || op >= G) __trap();  // a caller bug: stop the kernel
      stage_site<READ_EVERY>(slots + s * kBwdSlotBytes, &full[s], &map, op, em,
                             alpha, r, S, P, KA, p0, vec, lane);
    }
    return;
  }

  const int g = lane >> 2;
  const int q = lane & 3;
  const int pa = p0 + 16 * warp + 2 * g;  // m-tile row g
  const int pb = pa + 1;                  // m-tile row g + 8
  const bool la = pa < P, lb = pb < P;
  const size_t Pz = static_cast<size_t>(P);
  // the thread's alpha in a slot's tile: row 2 q, pairs a and b in one word
  const int a_lane = kOpBytes + kEmBytes + 2 * q * kAlphaRow + 2 * (16 * warp + 2 * g);

  // the carry and the product's accumulators: [nt][h] pair a, [nt][2 + h]
  // pair b (the accumulators are the wgmma's, so the carry has its own)
  float carry[kNTiles][4], c[kNTiles][4];
#pragma unroll
  for (int nt = 0; nt < kNTiles; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) carry[nt][i] = 1.f / kStates;
  Obs o = load_obs(obs, T - 1, Pz, pa, pb, la, lb);
  for (int n = 0; n < T; ++n) {
    const int r = T - 1 - n;
    // the next site's observations: in flight through this site's product
    const Obs o_next = r > 0 ? load_obs(obs, r - 1, Pz, pa, pb, la, lb) : Obs{};

    const int s = n % ring;
    wait_phase(&full[s], (n / ring) & 1);
    const char* e = slots + s * kBwdSlotBytes;
    const float* em_r = reinterpret_cast<const float*>(e + kOpBytes);
    // c = bf16(carry * em(r)) @ M^T: k-step kk's A fragment (n-tiles 2 kk,
    // 2 kk + 1 of the carry times the emission, rounded to bf16) is made
    // while the wgmma of the k-steps before it run; k-steps 0-3 read the
    // operator's first 64-column half, 4-7 its second, 32 bytes a step
    const uint32_t op_addr = smem_u32(e);
    uint32_t A[kKSteps][4];
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int nt = 2 * kk + t;
        const int k = 8 * nt + 2 * q;
        const float2 e0 = *reinterpret_cast<const float2*>(em_r + k);
        const float2 e1 = *reinterpret_cast<const float2*>(em_r + kStates + k);
        const float2 e2 = *reinterpret_cast<const float2*>(em_r + 2 * kStates + k);
        A[kk][2 * t] = pack_bf16(
            __fmul_rn(carry[nt][0], emission_of(e0.x, e1.x, e2.x, o.oza, o.oha)),
            __fmul_rn(carry[nt][1], emission_of(e0.y, e1.y, e2.y, o.oza, o.oha)));
        A[kk][2 * t + 1] = pack_bf16(
            __fmul_rn(carry[nt][2], emission_of(e0.x, e1.x, e2.x, o.ozb, o.ohb)),
            __fmul_rn(carry[nt][3], emission_of(e0.y, e1.y, e2.y, o.ozb, o.ohb)));
      }
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
      wgmma_k16(c, A[kk],
                sw128_desc(op_addr + (kk / 4) * kHalfBytes + 32 * (kk % 4)),
                kk > 0);
    }
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    // the A fragments and accumulators were in the wgmma's hands until
    // here: keep the compiler from reusing or reading them earlier
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk)
      asm volatile("" : "+r"(A[kk][0]), "+r"(A[kk][1]), "+r"(A[kk][2]),
                   "+r"(A[kk][3]) :: "memory");
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt)
      asm volatile("" : "+f"(c[nt][0]), "+f"(c[nt][1]), "+f"(c[nt][2]),
                   "+f"(c[nt][3]) :: "memory");

    // post = alpha * c over k < KA (alpha's rows from KA on are 0): each
    // pair's sums over k < 10 and over all k, the thread's n-tiles added as
    // a tree, then the quad. The plain version's post is alpha * carry
    // (normalised) without NORM_BLOCK; c is that times the pair's column
    // sum, which out = top / all leaves as it is
    float pa_t[kNTiles], pb_t[kNTiles];
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
      // rows 8 nt + 2 q (w0) and + 1 (w1), pair a low, pair b high
      const char* ar = e + a_lane + 8 * nt * kAlphaRow;
      const uint32_t w0 = *reinterpret_cast<const uint32_t*>(ar);
      const uint32_t w1 = *reinterpret_cast<const uint32_t*>(ar + kAlphaRow);
      pa_t[nt] = fmaf(bf16_lo(w1), c[nt][1], bf16_lo(w0) * c[nt][0]);
      pb_t[nt] = fmaf(bf16_hi(w1), c[nt][3], bf16_hi(w0) * c[nt][2]);
    }
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
                 :: "r"(smem_u32(&empty[s])) : "memory");
    // states 0-7, and 8-9 (q == 0) of n-tile 1: k < kPostRows
    float top_a = q == 0 ? __fadd_rn(pa_t[0], pa_t[1]) : pa_t[0];
    float top_b = q == 0 ? __fadd_rn(pb_t[0], pb_t[1]) : pb_t[0];
    float all_a = tree_sum(pa_t);
    float all_b = tree_sum(pb_t);
    // the carry: c divided by its column sum, or with NORM_BLOCK c itself
    // but at each block's last step (r % S == 0)
    if (!NORM_BLOCK || r % S == 0) {
      float sa[kNTiles], sb[kNTiles];
#pragma unroll
      for (int nt = 0; nt < kNTiles; ++nt) {
        sa[nt] = __fadd_rn(c[nt][0], c[nt][1]);
        sb[nt] = __fadd_rn(c[nt][2], c[nt][3]);
      }
      const float ia = 1.f / quad_sum(tree_sum(sa));
      const float ib = 1.f / quad_sum(tree_sum(sb));
#pragma unroll
      for (int nt = 0; nt < kNTiles; ++nt) {
        carry[nt][0] = __fmul_rn(c[nt][0], ia);
        carry[nt][1] = __fmul_rn(c[nt][1], ia);
        carry[nt][2] = __fmul_rn(c[nt][2], ib);
        carry[nt][3] = __fmul_rn(c[nt][3], ib);
      }
    } else {
#pragma unroll
      for (int nt = 0; nt < kNTiles; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) carry[nt][i] = c[nt][i];
    }
    if (carry_out && r == carry_site) {
#pragma unroll
      for (int nt = 0; nt < kNTiles; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const size_t row = static_cast<size_t>(8 * nt + 2 * q + h) * Pz;
          if (la) carry_out[row + pa] = carry[nt][h];
          if (lb) carry_out[row + pb] = carry[nt][2 + h];
        }
    }
    top_a = quad_sum(top_a);
    all_a = quad_sum(all_a);
    top_b = quad_sum(top_b);
    all_b = quad_sum(all_b);
    float* out_r = out + static_cast<size_t>(r) * Pz;
    if (q == 0 && la) out_r[pa] = top_a / all_a;
    if (q == 1 && lb) out_r[pb] = top_b / all_b;
    o = o_next;
  }
}

// The forward kernel on the tensor cores.
//
// Replaces `make_fwd` (scripts/alpha_wall_probe.py:74-108). Bound on an
// H100: alpha's write, T x KA x P bf16 (4.83 GB at T=4096, KA=72, P=8192:
// 1.44 ms at 3.35 TB/s; 1.53 ms with the other inputs), against 1.10 TFLOP
// of products (1.11 ms at 989 TFLOP/s bf16). The design is the backward's,
// with alpha written instead of read:
//   - the block's warpgroup owns 64 pairs, thread (g, q) states 8 nt + 2 q +
//     h of pairs 2 g and 2 g + 1 of its warp's 16, in wgmma's accumulator
//     layout. The next site's A is bf16(c), packed into all 8 k-steps'
//     fragments at the end of this site, so a site issues its 8 wgmma back
//     to back: the carry never leaves the registers;
//   - the producer warp stages each site's operator by TMA, its emission
//     rows and the block's two observation rows by cp.async into a ring of
//     35 KB slots, sites ahead (site 0: no operator). So a consumer touches
//     no global memory on a site's chain: with its observations loaded from
//     global memory a site ahead, the proxy fence before each alpha store (a
//     MEMBAR in SASS) waited for those loads, and a pass's time moved by
//     milliseconds with where the compiler put them;
//   - the epilogue runs in registers: the emission, the column sum (the
//     thread's 32 values as a tree, then its quad; only at the sites that
//     normalise) and the normalisation;
//   - alpha: each warp writes its rows k < KA into a shared tile [KA][16
//     pairs], one word a (nt, h) (pairs 2 g and 2 g + 1 are adjacent), and
//     one lane stores the tile by one TMA store; two tiles a warp, so the
//     wait for a tile's read falls a store later. Stores straight from the
//     registers (one word a thread and (nt, h), four whole 32-byte sectors a
//     warp's store) cost 4.0 ms a pass at T=4096, P=8192, the TMA store
//     0.9-1.4 (PERF.md §6). They remain where TMA cannot store: P % 8 != 0 (rows not
//     16-byte aligned) or a misaligned base; a word where it is 4-byte
//     aligned, element by element otherwise, dead pairs skipped.
// The column is normalised as c * (1 / s), as the backward does, not c / s
// as the plain version: the two differ by one f32 rounding (2^-24
// relative), far below the bf16 step the gate is set by, and two divisions
// a thread take the place of 64. The tensor cores add in another order than
// the plain version's and truncate, so alpha stays within bf16 level of it.
template <bool STORE_EVERY, bool NORM_BLOCK>
__global__ void __launch_bounds__((kWgWarps + 1) * 32)
    alpha_wall_forward_kernel(const __grid_constant__ CUtensorMap map,
                              const __grid_constant__ CUtensorMap amap, int G,
                              const float* __restrict__ em,   // [T][3][KC]
                              const float* __restrict__ obs,  // [T][2][P]
                              const float* __restrict__ isp,  // [KC]
                              const int* __restrict__ ops,    // [T]
                              __nv_bfloat16* __restrict__ alpha,  // [rows][KA][P]
                              int T, int P, int KA, int S, int ring,
                              bool obs_vec, bool tma_alpha) {
  extern __shared__ float4 smem4[];
  // the 1024-byte aligned base as an offset from smem4, so that the
  // compiler keeps the shared address space (LDS / STS, not generic loads)
  char* slots = reinterpret_cast<char*>(smem4) +
                ((1024 - (smem_u32(smem4) & 1023)) & 1023);
  char* tiles = slots + ring * kFwdSlotBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(tiles + kFwdTiles);
  uint64_t* empty = full + ring;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int p0 = blockIdx.x * kWgPairs;
  init_ring(full, empty, ring);
  __syncthreads();  // barriers initialised; the only block-wide barrier

  if (warp == kWgWarps) {
    // producer: site n into slot n % ring once every consumer has released
    // that slot's previous site; site 0 has no operator
    for (int n = 0; n < T; ++n) {
      const int s = n % ring;
      const int use = n / ring;
      if (use > 0) wait_phase(&empty[s], (use - 1) & 1);
      const int op = n > 0 ? ops[n] : -1;
      if (n > 0 && (op < 0 || op >= G)) __trap();  // a caller bug
      char* e = slots + s * kFwdSlotBytes;
      stage_operator_em(e, &full[s], &map, op, em, n, lane);
      // the block's observations [2][64 pairs]: 16-byte copies where
      // obs_vec (P % 4 == 0), element by element otherwise, pairs past P 0
      const float* o_n = obs + 2 * static_cast<size_t>(n) * P + p0;
      float* so = reinterpret_cast<float*>(e + kOpBytes + kEmBytes);
      if (obs_vec) {
        const int row = lane / 16, ch = lane % 16;
        if (p0 + 4 * ch < P)
          cp_async16(so + row * kWgPairs + 4 * ch,
                     o_n + row * static_cast<size_t>(P) + 4 * ch);
      } else {
        for (int i = lane; i < 2 * kWgPairs; i += 32) {
          const int row = i / kWgPairs, j = i % kWgPairs;
          so[i] = p0 + j < P ? __ldg(o_n + row * static_cast<size_t>(P) + j) : 0.f;
        }
      }
      arrive_after_copies(&full[s]);
    }
    return;
  }

  const int g = lane >> 2;
  const int q = lane & 3;
  const int ja = 16 * warp + 2 * g;       // pair a in the block: m-tile row g
  const int pa = p0 + ja;
  const int pb = pa + 1;                  // m-tile row g + 8
  const bool la = pa < P, lb = pb < P;
  const size_t Pz = static_cast<size_t>(P);
  char* tile = tiles + warp * 2 * kTileBytes;  // the warp's two store tiles

  // c_t and the product's accumulators: [nt][h] pair a, [nt][2 + h] pair b;
  // site 0 starts from isp. A: the next site's operand, bf16(c)
  float c[kNTiles][4];
  uint32_t A[kKSteps][4];
#pragma unroll
  for (int nt = 0; nt < kNTiles; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h) c[nt][h] = c[nt][2 + h] = isp[8 * nt + 2 * q + h];
  int tb = 0;      // t % S
  int stores = 0;  // TMA stores of this warp
  for (int t = 0; t < T; ++t) {
    const bool block_end = tb == S - 1;
    tb = block_end ? 0 : tb + 1;
    const int s = t % ring;
    wait_phase(&full[s], (t / ring) & 1);
    const char* e = slots + s * kFwdSlotBytes;
    const float* so = reinterpret_cast<const float*>(e + kOpBytes + kEmBytes);
    const Obs o{la ? so[ja] : 0.f, la ? so[kWgPairs + ja] : 0.f,
                lb ? so[ja + 1] : 0.f, lb ? so[kWgPairs + ja + 1] : 0.f};
    if (t > 0) {
      // c = bf16(c_{t-1}) @ M^T: k-steps 0-3 read the operator's first
      // 64-column half, 4-7 its second, 32 bytes a step
      const uint32_t op_addr = smem_u32(e);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk)
        wgmma_k16(c, A[kk],
                  sw128_desc(op_addr + (kk / 4) * kHalfBytes + 32 * (kk % 4)),
                  kk > 0);
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
      // the A fragments and accumulators were in the wgmma's hands until
      // here: keep the compiler from reusing or reading them earlier
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk)
        asm volatile("" : "+r"(A[kk][0]), "+r"(A[kk][1]), "+r"(A[kk][2]),
                     "+r"(A[kk][3]) :: "memory");
#pragma unroll
      for (int nt = 0; nt < kNTiles; ++nt)
        asm volatile("" : "+f"(c[nt][0]), "+f"(c[nt][1]), "+f"(c[nt][2]),
                     "+f"(c[nt][3]) :: "memory");
    }

    // c = c * em(t)
    const float* em_t = reinterpret_cast<const float*>(e + kOpBytes);
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
      const int k = 8 * nt + 2 * q;
      const float2 e0 = *reinterpret_cast<const float2*>(em_t + k);
      const float2 e1 = *reinterpret_cast<const float2*>(em_t + kStates + k);
      const float2 e2 = *reinterpret_cast<const float2*>(em_t + 2 * kStates + k);
      c[nt][0] = __fmul_rn(c[nt][0], emission_of(e0.x, e1.x, e2.x, o.oza, o.oha));
      c[nt][1] = __fmul_rn(c[nt][1], emission_of(e0.y, e1.y, e2.y, o.oza, o.oha));
      c[nt][2] = __fmul_rn(c[nt][2], emission_of(e0.x, e1.x, e2.x, o.ozb, o.ohb));
      c[nt][3] = __fmul_rn(c[nt][3], emission_of(e0.y, e1.y, e2.y, o.ozb, o.ohb));
    }
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
                 :: "r"(smem_u32(&empty[s])) : "memory");

    // c divided by its column sum, or with NORM_BLOCK only at each block's
    // last site
    if (!NORM_BLOCK || block_end) {
      float sa[kNTiles], sb[kNTiles];
#pragma unroll
      for (int nt = 0; nt < kNTiles; ++nt) {
        sa[nt] = __fadd_rn(c[nt][0], c[nt][1]);
        sb[nt] = __fadd_rn(c[nt][2], c[nt][3]);
      }
      const float ia = 1.f / quad_sum(tree_sum(sa));
      const float ib = 1.f / quad_sum(tree_sum(sb));
#pragma unroll
      for (int nt = 0; nt < kNTiles; ++nt) {
        c[nt][0] = __fmul_rn(c[nt][0], ia);
        c[nt][1] = __fmul_rn(c[nt][1], ia);
        c[nt][2] = __fmul_rn(c[nt][2], ib);
        c[nt][3] = __fmul_rn(c[nt][3], ib);
      }
    }

    // alpha's rows k < KA of pairs a and b (one word)
    if (STORE_EVERY || block_end) {
      const int row0 = (STORE_EVERY ? t : t / S) * KA;
      if (tma_alpha) {
        char* buf = tile + (stores & 1) * kTileBytes;
        // the store two before this one read this tile
        if (lane == 0) asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
        __syncwarp();
#pragma unroll
        for (int nt = 0; nt < kNTiles; ++nt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int k = 8 * nt + 2 * q + h;
            if (k < KA)
              *reinterpret_cast<uint32_t*>(buf + k * kTileRow + 4 * g) =
                  pack_bf16(c[nt][h], c[nt][2 + h]);
          }
        // the tile's writes visible to the TMA unit, then the warp's store
        // (the box clips pairs past P)
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        __syncwarp();
        if (lane == 0) tma_store(&amap, buf, p0 + 16 * warp, row0);
        ++stores;
      } else if (la) {
        __nv_bfloat16* a = alpha + static_cast<size_t>(row0) * Pz + pa;
#pragma unroll
        for (int nt = 0; nt < kNTiles; ++nt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int k = 8 * nt + 2 * q + h;
            if (k >= KA) continue;
            __nv_bfloat16* d = a + k * Pz;
            if (lb && (reinterpret_cast<uintptr_t>(d) & 3) == 0) {
              *reinterpret_cast<uint32_t*>(d) = pack_bf16(c[nt][h], c[nt][2 + h]);
            } else {
              d[0] = __float2bfloat16_rn(c[nt][h]);
              if (lb) d[1] = __float2bfloat16_rn(c[nt][2 + h]);
            }
          }
      }
    }

    // the next site's A: k-step kk holds n-tiles 2 kk and 2 kk + 1
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int nt = 2 * kk + u;
        A[kk][2 * u] = pack_bf16(c[nt][0], c[nt][1]);
        A[kk][2 * u + 1] = pack_bf16(c[nt][2], c[nt][3]);
      }
  }
  // the stores done before the block's shared memory goes
  if (lane == 0 && stores > 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// cuTensorMapEncodeTiled, reached through the runtime's entry-point query
// (the library links no libcuda); null where the installed CUDA lacks it.
using EncodeTiled = decltype(&cuTensorMapEncodeTiled);
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A 2-D map of a bf16 matrix of `rows` rows of `cols` values, read or
// written in boxes of box_cols x box_rows.
int bf16_map(CUtensorMap* map, const void* base, int64_t cols, int64_t rows,
             int box_cols, int box_rows, CUtensorMapSwizzle swizzle,
             CUtensorMapL2promotion promotion) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {sizeof(__nv_bfloat16) * static_cast<cuuint64_t>(cols)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult rc = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, promotion,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// The operators [G][KC][KC] bf16 as G KC rows, read in 64 x KC boxes (half
// a row of KC rows) with the 128B swizzle.
int operator_map(CUtensorMap* map, const __nv_bfloat16* M, int G) {
  return bf16_map(map, M, kStates, static_cast<int64_t>(G) * kStates,
                  kStates / 2, kStates, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B);
}

// Ring slots of `slot` bytes a block beside `extra` bytes of its own: as
// many (at most kMaxRing) as fit beside the other blocks an SM must hold
// for the whole grid to be resident, and never fewer than two, which fit
// alone.
constexpr size_t kRingFixed = 1024 + 2 * sizeof(uint64_t) * kMaxRing;
static_assert(2 * static_cast<size_t>(kBwdSlotBytes) + kRingFixed <= kMaxShared,
              "two ring slots must fit in a block's shared memory");
static_assert(2 * static_cast<size_t>(kFwdSlotBytes) + kFwdTiles + kRingFixed <=
                  kMaxShared,
              "two ring slots and the store tiles must fit in a block's shared memory");

int ring_slots(int blocks, int sms, int slot, size_t extra) {
  const size_t room = kMaxShared / ((blocks + sms - 1) / sms);
  const size_t fixed = kRingFixed + extra;
  const int fit = room > fixed ? static_cast<int>((room - fixed) / slot) : 0;
  return fit < 2 ? 2 : fit > kMaxRing ? kMaxRing : fit;
}

// A block's dynamic shared memory: the alignment slack, `ring` slots,
// `extra` bytes and the ring's barriers.
size_t ring_smem(int ring, int slot, size_t extra) {
  return 1024 + ring * static_cast<size_t>(slot) + extra +
         2 * ring * sizeof(uint64_t);
}

template <bool STORE_EVERY, bool NORM_BLOCK>
int launch_forward(const __nv_bfloat16* M, int G, const float* em,
                   const float* obs, const float* isp, const int* ops,
                   __nv_bfloat16* alpha, int T, int P, int KA, int S, int sms,
                   cudaStream_t stream) {
  CUtensorMap map, amap{};
  int rc = operator_map(&map, M, G);
  if (rc != 0) return rc;
  // TMA stores alpha where its rows are 16-byte aligned: [rows x KA][P],
  // in boxes of 16 pairs x KA rows (one consumer warp's tile)
  const bool tma_alpha = P % 8 == 0 && reinterpret_cast<uintptr_t>(alpha) % 16 == 0;
  if (tma_alpha) {
    rc = bf16_map(&amap, alpha, P, static_cast<int64_t>(STORE_EVERY ? T : T / S) * KA,
                  16, KA, CU_TENSOR_MAP_SWIZZLE_NONE,
                  CU_TENSOR_MAP_L2_PROMOTION_NONE);
    if (rc != 0) return rc;
  }
  const bool obs_vec = P % 4 == 0 && reinterpret_cast<uintptr_t>(obs) % 16 == 0;
  const int blocks = (P + kWgPairs - 1) / kWgPairs;
  const int ring = ring_slots(blocks, sms, kFwdSlotBytes, kFwdTiles);
  const size_t smem = ring_smem(ring, kFwdSlotBytes, kFwdTiles);
  auto* kernel = alpha_wall_forward_kernel<STORE_EVERY, NORM_BLOCK>;
  rc = allow_shared(kernel, smem);
  if (rc != 0) return rc;
  kernel<<<blocks, 32 * (kWgWarps + 1), smem, stream>>>(
      map, amap, G, em, obs, isp, ops, alpha, T, P, KA, S, ring, obs_vec,
      tma_alpha);
  return static_cast<int>(cudaGetLastError());
}

template <bool READ_EVERY, bool NORM_BLOCK>
int launch_backward(const __nv_bfloat16* M, int G, const float* em,
                    const float* obs, const __nv_bfloat16* alpha,
                    const int* ops, float* out, float* carry, int carry_site,
                    int T, int P, int KA, int S, int sms, cudaStream_t stream) {
  CUtensorMap map;
  int rc = operator_map(&map, M, G);
  if (rc != 0) return rc;
  const int blocks = (P + kWgPairs - 1) / kWgPairs;
  const int ring = ring_slots(blocks, sms, kBwdSlotBytes, 0);
  const size_t smem = ring_smem(ring, kBwdSlotBytes, 0);
  const bool vec = P % 8 == 0 && reinterpret_cast<uintptr_t>(alpha) % 16 == 0;
  auto* kernel = alpha_wall_backward_kernel<READ_EVERY, NORM_BLOCK>;
  rc = allow_shared(kernel, smem);
  if (rc != 0) return rc;
  kernel<<<blocks, 32 * (kWgWarps + 1), smem, stream>>>(
      map, G, em, obs, alpha, ops, out, carry, carry_site, T, P, KA, S, ring,
      vec);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int T, int P, int G, int KC, int KA, int S) {
  return T <= 0 || P <= 0 || G <= 0 || KC != kStates || KA <= 0 ||
         KA > kStates || S <= 0 || T % S != 0;
}

}  // namespace
}  // namespace fastsmc

// Launch the probe's forward kernel on `stream` (device `device`); returns
// the cudaError_t of the launch. M is [G][KC][KC] bf16, alpha [T][KA][P]
// bf16 (store_every) or [T/S][KA][P]. KC must be 128, 1 <= KA <= KC, and S
// must divide T.
extern "C" int fastsmc_alpha_wall_forward(const void* M, int G,
                                          const float* em, const float* obs,
                                          const float* isp, const int* ops,
                                          void* alpha, int T, int P, int KC,
                                          int KA, int S, int store_every,
                                          int norm_block, int device,
                                          void* stream) {
  using namespace fastsmc;
  if (bad_shape(T, P, G, KC, KA, S)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  int sms = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const auto* m = static_cast<const __nv_bfloat16*>(M);
  auto* a = static_cast<__nv_bfloat16*>(alpha);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (store_every)
    return norm_block
               ? launch_forward<true, true>(m, G, em, obs, isp, ops, a, T, P, KA, S, sms, s)
               : launch_forward<true, false>(m, G, em, obs, isp, ops, a, T, P, KA, S, sms, s);
  return norm_block
             ? launch_forward<false, true>(m, G, em, obs, isp, ops, a, T, P, KA, S, sms, s)
             : launch_forward<false, false>(m, G, em, obs, isp, ops, a, T, P, KA, S, sms, s);
}

// Launch the probe's backward kernel on `stream` (device `device`); returns
// the cudaError_t of the launch. alpha is [T][KA][P] bf16 (read_every) or
// [T/S][KA][P]; out is [T][P] f32; carry, unless null, receives the raw
// carry [KC][P] f32 after site carry_site (0 <= carry_site < T). Shapes as
// for the forward kernel.
extern "C" int fastsmc_alpha_wall_backward(const void* M, int G,
                                           const float* em, const float* obs,
                                           const void* alpha, const int* ops,
                                           float* out, float* carry,
                                           int carry_site, int T, int P, int KC,
                                           int KA, int S, int read_every,
                                           int norm_block, int device,
                                           void* stream) {
  using namespace fastsmc;
  if (bad_shape(T, P, G, KC, KA, S) ||
      (carry && (carry_site < 0 || carry_site >= T)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  int sms = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const auto* m = static_cast<const __nv_bfloat16*>(M);
  const auto* a = static_cast<const __nv_bfloat16*>(alpha);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (read_every)
    return norm_block
               ? launch_backward<true, true>(m, G, em, obs, a, ops, out, carry, carry_site, T, P, KA, S, sms, s)
               : launch_backward<true, false>(m, G, em, obs, a, ops, out, carry, carry_site, T, P, KA, S, sms, s);
  return norm_block
             ? launch_backward<false, true>(m, G, em, obs, a, ops, out, carry, carry_site, T, P, KA, S, sms, s)
             : launch_backward<false, false>(m, G, em, obs, a, ops, out, carry, carry_site, T, P, KA, S, sms, s);
}
