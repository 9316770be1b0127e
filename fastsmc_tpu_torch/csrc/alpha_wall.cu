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
// and products bf16(M) @ bf16(v) accumulated in f32 (fmaf, j ascending).
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
// block), so by FLOP/byte both passes sit above the memory line even with
// alpha every site; with bf16 operands on the tensor cores (989 TFLOP/s)
// the every-site variants would be memory-bound (~1.5 ms a pass against
// ~1.1 ms of products at T=4096, P=8192). This kernel does its products with
// scalar fmaf (67 TFLOP/s f32 at most, 16.4 ms a pass), as hmm_forward.cu
// does: one block per 32 pairs walks all T sites with the carry in
// registers, the site's operator staged once in shared memory as f32 (64
// KB) and read by each warp as float4 broadcasts (four columns a load), the
// product's operand in shared memory as f32 values of bf16. The alpha
// traffic is coalesced 64-byte warp stores or loads per state row; with the
// products this slow it should hide behind them. Later work: the products
// on the tensor cores (wgmma on the bf16 operands), after which the alpha
// traffic is what is left.
#include "hmm_common.cuh"

namespace fastsmc {
namespace {

constexpr int kStates = 128;                   // KC
constexpr int kRows = kStates / kWarps;        // rows a warp owns (RPW)
constexpr int kPostRows = 10;                  // rows summed into out

// acc[i] = sum_j sM[k_i][j] * sV[j][lane], j ascending, for this thread's
// rows k_i = warp + kWarps * i: the operator row is read as float4
// broadcasts, four columns at a time.
__device__ __forceinline__ void product(float (&acc)[kRows],
                                        const float* __restrict__ sM,
                                        const float* __restrict__ sV, int lane,
                                        int warp) {
#pragma unroll
  for (int i = 0; i < kRows; ++i) acc[i] = 0.f;
#pragma unroll 2
  for (int j = 0; j < kStates; j += 4) {
    const float v0 = sV[(j + 0) * kPairs + lane];
    const float v1 = sV[(j + 1) * kPairs + lane];
    const float v2 = sV[(j + 2) * kPairs + lane];
    const float v3 = sV[(j + 3) * kPairs + lane];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const float4 m = *reinterpret_cast<const float4*>(
          sM + (warp + kWarps * i) * kStates + j);
      acc[i] = fmaf(m.x, v0, acc[i]);
      acc[i] = fmaf(m.y, v1, acc[i]);
      acc[i] = fmaf(m.z, v2, acc[i]);
      acc[i] = fmaf(m.w, v3, acc[i]);
    }
  }
}

// Shared memory: the staged operator [KC][KC], the product's operand
// [KC][kPairs] and three [kWarps][kPairs] reduction buffers.
constexpr size_t kShared =
    sizeof(float) * (kStates * kStates + kStates * kPairs + 3 * kWarps * kPairs);

template <bool STORE_EVERY, bool NORM_BLOCK>
__global__ void __launch_bounds__(kThreads)
    alpha_wall_forward_kernel(const __nv_bfloat16* __restrict__ M, int G,
                              const float* __restrict__ em,   // [T][3][KC]
                              const float* __restrict__ obs,  // [T][2][P]
                              const float* __restrict__ isp,  // [KC]
                              const int* __restrict__ ops,    // [T]
                              __nv_bfloat16* __restrict__ alpha,  // [rows][KA][P]
                              int T, int P, int KA, int S) {
  extern __shared__ float4 smem4[];
  float* sM = reinterpret_cast<float*>(smem4);
  float* sC = sM + kStates * kStates;
  float* sRed = sC + kStates * kPairs;
  const int lane = threadIdx.x % kPairs;
  const int warp = threadIdx.x / kPairs;
  const int p = blockIdx.x * kPairs + lane;
  const bool live = p < P;
  const size_t Pz = static_cast<size_t>(P);
  const float* Mf = reinterpret_cast<const float*>(M);

  float c[kRows];
  for (int t = 0; t < T; ++t) {
    const float* em_t = em + static_cast<size_t>(t) * 3 * kStates;
    const float oz = live ? obs[(2 * static_cast<size_t>(t)) * Pz + p] : 0.f;
    const float oh = live ? obs[(2 * static_cast<size_t>(t) + 1) * Pz + p] : 0.f;
    if (t == 0) {
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int k = warp + kWarps * i;
        c[i] = isp[k] * emission(em_t, k, kStates, oz, oh);
      }
    } else {
      stage_operator_bf16(sM, Mf, true, ops[t], G, kStates);
      __syncthreads();  // operator and operand visible
      float acc[kRows];
      product(acc, sM, sC, lane, warp);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        c[i] = acc[i] * emission(em_t, warp + kWarps * i, kStates, oz, oh);
    }
    if (!NORM_BLOCK || t % S == S - 1) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < kRows; ++i) part += c[i];
      const float s = column_sum(sRed, part, lane, warp);
#pragma unroll
      for (int i = 0; i < kRows; ++i) c[i] = c[i] / s;
    } else {
      __syncthreads();  // every warp's reads of sM and sC done
    }
    if (STORE_EVERY || t % S == S - 1) {
      __nv_bfloat16* a =
          alpha + static_cast<size_t>(STORE_EVERY ? t : t / S) * KA * Pz;
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int k = warp + kWarps * i;
        if (live && k < KA) a[k * Pz + p] = __float2bfloat16_rn(c[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i)
      sC[(warp + kWarps * i) * kPairs + lane] = round_bf16(c[i]);
  }
}

template <bool READ_EVERY, bool NORM_BLOCK>
__global__ void __launch_bounds__(kThreads)
    alpha_wall_backward_kernel(const __nv_bfloat16* __restrict__ M, int G,
                               const float* __restrict__ em,   // [T][3][KC]
                               const float* __restrict__ obs,  // [T][2][P]
                               const __nv_bfloat16* __restrict__ alpha,
                               const int* __restrict__ ops,    // [T]
                               float* __restrict__ out,        // [T][P]
                               float* __restrict__ carry_out,  // [KC][P] or null
                               int carry_site, int T, int P, int KA, int S) {
  extern __shared__ float4 smem4[];
  float* sM = reinterpret_cast<float*>(smem4);
  float* sC = sM + kStates * kStates;
  float* sRed = sC + kStates * kPairs;    // column sums of c
  float* sTop = sRed + kWarps * kPairs;   // sum of post over k < 10
  float* sAll = sTop + kWarps * kPairs;   // sum of post over k < KA
  const int lane = threadIdx.x % kPairs;
  const int warp = threadIdx.x / kPairs;
  const int p = blockIdx.x * kPairs + lane;
  const bool live = p < P;
  const size_t Pz = static_cast<size_t>(P);
  const float* Mf = reinterpret_cast<const float*>(M);

  float carry[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) carry[i] = 1.f / kStates;
  for (int r = T - 1; r >= 0; --r) {
    const float* em_r = em + static_cast<size_t>(r) * 3 * kStates;
    const float oz = live ? obs[(2 * static_cast<size_t>(r)) * Pz + p] : 0.f;
    const float oh = live ? obs[(2 * static_cast<size_t>(r) + 1) * Pz + p] : 0.f;
    stage_operator_bf16(sM, Mf, true, ops[r], G, kStates);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int k = warp + kWarps * i;
      sC[k * kPairs + lane] =
          round_bf16(carry[i] * emission(em_r, k, kStates, oz, oh));
    }
    __syncthreads();  // operator and operand visible
    float c[kRows];
    product(c, sM, sC, lane, warp);
    if (!NORM_BLOCK || r % S == 0) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < kRows; ++i) part += c[i];
      const float s = column_sum(sRed, part, lane, warp);
#pragma unroll
      for (int i = 0; i < kRows; ++i) carry[i] = c[i] / s;
    } else {
      __syncthreads();  // every warp's reads of sM and sC done
#pragma unroll
      for (int i = 0; i < kRows; ++i) carry[i] = c[i];
    }
    if (carry_out && r == carry_site && live) {
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        carry_out[(warp + kWarps * i) * Pz + p] = carry[i];
    }
    const __nv_bfloat16* a =
        alpha + static_cast<size_t>(READ_EVERY ? r : r / S) * KA * Pz;
    float top = 0.f, all = 0.f;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int k = warp + kWarps * i;
      if (k < KA) {
        const float av = live ? __bfloat162float(a[k * Pz + p]) : 0.f;
        const float post = av * (NORM_BLOCK ? c[i] : carry[i]);
        all += post;
        if (k < kPostRows) top += post;
      }
    }
    sTop[warp * kPairs + lane] = top;
    sAll[warp * kPairs + lane] = all;
    __syncthreads();
    if (warp == 0 && live) {
      float st = 0.f, sa = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        st += sTop[w * kPairs + lane];
        sa += sAll[w * kPairs + lane];
      }
      out[static_cast<size_t>(r) * Pz + p] = st / sa;
    }
  }
}

template <bool STORE_EVERY, bool NORM_BLOCK>
int launch_forward(const __nv_bfloat16* M, int G, const float* em,
                   const float* obs, const float* isp, const int* ops,
                   __nv_bfloat16* alpha, int T, int P, int KA, int S,
                   cudaStream_t stream) {
  auto* kernel = alpha_wall_forward_kernel<STORE_EVERY, NORM_BLOCK>;
  const int rc = allow_shared(kernel, kShared);
  if (rc != 0) return rc;
  kernel<<<(P + kPairs - 1) / kPairs, kThreads, kShared, stream>>>(
      M, G, em, obs, isp, ops, alpha, T, P, KA, S);
  return static_cast<int>(cudaGetLastError());
}

template <bool READ_EVERY, bool NORM_BLOCK>
int launch_backward(const __nv_bfloat16* M, int G, const float* em,
                    const float* obs, const __nv_bfloat16* alpha,
                    const int* ops, float* out, float* carry, int carry_site,
                    int T, int P, int KA, int S, cudaStream_t stream) {
  auto* kernel = alpha_wall_backward_kernel<READ_EVERY, NORM_BLOCK>;
  const int rc = allow_shared(kernel, kShared);
  if (rc != 0) return rc;
  kernel<<<(P + kPairs - 1) / kPairs, kThreads, kShared, stream>>>(
      M, G, em, obs, alpha, ops, out, carry, carry_site, T, P, KA, S);
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
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const auto* m = static_cast<const __nv_bfloat16*>(M);
  auto* a = static_cast<__nv_bfloat16*>(alpha);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (store_every)
    return norm_block
               ? launch_forward<true, true>(m, G, em, obs, isp, ops, a, T, P, KA, S, s)
               : launch_forward<true, false>(m, G, em, obs, isp, ops, a, T, P, KA, S, s);
  return norm_block
             ? launch_forward<false, true>(m, G, em, obs, isp, ops, a, T, P, KA, S, s)
             : launch_forward<false, false>(m, G, em, obs, isp, ops, a, T, P, KA, S, s);
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
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const auto* m = static_cast<const __nv_bfloat16*>(M);
  const auto* a = static_cast<const __nv_bfloat16*>(alpha);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (read_every)
    return norm_block
               ? launch_backward<true, true>(m, G, em, obs, a, ops, out, carry, carry_site, T, P, KA, S, s)
               : launch_backward<true, false>(m, G, em, obs, a, ops, out, carry, carry_site, T, P, KA, S, s);
  return norm_block
             ? launch_backward<false, true>(m, G, em, obs, a, ops, out, carry, carry_site, T, P, KA, S, s)
             : launch_backward<false, false>(m, G, em, obs, a, ops, out, carry, carry_site, T, P, KA, S, s);
}
