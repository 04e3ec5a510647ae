// The half-blocks' products on Hopper's own path: wgmma fed by a TMA ring,
// epilogues read from the accumulator registers, deterministic split-K
// weight gradients.
//
// Replaces the WMMA products of csrc/gemm.cu and csrc/gemm_bwd.cu (which K6,
// K10 and X2f's yardstick still launch) for both dense half-blocks:
//   * K1f, ddm_tpu/ops/mlp_block.py `_fwd_kernel`:
//       g = bf16(gelu(LN(x) W1^T + b1))   ddm_wg_ln_gemm (was ln_gemm_kernel
//                                          / ln_gemm_stream_kernel)
//       out = bf16(x + (g W2^T + b2))     ddm_wg_gemm_residual (was
//                                          gemm_residual_kernel)
//   * K1b, `_bwd_kernel` / `_bwd_body`: the recompute (ddm_wg_ln_gemm with
//     the gelu' epilogue, writing g, gelu'(h) in fp32 and y = bf16(LN(x))),
//     dW2 and db2 (ddm_wg_gemm_tn), dh = bf16((dO W2) gelu') with db1
//     (ddm_wg_gemm_nn), dW1 (ddm_wg_gemm_tn) and dy = dH W1 in fp32
//     (ddm_wg_gemm_nn); ln_bwd (gemm_bwd.cu) is unchanged. Were gemm_tn_kernel
//     and gemm_nn_kernel.
//   * K2f, ddm_tpu/ops/attention.py `_blk_fwd_kernel`, around its attention
//     core (csrc/attention.cu): qkv = bf16(LN(x) Wqkv^T + bqkv)
//     (ddm_wg_ln_gemm, the plain-bias epilogue) and out = bf16(x + (att
//     Wproj^T + bproj)) (ddm_wg_gemm_residual).
//   * K2b, `_blk_bwd_kernel`, and K4, `_blk_bwd_split_kernel` (one chain in
//     the port): the qkv recompute with y, datt = bf16(dO Wproj)
//     (ddm_wg_gemm_nn, the bf16 store), dWproj with dbproj and dWqkv with
//     dbqkv (ddm_wg_gemm_tn), dy = dqkv Wqkv in fp32 (ddm_wg_gemm_nn); the
//     core backward and ln_bwd are unchanged. The third attention rung runs
//     the same two chains around K7 or K8 at D <= 1344.
//
// What bounds it on the H100: at DiT-S/4's training shape (T 131,072, D 384,
// F 1536) K1f's two products are 309 GFLOP (0.31 ms at 989 TFLOP/s) and
// K1b's five 773 GFLOP (0.78 ms); both chains also move the (T, F) hidden
// activations through device memory (K1b about 1.3 GB, 0.4 ms at 3.35
// TB/s). K2b's five products there are 464 GFLOP (0.47 ms). The WMMA kernels
// ran 11-14x those bounds: mma.sync, which cannot reach the wgmma rate, on
// tiles copied by all threads between two block barriers, with no copy in
// flight during a product, and every accumulator through a 33 KB fp32
// shared tile before its epilogue.
//
// The design:
//   * a block is 3 warpgroups: warpgroup 2 is the producer (one thread
//     issues every TMA load; setmaxnreg gives its registers to the others),
//     warpgroups 0 and 1 each own 64 rows of a 128-row output tile and run
//     wgmma.m64n{128,192,256}k16 on the stages that have arrived;
//   * a ring of kStages stages, each an A tile (128 x 64) and a B tile (BN x
//     64) in the 128-byte swizzle, with a full and an empty mbarrier each;
//     one wgmma group stays in flight while the next stage is prepared;
//   * K-major operands (the forward's x, g and nn.Linear weights) are one
//     box a tile; MN-major ones (the weights read as (K, N) by the NN
//     products, both operands of the TN products) are 64-column boxes read
//     through the transpose bit;
//   * the LayerNorm prologue: a block first takes each row's mean and rstd
//     in ln_gemm_kernel's order (one warp a row, lane-strided sums, two-pass
//     variance, eps 1e-6); on its first column tile it normalises each
//     arriving x chunk in place, in fp32, rounded to bf16 as ln_gemm rounds
//     y, fences it (fence.proxy.async) before the wgmma that reads it, and
//     stores it to y; its later column tiles load those rows back from y by
//     TMA (a y-ready mbarrier orders the two), so a row block is normalised
//     once, not once a column tile. Any D % 64 == 0;
//   * epilogues read the accumulators in registers and write the output
//     directly (bias, exact-erf or sigmoid GELU, gelu', residual, dh with
//     its db1 column partials, bf16, fp32), each variant compiled apart, four
//     8-column blocks' loads issued before their arithmetic;
//   * the TN products split T into fixed row ranges (a whole number of
//     64-row tiles each, gemm.py `wg_split_plan`, a function of the shapes
//     and the SM count), write fp32 partials, and reduce_rows sums them in
//     a fixed order: no atomics, a second call is bit-identical.
//
// Ragged T and ragged columns (the attention products' N = D at D 64, 320,
// 448, ... on 128-wide tiles): TMA fills rows and columns past the tensor
// with zeros, and stores are masked. The MLP's (T, F) hidden activation
// still goes through device memory: keeping it on chip (the TPU kernel's
// design) is the next step.
#include <cuda.h>

#include <chrono>

#include "common.cuh"
#include "wgmma.cuh"

namespace ddm {
namespace {

constexpr int kBM = 128;                 // output rows a tile (two warpgroups of 64)
constexpr int kBK = 64;                  // depth a stage (128-byte rows)
constexpr int kStages = 4;
constexpr int kConsumers = 256;          // warpgroups 0 and 1
constexpr int kThreadsWG = kConsumers + 128;
constexpr int kTileA = kBM * kBK * 2;    // 16 KB
constexpr int kBox = 64 * kBK * 2;       // one 64 x 64 MN-major box, 8 KB
constexpr int kSwizzleRow = 128;         // bytes
constexpr int kSwizzleAtom = 1024;       // 8 rows of 128 bytes
constexpr size_t kMaxSmem = 232448;      // a block's shared memory on the H100
constexpr float kLnEpsWg = 1e-6f;
constexpr float kInvSqrt2Wg = 0.70710678118654752440f;
constexpr float kInvSqrt2PiWg = 0.39894228040143267794f;

enum WgKind : int {
  kLnGemm = 0,    // epi(LN(x) W^T + b): A = x normalised in place, W K-major
  kResidual = 1,  // bf16(res + (a W^T + b)): both K-major
  kNN = 2,        // a . W with W (K, N) MN-major: fp32, or dh with db1
  kTN = 3,        // a^T . b, both MN-major, split over the rows
};
enum : int { kEpiBiasWg = 0, kEpiGeluWg = 1, kEpiGeluGradWg = 2 };  // kLnGemm (gemm.py EPI_*)
enum : int { kNNF32Wg = 0, kNNBf16Wg = 1, kNNDGeluWg = 2 };        // kNN (gemm.py NN_*)

struct WgParams {
  const bf16* x;            // kLnGemm: the raw rows (statistics)
  const float* ln_scale;    // kLnGemm
  const float* ln_bias;     // kLnGemm
  const float* bias;        // kLnGemm, kResidual
  const bf16* res;          // kResidual
  const float* dfac;        // kNN dh: gelu'(h)
  void* out;                // bf16, or fp32 (kNN F32)
  float* out2;              // kLnGemm gelu' (fp32)
  bf16* y_out;              // kLnGemm y = bf16(LN(x))
  float* ws;                // kNN dh: (mblocks, N) db1 partials; kTN: (splits, M, N)
  float* cws;               // kTN: (splits, M) column sums of a, or null
  int M, N, K;              // output rows, output columns, depth
  int tpb;                  // column tiles a block walks
  int rows;                 // kTN: rows of T a split
};

// Each kind's epilogue variants, compiled apart (a run-time switch inside
// the unrolled epilogue multiplied the kernel's code and made the epilogue
// the slowest part of the LN product): kLnGemm bit 0 gelu' (EPI_GELU_GRAD),
// bit 1 the sigmoid GELU, 4 the bias alone (EPI_BIAS: the qkv product); kNN
// 1 dh, 2 the bf16 store (NN_BF16: datt).
constexpr int kEpiGrad = 1, kEpiFast = 2, kEpiBias = 4, kEpiDh = 1, kEpiBf16 = 2;

// Bytes of one ring stage, and of the block's dynamic shared memory: the
// ring (1024-aligned), 128 bytes of barriers (a full and an empty one a
// stage, and kLnGemm's y-ready one), and each kind's own tables (LN: mean
// and rstd a row, the LN scale and bias; NN: 8 warps' db1 partials; TN:
// two halves' column sums).
__host__ __device__ constexpr int stage_bytes(int bn) { return kTileA + bn * kBK * 2; }
constexpr int kBarrierBytes = 128;

size_t wg_smem(int kind, int bn, int K) {
  size_t s = kSwizzleAtom + (size_t)kStages * stage_bytes(bn) + kBarrierBytes;
  if (kind == kLnGemm) s += (2 * kBM + 2 * (size_t)K) * sizeof(float);
  if (kind == kNN) s += 8 * (size_t)bn * sizeof(float);
  if (kind == kTN) s += 2 * kBM * sizeof(float);
  return s;
}

__device__ __forceinline__ float gelu_exact(float h) {
  return 0.5f * h * (1.0f + erff(h * kInvSqrt2Wg));
}

// The LayerNorm prologue's statistics of this block's rows, in
// ln_gemm_kernel's order: warp w takes rows w, w + 8, ..., w + 120, all 16
// at once (their loads in flight together); each lane sums columns lane,
// lane + 32, ... in order, then warp_sum; two-pass variance.
__device__ __forceinline__ void ln_row_stats(const WgParams& p, int m0, float* mean,
                                             float* rstd) {
  constexpr int kRows = kBM / (kConsumers / 32);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, K = p.K;
  const bf16* __restrict__ x = p.x;
  float s[kRows], mu[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) s[i] = 0.f;
  for (int c0 = 0; c0 < K; c0 += 64) {
    float v[kRows][2];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = m0 + warp + 8 * i;
      const bf16* xr = x + (size_t)row * K + c0 + lane;
      v[i][0] = row < p.M ? __bfloat162float(xr[0]) : 0.f;
      v[i][1] = row < p.M ? __bfloat162float(xr[32]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) s[i] = (s[i] + v[i][0]) + v[i][1];
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    mu[i] = warp_sum(s[i]) / K;
    s[i] = 0.f;
  }
  for (int c0 = 0; c0 < K; c0 += 64) {
    float v[kRows][2];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = m0 + warp + 8 * i;
      const bf16* xr = x + (size_t)row * K + c0 + lane;
      v[i][0] = row < p.M ? __bfloat162float(xr[0]) - mu[i] : 0.f;
      v[i][1] = row < p.M ? __bfloat162float(xr[32]) - mu[i] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      s[i] += v[i][0] * v[i][0];
      s[i] += v[i][1] * v[i][1];
    }
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const float inv = rsqrtf(warp_sum(s[i]) / K + kLnEpsWg);
    if (lane == 0) {
      const bool ok = m0 + warp + 8 * i < p.M;  // rows past T are never stored
      mean[warp + 8 * i] = ok ? mu[i] : 0.f;
      rstd[warp + 8 * i] = ok ? inv : 0.f;
    }
  }
}

// Normalise, in place, warpgroup wg's 64 rows of the swizzled x chunk at
// depth k0 (y = bf16(xhat * scale + bias), ln_gemm's rounding) and store
// them to y. Ends with the fence and the warpgroup barrier that make the
// chunk an operand.
__device__ __forceinline__ void ln_normalise(unsigned char* tile, const WgParams& p, int m0,
                                             int k0, int wg, const float* mean,
                                             const float* rstd, const float* sc,
                                             const float* bi) {
  const int t = threadIdx.x % 128;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = t + 128 * i;
    const int r = wg * 64 + q / 8, pos = q % 8;
    const int col = k0 + 8 * (pos ^ (r % 8));
    uint4* chunk = reinterpret_cast<uint4*>(tile + r * kSwizzleRow + pos * 16);
    const uint4 raw = *chunk;
    const bf16* xv = reinterpret_cast<const bf16*>(&raw);
    const float4 s0 = *reinterpret_cast<const float4*>(sc + col);
    const float4 s1 = *reinterpret_cast<const float4*>(sc + col + 4);
    const float4 b0 = *reinterpret_cast<const float4*>(bi + col);
    const float4 b1 = *reinterpret_cast<const float4*>(bi + col + 4);
    const float scale[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
    const float shift[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
    uint4 v;
    bf16* yv = reinterpret_cast<bf16*>(&v);
    const float mu = mean[r], inv = rstd[r];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float xhat = (__bfloat162float(xv[e]) - mu) * inv;
      yv[e] = __float2bfloat16(xhat * scale[e] + shift[e]);
    }
    *chunk = v;
    if (m0 + r < p.M) *reinterpret_cast<uint4*>(p.y_out + (size_t)(m0 + r) * p.K + col) = v;
  }
  fence_proxy_async();
  named_bar_sync(2 + wg, 128);
}

// TN: this thread's share of the column sums of the A stage (MN-major: k
// rows of 128 bytes in two 64-column boxes): column t % 128, rows 32 (t /
// 128) .. + 32, in order.
__device__ __forceinline__ float tile_colsum(const unsigned char* tile, float s) {
  const int m = threadIdx.x % 128, half = threadIdx.x / 128;
  const unsigned char* box = tile + (m / 64) * kBox;
  const int mm = m % 64;
#pragma unroll 8
  for (int k = 32 * half; k < 32 * half + 32; ++k)
    s += __bfloat162float(*reinterpret_cast<const bf16*>(
        box + k * kSwizzleRow + ((mm / 8) ^ (k % 8)) * 16 + (mm % 8) * 2));
  return s;
}

// The epilogue of one finished tile, from the accumulators in registers.
// Four 8-column blocks at a time: their loads (bias, dfac, the residual)
// first, then the arithmetic and the stores.
template <int BN, int KIND, int EPI>
__device__ __forceinline__ void epilogue(const float (&acc)[BN / 2], const WgParams& p, int m0,
                                         int n0, float* colpart) {
  constexpr int kGroup = 4;
  const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int row0 = m0 + wg * 64 + warp * 16 + lane / 4;
  const bool row_ok[2] = {row0 < p.M, row0 + 8 < p.M};
  const int c0 = n0 + 2 * (lane % 4);
  const float* __restrict__ bias = p.bias;
  const float* __restrict__ dfac = p.dfac;
  const bf16* __restrict__ res = p.res;
  bf16* __restrict__ out_h = static_cast<bf16*>(p.out);
  float* __restrict__ out_f = static_cast<float*>(p.out);
  float* __restrict__ out2 = p.out2;
#pragma unroll
  for (int j0 = 0; j0 < BN / 8; j0 += kGroup) {
    float2 b[kGroup], f[kGroup][2];
    __nv_bfloat162 xr[kGroup][2];
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      const int col = c0 + 8 * (j0 + g);
      const bool col_ok = col < p.N;
      if constexpr (KIND == kLnGemm || KIND == kResidual)
        b[g] = col_ok ? *reinterpret_cast<const float2*>(bias + col) : make_float2(0.f, 0.f);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const bool ok = col_ok && row_ok[h];
        const size_t o = (size_t)(row0 + 8 * h) * p.N + col;
        if constexpr (KIND == kNN && EPI == kEpiDh)
          f[g][h] = ok ? *reinterpret_cast<const float2*>(dfac + o) : make_float2(0.f, 0.f);
        if constexpr (KIND == kResidual)
          xr[g][h] = ok ? *reinterpret_cast<const __nv_bfloat162*>(res + o)
                        : __floats2bfloat162_rn(0.f, 0.f);
      }
    }
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      const int j = j0 + g, col = c0 + 8 * j;
      const bool col_ok = col < p.N;
      float cs0 = 0.f, cs1 = 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const bool ok = col_ok && row_ok[h];
        const size_t o = (size_t)(row0 + 8 * h) * p.N + col;
        float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
        if constexpr (KIND == kLnGemm) {
          if (!ok) continue;
          v0 += b[g].x;
          v1 += b[g].y;
          if constexpr (EPI == kEpiBias) {
            // qkv: the biased product, rounded once
          } else if constexpr ((EPI & kEpiFast) != 0) {
            // one sigmoid shared by the fast GELU and its derivative
            const float s0 = fast_gelu_sigmoid(v0), s1 = fast_gelu_sigmoid(v1);
            if constexpr ((EPI & kEpiGrad) != 0)
              *reinterpret_cast<float2*>(out2 + o) =
                  make_float2(s0 * (1.0f + kFastGeluC * v0 * (1.0f - s0)),
                              s1 * (1.0f + kFastGeluC * v1 * (1.0f - s1)));
            v0 *= s0;
            v1 *= s1;
          } else if constexpr ((EPI & kEpiGrad) != 0) {
            // one erf shared by the GELU and its derivative (_act_fwd_bwd)
            const float e0 = erff(v0 * kInvSqrt2Wg), e1 = erff(v1 * kInvSqrt2Wg);
            *reinterpret_cast<float2*>(out2 + o) = make_float2(
                0.5f * (1.0f + e0) + v0 * kInvSqrt2PiWg * expf(-0.5f * v0 * v0),
                0.5f * (1.0f + e1) + v1 * kInvSqrt2PiWg * expf(-0.5f * v1 * v1));
            v0 = 0.5f * v0 * (1.0f + e0);
            v1 = 0.5f * v1 * (1.0f + e1);
          } else {
            v0 = gelu_exact(v0);
            v1 = gelu_exact(v1);
          }
          *reinterpret_cast<__nv_bfloat162*>(out_h + o) = __floats2bfloat162_rn(v0, v1);
        } else if constexpr (KIND == kResidual) {
          if (ok)
            *reinterpret_cast<__nv_bfloat162*>(out_h + o) =
                __floats2bfloat162_rn(__low2float(xr[g][h]) + (v0 + b[g].x),
                                      __high2float(xr[g][h]) + (v1 + b[g].y));
        } else if constexpr (KIND == kNN && EPI == kEpiDh) {
          if (ok) {
            v0 *= f[g][h].x;
            v1 *= f[g][h].y;
            *reinterpret_cast<__nv_bfloat162*>(out_h + o) = __floats2bfloat162_rn(v0, v1);
            cs0 += v0;
            cs1 += v1;
          }
        } else if constexpr (KIND == kNN && EPI == kEpiBf16) {
          if (ok) *reinterpret_cast<__nv_bfloat162*>(out_h + o) = __floats2bfloat162_rn(v0, v1);
        } else if constexpr (KIND == kNN) {
          if (ok) *reinterpret_cast<float2*>(out_f + o) = make_float2(v0, v1);
        } else {  // kTN: the split's fp32 partial
          if (ok)
            *reinterpret_cast<float2*>(p.ws + (size_t)blockIdx.z * p.M * p.N + o) =
                make_float2(v0, v1);
        }
      }
      if constexpr (KIND == kNN && EPI == kEpiDh) {
        // the warp's 16 rows: sum over the 8 row groups (lanes l, l ^ 4, ...)
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          cs0 += __shfl_xor_sync(0xffffffffu, cs0, o);
          cs1 += __shfl_xor_sync(0xffffffffu, cs1, o);
        }
        if (lane < 4) {
          float* dst = colpart + (wg * 4 + warp) * BN + 8 * j + 2 * lane;
          dst[0] = cs0;
          dst[1] = cs1;
        }
      }
    }
  }
  if constexpr (KIND == kNN && EPI == kEpiDh) {
    // db1: the block's column partials of the unrounded dh, warps in order
    named_bar_sync(1, kConsumers);
    for (int c = threadIdx.x; c < BN; c += kConsumers) {
      float s = colpart[c];
#pragma unroll
      for (int w = 1; w < 8; ++w) s += colpart[w * BN + c];
      if (n0 + c < p.N) p.ws[(size_t)blockIdx.x * p.N + n0 + c] = s;
    }
    named_bar_sync(1, kConsumers);
  }
}

// One block: row tile blockIdx.x, column tiles blockIdx.y * tpb .. + tpb,
// (kTN) the row range of split blockIdx.z. kLnGemm: the first column tile
// normalises the x chunks in place and stores y; the later ones load y
// (tma_y) once the block's y is written.
template <int BN, int KIND, int EPI>
__global__ void __launch_bounds__(kThreadsWG, 1)
wg_gemm_kernel(const __grid_constant__ CUtensorMap tma_a,
               const __grid_constant__ CUtensorMap tma_b,
               const __grid_constant__ CUtensorMap tma_y, const WgParams p) {
  constexpr bool kAMN = KIND == kTN;
  constexpr bool kBMN = KIND == kNN || KIND == kTN;
  constexpr int kStage = stage_bytes(BN);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + kSwizzleAtom - 1) & ~uintptr_t(kSwizzleAtom - 1));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStage);
  uint64_t* empty = full + kStages;
  uint64_t* y_ready = empty + kStages;
  float* extra = reinterpret_cast<float*>(smem + kStages * kStage + kBarrierBytes);

  const int m0 = blockIdx.x * kBM;
  const int ntiles = (p.N + BN - 1) / BN;
  const int t_begin = blockIdx.y * p.tpb, t_end = min(ntiles, t_begin + p.tpb);
  int k_begin = 0, k_end = p.K;
  if constexpr (KIND == kTN) {
    k_begin = blockIdx.z * p.rows;
    k_end = min(p.K, k_begin + p.rows);
  }
  const int ksteps = (k_end - k_begin + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);
    }
    mbar_init(y_ready, kConsumers / 32);
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // the producer warpgroup: one thread keeps the ring full
    setmaxnreg_dec<40>();
    if (threadIdx.x == kConsumers) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = t_begin; t < t_end; ++t) {
        const int n0 = t * BN;
        const CUtensorMap* map_a = &tma_a;
        if (KIND == kLnGemm && t > t_begin) {
          if (t == t_begin + 1) mbar_wait(y_ready, 0);
          map_a = &tma_y;
        }
        for (int ks = 0; ks < ksteps; ++ks) {
          const int k = k_begin + ks * kBK;
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], kStage);
          unsigned char* a = smem + stage * kStage;
          unsigned char* b = a + kTileA;
          if constexpr (kAMN) {
            tma_load_2d(a, map_a, &full[stage], m0, k);
            tma_load_2d(a + kBox, map_a, &full[stage], m0 + 64, k);
          } else {
            tma_load_2d(a, map_a, &full[stage], k, m0);
          }
          if constexpr (kBMN) {
#pragma unroll
            for (int j = 0; j < BN / 64; ++j)
              tma_load_2d(b + j * kBox, &tma_b, &full[stage], n0 + 64 * j, k);
          } else {
            tma_load_2d(b, &tma_b, &full[stage], k, n0);
          }
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    setmaxnreg_inc<232>();
    const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
    float* mean = extra;
    float* rstd = extra + kBM;
    float* sc = extra + 2 * kBM;
    float* bi = sc + p.K;
    if constexpr (KIND == kLnGemm) {
      for (int c = threadIdx.x; c < p.K; c += kConsumers) {
        sc[c] = p.ln_scale[c];
        bi[c] = p.ln_bias[c];
      }
      ln_row_stats(p, m0, mean, rstd);
      named_bar_sync(1, kConsumers);
    }
    const bool sums = KIND == kTN && p.cws != nullptr && blockIdx.y == 0;
    float csum = 0.f;

    // descriptors: the A half of this warpgroup and B, at stage 0, slice 0
    constexpr uint32_t kLboA = kAMN ? kBox : 16, kLboB = kBMN ? kBox : 16;
    constexpr uint32_t kSliceA = kAMN ? 16 * kSwizzleRow : 32;
    constexpr uint32_t kSliceB = kBMN ? 16 * kSwizzleRow : 32;
    const uint32_t base = smem_u32(smem);

    int stage = 0;
    uint32_t phase = 0;
    float acc[BN / 2];
    for (int t = t_begin; t < t_end; ++t) {
      const int n0 = t * BN;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      int prev = -1;
      for (int ks = 0; ks < ksteps; ++ks) {
        mbar_wait(&full[stage], phase);
        unsigned char* a = smem + stage * kStage;
        if (KIND == kLnGemm && t == t_begin) {
          ln_normalise(a, p, m0, ks * kBK, wg, mean, rstd, sc, bi);
          if (ks == ksteps - 1) {  // this warp's part of y is stored
            fence_proxy_async_global();
            __syncwarp();
            if (lane == 0) mbar_arrive(y_ready);
          }
        }
        const uint32_t sa = base + stage * kStage + wg * (kAMN ? kBox : 64 * kSwizzleRow);
        const uint32_t sb = base + stage * kStage + kTileA;
        fence_operands(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
          Wgmma<BN>::template mma<kAMN, kBMN>(
              acc, smem_desc(sa + kk * kSliceA, kLboA, kSwizzleAtom),
              smem_desc(sb + kk * kSliceB, kLboB, kSwizzleAtom), 1);
        wgmma_commit();
        if (sums) csum = tile_colsum(a, csum);
        wgmma_wait<1>();
        fence_operands(acc);
        __syncwarp();
        if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
        prev = stage;
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_operands(acc);
      __syncwarp();
      if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
      epilogue<BN, KIND, EPI>(acc, p, m0, n0, extra);
    }
    if (sums) {
      // the two row halves of each column, in order
      extra[threadIdx.x] = csum;
      named_bar_sync(1, kConsumers);
      if (threadIdx.x < kBM && m0 + (int)threadIdx.x < p.M)
        p.cws[(size_t)blockIdx.z * p.M + m0 + threadIdx.x] =
            extra[threadIdx.x] + extra[kBM + threadIdx.x];
    }
  }
}

// cuTensorMapEncodeTiled through the runtime's driver entry point: the
// library links no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                                    cudaEnableDefault, &q);
#endif
    return err == cudaSuccess && q == cudaDriverEntryPointSuccess ? (EncodeTiled)f : nullptr;
  }();
  return fn;
}

// The map of a row-major bf16 (rows, cols) matrix with row stride ld
// elements, boxes of 64 columns by box_rows rows in the 128-byte swizzle.
cudaError_t make_map(CUtensorMap* map, const void* ptr, int rows, int cols, int ld,
                     int box_rows) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * sizeof(bf16)};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
                         strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int BN, int KIND, int EPI>
cudaError_t launch_bn(const CUtensorMap& a, const CUtensorMap& b, const CUtensorMap& y,
                      const WgParams& p, dim3 grid, size_t smem, cudaStream_t stream) {
  const auto kernel = wg_gemm_kernel<BN, KIND, EPI>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreadsWG, smem, stream>>>(a, b, y, p);
  return cudaGetLastError();
}

template <int KIND, int EPI>
cudaError_t launch_epi(const CUtensorMap& a, const CUtensorMap& b, const CUtensorMap& y,
                       const WgParams& p, int bn, dim3 grid, cudaStream_t stream) {
  const size_t smem = wg_smem(KIND, bn, p.K);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  switch (bn) {
    case 128: return launch_bn<128, KIND, EPI>(a, b, y, p, grid, smem, stream);
    case 192: return launch_bn<192, KIND, EPI>(a, b, y, p, grid, smem, stream);
    case 256: return launch_bn<256, KIND, EPI>(a, b, y, p, grid, smem, stream);
    default: return cudaErrorInvalidValue;
  }
}

dim3 tile_grid(int M, int N, int bn, int tpb) {
  const int ntiles = (N + bn - 1) / bn;
  return dim3((M + kBM - 1) / kBM, (ntiles + tpb - 1) / tpb, 1);
}

WgParams params(int M, int N, int K, int tpb) {
  WgParams p{};
  p.M = M;
  p.N = N;
  p.K = K;
  p.tpb = tpb;
  return p;
}

}  // namespace
}  // namespace ddm

using ddm::bf16;

// out = epi(LN(x) w^T + bias) over (T, K) rows, w (N, K): epi 0 the bias
// alone, 1 GELU, 2 GELU writing gelu'(h) (fp32) to out2; `fast` the sigmoid
// GELU (epi 1 and 2 only); y_out gets y = bf16(LN(x)) (a block's later
// column tiles read it back). bn and tpb from gemm.py wg_tile_plan.
extern "C" int ddm_wg_ln_gemm(const void* x, const void* ln_scale, const void* ln_bias,
                              const void* w, const void* bias, void* out, void* out2,
                              void* y_out, int T, int K, int N, int epi, int fast, int bn,
                              int tpb, void* stream) {
  using namespace ddm;
  if (K % kBK != 0 || (epi != kEpiBiasWg && epi != kEpiGeluWg && epi != kEpiGeluGradWg) ||
      (epi == kEpiBiasWg && fast))
    return cudaErrorInvalidValue;
  CUtensorMap a, b, y;
  cudaError_t err = make_map(&a, x, T, K, K, kBM);
  if (err == cudaSuccess) err = make_map(&b, w, N, K, K, bn);
  if (err == cudaSuccess) err = make_map(&y, y_out, T, K, K, kBM);
  if (err != cudaSuccess) return (int)err;
  WgParams p = params(T, N, K, tpb);
  p.x = (const bf16*)x;
  p.ln_scale = (const float*)ln_scale;
  p.ln_bias = (const float*)ln_bias;
  p.bias = (const float*)bias;
  p.out = out;
  p.out2 = (float*)out2;
  p.y_out = (bf16*)y_out;
  const dim3 grid = tile_grid(T, N, bn, tpb);
  const cudaStream_t st = (cudaStream_t)stream;
  if (epi == kEpiBiasWg) return (int)launch_epi<kLnGemm, kEpiBias>(a, b, y, p, bn, grid, st);
  const int code = (epi == kEpiGeluGradWg ? kEpiGrad : 0) | (fast ? kEpiFast : 0);
  switch (code) {
    case 0: return (int)launch_epi<kLnGemm, 0>(a, b, y, p, bn, grid, st);
    case kEpiGrad: return (int)launch_epi<kLnGemm, kEpiGrad>(a, b, y, p, bn, grid, st);
    case kEpiFast: return (int)launch_epi<kLnGemm, kEpiFast>(a, b, y, p, bn, grid, st);
    default: return (int)launch_epi<kLnGemm, kEpiGrad | kEpiFast>(a, b, y, p, bn, grid, st);
  }
}

// out = bf16(res + (a w^T + bias)), a (T, K), w (N, K), res and out (T, N).
extern "C" int ddm_wg_gemm_residual(const void* a, const void* w, const void* bias,
                                    const void* res, void* out, int T, int K, int N, int bn,
                                    int tpb, void* stream) {
  using namespace ddm;
  if (K % kBK != 0) return cudaErrorInvalidValue;
  CUtensorMap ma, mb;
  cudaError_t err = make_map(&ma, a, T, K, K, kBM);
  if (err == cudaSuccess) err = make_map(&mb, w, N, K, K, bn);
  if (err != cudaSuccess) return (int)err;
  WgParams p = params(T, N, K, tpb);
  p.bias = (const float*)bias;
  p.res = (const bf16*)res;
  p.out = out;
  return (int)launch_epi<kResidual, 0>(ma, mb, ma, p, bn, tile_grid(T, N, bn, tpb),
                                       (cudaStream_t)stream);
}

// out = a (T, K) . w (K, N), w row-major (nn.Linear's (out, in) weight read
// as (K, N)): epi 0 fp32 out; epi 1 bf16 out; epi 2 dh = (a . w) * dfac
// (fp32 (T, N)) into the bf16 out, and colsum[N] = column sums of the
// unrounded dh through ws[ceil(T / 128), N].
extern "C" int ddm_wg_gemm_nn(const void* a, const void* w, const void* dfac, void* out,
                              void* ws, void* colsum, int T, int K, int N, int epi, int bn,
                              int tpb, void* stream) {
  using namespace ddm;
  if (K % kBK != 0 || (epi != kNNF32Wg && epi != kNNBf16Wg && epi != kNNDGeluWg))
    return cudaErrorInvalidValue;
  CUtensorMap ma, mb;
  cudaError_t err = make_map(&ma, a, T, K, K, kBM);
  if (err == cudaSuccess) err = make_map(&mb, w, K, N, N, 64);
  if (err != cudaSuccess) return (int)err;
  WgParams p = params(T, N, K, tpb);
  p.dfac = (const float*)dfac;
  p.out = out;
  p.ws = (float*)ws;
  const dim3 grid = tile_grid(T, N, bn, tpb);
  const cudaStream_t st = (cudaStream_t)stream;
  err = epi == kNNDGeluWg  ? launch_epi<kNN, kEpiDh>(ma, mb, ma, p, bn, grid, st)
        : epi == kNNBf16Wg ? launch_epi<kNN, kEpiBf16>(ma, mb, ma, p, bn, grid, st)
                           : launch_epi<kNN, 0>(ma, mb, ma, p, bn, grid, st);
  if (err != cudaSuccess || epi != kNNDGeluWg) return (int)err;
  return (int)reduce_rows((const float*)ws, (float*)colsum, grid.x, N, st);
}

// dw (Ma, Nb) = a (T, Ma)^T . b (T, Nb) in fp32, over `splits` row ranges of
// `rows` rows (ws: splits x Ma x Nb), summed in order; with cws set also
// colsum (Ma) = column sums of a through cws (splits x Ma).
extern "C" int ddm_wg_gemm_tn(const void* a, const void* b, void* ws, void* dw, void* cws,
                              void* colsum, int T, int Ma, int Nb, int splits, int rows, int bn,
                              void* stream) {
  using namespace ddm;
  if (rows % kBK != 0 || (long long)splits * rows < T || (long long)(splits - 1) * rows >= T)
    return cudaErrorInvalidValue;
  CUtensorMap ma, mb;
  cudaError_t err = make_map(&ma, a, T, Ma, Ma, 64);
  if (err == cudaSuccess) err = make_map(&mb, b, T, Nb, Nb, 64);
  if (err != cudaSuccess) return (int)err;
  WgParams p = params(Ma, Nb, T, 1);
  p.ws = (float*)ws;
  p.cws = (float*)cws;
  p.rows = rows;
  dim3 grid = tile_grid(Ma, Nb, bn, 1);
  grid.z = splits;
  const cudaStream_t st = (cudaStream_t)stream;
  err = launch_epi<kTN, 0>(ma, mb, ma, p, bn, grid, st);
  if (err == cudaSuccess) err = reduce_rows((const float*)ws, (float*)dw, splits, Ma * Nb, st);
  if (err != cudaSuccess || cws == nullptr) return (int)err;
  return (int)reduce_rows((const float*)cws, (float*)colsum, splits, Ma, st);
}

// Host cost of the descriptors: encodes n maps of a (rows, cols) bf16
// matrix at `ptr` (device memory, not read) and writes the mean
// microseconds an encoding to *us.
extern "C" int ddm_wg_encode_cost(const void* ptr, int rows, int cols, int n, float* us) {
  using namespace ddm;
  CUtensorMap map;
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < n; ++i) {
    const cudaError_t err = make_map(&map, ptr, rows, cols, cols, kBM);
    if (err != cudaSuccess) return (int)err;
  }
  const auto t1 = std::chrono::steady_clock::now();
  *us = std::chrono::duration<float, std::micro>(t1 - t0).count() / (n > 0 ? n : 1);
  return 0;
}
