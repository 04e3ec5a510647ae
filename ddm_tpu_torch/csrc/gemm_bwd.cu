// GEMMs, LayerNorm backward and fixed-order reductions for the DiT
// half-block backwards.
//
// The WMMA products of the expert FFN's forward K10f, and the LayerNorm
// backward that every dense half-block backward ends with. The MLP
// half-block's backward K1b (ddm_tpu/ops/mlp_block.py `_bwd_kernel`), the
// tensor-parallel partial's K6b, the attention half-block's K2b and K4
// (ddm_tpu/ops/attention.py `_blk_bwd_kernel`, `_blk_bwd_split_kernel`, and
// the third rung's chain around K7b or K8b), and the expert FFN's K10b and
// K10p run gemm_wg.cu's wgmma products (the backwards with this file's
// LayerNorm backward); they ran this file's NN and TN products (with
// gemm.cu's ddm_ln_gemm) until then, and chip_smoke.py still times those
// earlier chains beside them.
//
// The TPU kernels keep the weights and fp32 dW accumulators in VMEM and sum
// dW across their sequential grid. CUDA blocks run at once and in no order,
// so each product is its own kernel here:
//   * NN, out = A . W with W in nn.Linear's (out, in) layout read as
//     (K, Nout): the dx-side products (dO W2, dH W1), with epilogues fp32,
//     bf16, or (MLP) dh = acc * gelu'(h) rounded to
//     bf16 with per-block column sums of the unrounded dh (db1);
//   * TN, out = A^T . B contracting over the T token rows: the weight
//     gradients, as deterministic split-K. Each split writes fp32 partials
//     (and, for the bias gradients, column sums of A) and a second kernel
//     sums the splits in a fixed order;
//   * the LayerNorm backward with the residual, one warp per row, writing
//     dx and per-block column partials of dscale and dbias.
//
// K6b, the backward of the tensor-parallel MLP partial (ddm_tpu/ops/
// mlp_block.py `_partial_bwd_kernel`, `_bwd_body` with no db2 and no
// residual), is K1b's chain with three changes: its cotangent arrives in
// fp32 and this file's cast kernel rounds it to bf16 for the products (the
// TPU kernel's `dob`), the dW2 product sums no column (no db2), and this
// file's LayerNorm backward runs without the residual term (dres null).
// No atomics: every sum has one fixed order, so the same inputs give
// bit-identical gradients.
//
// The NN and TN products also run batched over experts, for the MoE expert
// FFN's forward K10f (ddm_tpu/ops/expert_ffn.py `_fwd_kernel`) and the
// earlier K10b and K10p chains:
// blockIdx.z selects the expert and every operand advances by one
// expert's contiguous slab, with no-LN epilogues (bias, bias + GELU, and
// bias + GELU writing gelu'(h) beside it for the backward's recompute; the
// GELU exact, or the sigmoid GELU where the launch parameter `fast` is set).
// The dense callers run a batch of one.
//
// What bounds it on the H100: an MLP backward's products at DiT-S/4's
// training shape (T = 131072 rows, D = 384, F = 1536; K6b takes a rank's
// share of F) are ~0.8 TFLOP of bf16 per block, plus
// the (T, F) activations that go through device memory (g and dh in bf16,
// gelu'(h) in fp32: ~1.6 GB per call). The products are WMMA (mma.sync) on
// synchronously loaded tiles, as in gemm.cu; K10f's are the last a path
// launches, and moving them onto gemm_wg.cu's wgmma mainloop, as K1b's,
// K2b's, K6b's, K10b's and K10p's are, is the next step.
#include <algorithm>

#include "common.cuh"

namespace ddm {
namespace {

constexpr int BM = 64;         // rows per block
constexpr int BN = 128;        // output columns per tile
constexpr int BK = 64;         // depth per streamed chunk
constexpr int kThreads = 256;  // 8 warps as 2 (rows) x 4 (cols), 32x32 each
constexpr int ALD = BK + kPadH;    // A tile, row-major (BM x BK)
constexpr int WLD = BN + kPadH;    // W / B tile, row-major (BK x BN)
constexpr int TLD = BM + kPadH;    // TN: A tile, row-major (BK rows of T x BM)
constexpr int CLD = BN + kPadF;
constexpr float kLnEps = 1e-6f;

constexpr float kInvSqrt2 = 0.70710678118654752440f;
constexpr float kInvSqrt2Pi = 0.39894228040143267794f;

enum NNEpi : int {
  kNNF32 = 0,           // out (fp32) = acc
  kNNBf16 = 1,          // out (bf16) = bf16(acc)
  kNNDGelu = 2,         // dh = acc * aux; out (bf16) = bf16(dh); colsum partials of dh
  kNNBias = 3,          // out (bf16) = bf16(acc + bias)
  kNNBiasGelu = 4,      // out (bf16) = bf16(gelu(acc + bias))
  kNNBiasGeluGrad = 5,  // as kNNBiasGelu, and aux (fp32) = gelu'(acc + bias)
};

__device__ __forceinline__ void zero_acc(FragC (&acc)[2][2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
}

__device__ __forceinline__ void store_acc(float* Cs, FragC (&acc)[2][2], int wm, int wn) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * kFrag) * CLD + wn * 32 + j * kFrag,
                              acc[i][j], CLD, wmma::mem_row_major);
}

// Copy rows [r0, r0 + nrows) x cols [c0, c0 + ncols) of a row-major bf16
// matrix (ld columns) into a shared tile; rows >= rmax or cols >= cmax are 0.
template <int NROWS, int NCOLS>
__device__ __forceinline__ void load_tile(bf16* dst, int dld, const bf16* __restrict__ src,
                                          int ld, int r0, int c0, int rmax, int cmax) {
  constexpr int kVec = NCOLS / 8;
  for (int i = threadIdx.x; i < NROWS * kVec; i += kThreads) {
    const int r = i / kVec, c = (i % kVec) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r0 + r < rmax && c0 + c < cmax)
      v = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * ld + c0 + c);
    *reinterpret_cast<uint4*>(dst + r * dld + c) = v;
  }
}

// out[T, Nout] = epi(A[T, K] . W[K, Nout]), W row-major with row stride ldw
// (nn.Linear's (out, in) weight with out = K, or a column chunk of a wider
// matrix read in place). EPI < 0 is the dense callers' kernel: one slab, the
// epilogue `epi` (F32, BF16 or DGELU) chosen at run time. EPI >= 0 is the
// expert-batched kernel for that epilogue: blockIdx.z is the expert, and A,
// W, out and aux advance by T*K, wstride and T*Nout elements, bias by Nout,
// colsum by one (ceil(T / BM), Nout) slab. Compiled apart: with the batched
// code in the same kernel, or specialised to one epilogue, the dense shapes
// ran 10-15% slower (profile_torch_step.py's gemm_nn rows), with no spills.
template <int EPI>
__global__ void __launch_bounds__(kThreads)
gemm_nn_kernel(const bf16* __restrict__ a, const bf16* __restrict__ w,
               const float* __restrict__ bias, float* __restrict__ aux,
               void* __restrict__ out, float* __restrict__ colsum, int T, int K, int Nout,
               int ldw, int wstride, int epi, int fast) {
  constexpr bool kBatched = EPI >= 0;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Ws = As + BM * ALD;
  float* Cs = reinterpret_cast<float*>(Ws + BK * WLD);

  const int row0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  if constexpr (kBatched) {
    epi = EPI;
    const size_t z = blockIdx.z, tn = (size_t)T * Nout;
    a += z * T * K;
    w += z * wstride;
    if (bias != nullptr) bias += z * Nout;
    if (aux != nullptr) aux += z * tn;
    if (colsum != nullptr) colsum += z * gridDim.x * Nout;
    out = EPI == kNNF32 ? (void*)(reinterpret_cast<float*>(out) + z * tn)
                        : (void*)(reinterpret_cast<bf16*>(out) + z * tn);
  }
  const float* __restrict__ dfac = aux;  // read-only in the dgelu epilogue
  const int warp = threadIdx.x / 32;
  const int wm = warp / 4, wn = warp % 4;

  FragC acc[2][2];
  zero_acc(acc);
  for (int k0 = 0; k0 < K; k0 += BK) {
    __syncthreads();
    load_tile<BM, BK>(As, ALD, a, K, row0, k0, T, K);
    load_tile<BK, BN>(Ws, WLD, w, ldw, k0, n0, K, Nout);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += kFrag) {
      FragA fa[2];
      FragBRow fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], As + (wm * 32 + i * kFrag) * ALD + kk, ALD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], Ws + kk * WLD + wn * 32 + j * kFrag, WLD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }
  store_acc(Cs, acc, wm, wn);
  __syncthreads();

  for (int i = threadIdx.x; i < BM * BN; i += kThreads) {
    const int r = i / BN, c = i % BN;
    const int row = row0 + r, col = n0 + c;
    if (row >= T || col >= Nout) continue;
    const size_t o = (size_t)row * Nout + col;
    const float v = Cs[r * CLD + c];
    if (epi == kNNF32) {
      reinterpret_cast<float*>(out)[o] = v;
    } else if (epi == kNNBf16) {
      reinterpret_cast<bf16*>(out)[o] = __float2bfloat16(v);
    } else if (!kBatched || epi == kNNDGelu) {
      const float dh = v * dfac[o];
      Cs[r * CLD + c] = dh;
      reinterpret_cast<bf16*>(out)[o] = __float2bfloat16(dh);
    } else if constexpr (kBatched) {
      const float h = v + bias[col];
      float g = h;
      if constexpr (EPI != kNNBias) {
        if (fast) {
          // one sigmoid shared by the fast GELU and its derivative
          const float s = fast_gelu_sigmoid(h);
          if constexpr (EPI == kNNBiasGeluGrad) aux[o] = s * (1.0f + kFastGeluC * h * (1.0f - s));
          g = h * s;
        } else {
          // one erf shared by the GELU and its derivative (_act_fwd_bwd)
          const float e = erff(h * kInvSqrt2);
          if constexpr (EPI == kNNBiasGeluGrad)
            aux[o] = 0.5f * (1.0f + e) + h * kInvSqrt2Pi * expf(-0.5f * h * h);
          g = 0.5f * h * (1.0f + e);
        }
      }
      reinterpret_cast<bf16*>(out)[o] = __float2bfloat16(g);
    }
  }
  if (epi == kNNDGelu) {
    __syncthreads();
    // this block's column sums of the unrounded dh, rows in order
    for (int c = threadIdx.x; c < BN; c += kThreads) {
      if (n0 + c >= Nout) continue;
      float s = 0.f;
      const int rows = min(BM, T - row0);
      for (int r = 0; r < rows; ++r) s += Cs[r * CLD + c];
      colsum[(size_t)blockIdx.x * Nout + n0 + c] = s;
    }
  }
}

// Split-K partials of out[Ma, Nb] = A[T, Ma]^T . B[T, Nb]: blockIdx.z =
// e * splits + s, and split s of batch element e (A and B advance by T*Ma
// and T*Nb elements) sums the rows [s * rows, (s + 1) * rows) into
// ws[blockIdx.z]. With colsum set, the blocks of the first column tile also
// write the split's column sums of A (colsum_of_b = 0) or the blocks of
// the first row tile those of B (colsum_of_b = 1), at colsum[blockIdx.z].
// The dense callers' kernel (BATCHED false: one slab, sums of A) is
// compiled apart, as the NN GEMM's is: one kernel for both left K2b 6%
// slower (chip_smoke.py, against the kernel before the batch logic).
template <bool BATCHED>
__global__ void __launch_bounds__(kThreads)
gemm_tn_kernel(const bf16* __restrict__ a, const bf16* __restrict__ b,
               float* __restrict__ ws, float* __restrict__ colsum, int T, int Ma, int Nb,
               int rows, int splits, int colsum_of_b) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);     // BK (rows of T) x TLD
  bf16* Bs = As + BK * TLD;                     // BK x WLD
  float* Cs = reinterpret_cast<float*>(Bs + BK * WLD);

  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN, z = blockIdx.z;
  int s = z;
  if constexpr (BATCHED) {
    const int e = z / splits;
    s = z % splits;
    a += (size_t)e * T * Ma;
    b += (size_t)e * T * Nb;
  } else {
    colsum_of_b = 0;
  }
  const int t_begin = s * rows, t_end = min(T, t_begin + rows);
  const int warp = threadIdx.x / 32;
  const int wm = warp / 4, wn = warp % 4;
  const bool sums = colsum != nullptr &&
                    (colsum_of_b ? blockIdx.x == 0 && threadIdx.x < BN
                                 : blockIdx.y == 0 && threadIdx.x < BM);

  FragC acc[2][2];
  zero_acc(acc);
  float csum = 0.f;
  for (int t0 = t_begin; t0 < t_end; t0 += BK) {
    __syncthreads();
    load_tile<BK, BM>(As, TLD, a, Ma, t0, m0, t_end, Ma);
    load_tile<BK, BN>(Bs, WLD, b, Nb, t0, n0, t_end, Nb);
    __syncthreads();
    if (sums) {
      const bf16* src = colsum_of_b ? Bs + threadIdx.x : As + threadIdx.x;
      const int ld = colsum_of_b ? WLD : TLD;
      for (int r = 0; r < BK; ++r) csum += __bfloat162float(src[r * ld]);
    }
#pragma unroll
    for (int kk = 0; kk < BK; kk += kFrag) {
      FragACol fa[2];
      FragBRow fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], As + kk * TLD + wm * 32 + i * kFrag, TLD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], Bs + kk * WLD + wn * 32 + j * kFrag, WLD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }
  store_acc(Cs, acc, wm, wn);
  __syncthreads();
  float* dst = ws + (size_t)z * Ma * Nb;
  for (int i = threadIdx.x; i < BM * BN; i += kThreads) {
    const int r = i / BN, c = i % BN;
    if (m0 + r < Ma && n0 + c < Nb) dst[(size_t)(m0 + r) * Nb + n0 + c] = Cs[r * CLD + c];
  }
  if (sums) {
    const int c0 = colsum_of_b ? n0 : m0, C = colsum_of_b ? Nb : Ma;
    if (c0 + (int)threadIdx.x < C) colsum[(size_t)z * C + c0 + threadIdx.x] = csum;
  }
}

// LayerNorm backward with the residual over rows of D, one warp per row:
//   dx = bf16(dres + inv * (dyh - mean(dyh) - xhat * mean(dyh * xhat))),
//   dyh = dy * scale; per-block column partials of dy * xhat and dy. A
//   null dres is K6b's LN backward alone (no residual term). Each of the
//   WARPS warps keeps its 2 x D fp32 column partials in shared memory: 8
//   warps up to D 3584 (64 D bytes), 4 past it (up to D 7264), each warp
//   then walking twice the rows; the sum order at 8 warps is unchanged.
//   LN = false is X3's ablation (tools/kbench_ablate.py skip_ln): dx =
//   bf16(dres + dy), no LN algebra and no partials (x, scale and partial
//   unread); every other caller takes LN = true.
constexpr int kLnRows = 64;

template <int WARPS, bool LN = true>
__global__ void __launch_bounds__(WARPS * 32)
ln_bwd_kernel(const bf16* __restrict__ x, const float* __restrict__ dy,
              const bf16* __restrict__ dres, const float* __restrict__ scale,
              bf16* __restrict__ dx, float* __restrict__ partial, int T, int D) {
  if constexpr (!LN) {
    const int row0 = blockIdx.x * kLnRows, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int r = warp; r < kLnRows && row0 + r < T; r += WARPS) {
      const size_t o = (size_t)(row0 + r) * D;
      for (int c = lane; c < D; c += 32)
        dx[o + c] = __float2bfloat16(__bfloat162float(dres[o + c]) + dy[o + c]);
    }
    return;
  }
  extern __shared__ __align__(128) unsigned char smem[];
  float* acc = reinterpret_cast<float*>(smem);  // [WARPS][2][D]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* wacc = acc + (size_t)warp * 2 * D;
  for (int c = lane; c < D; c += 32) wacc[c] = wacc[D + c] = 0.f;

  const int row0 = blockIdx.x * kLnRows;
  for (int r = warp; r < kLnRows; r += WARPS) {
    const int row = row0 + r;
    if (row >= T) break;
    const bf16* xr = x + (size_t)row * D;
    const float* dyr = dy + (size_t)row * D;
    float s = 0.f;
    for (int c = lane; c < D; c += 32) s += __bfloat162float(xr[c]);
    const float mu = warp_sum(s) / D;
    float q = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float d = __bfloat162float(xr[c]) - mu;
      q += d * d;
    }
    const float inv = rsqrtf(warp_sum(q) / D + kLnEps);
    float m1 = 0.f, m2 = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float xhat = (__bfloat162float(xr[c]) - mu) * inv;
      const float g = dyr[c] * scale[c];
      m1 += g;
      m2 += g * xhat;
      wacc[c] += dyr[c] * xhat;
      wacc[D + c] += dyr[c];
    }
    m1 = warp_sum(m1) / D;
    m2 = warp_sum(m2) / D;
    for (int c = lane; c < D; c += 32) {
      const float xhat = (__bfloat162float(xr[c]) - mu) * inv;
      const float g = dyr[c] * scale[c];
      const float res = dres != nullptr ? __bfloat162float(dres[(size_t)row * D + c]) : 0.f;
      const float v = res + inv * (g - m1 - xhat * m2);
      dx[(size_t)row * D + c] = __float2bfloat16(v);
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < 2 * D; c += WARPS * 32) {
    float t = acc[c];
    for (int k = 1; k < WARPS; ++k) t += acc[(size_t)k * 2 * D + c];
    partial[(size_t)blockIdx.x * 2 * D + c] = t;
  }
}

// dst = bf16(src), four elements a thread per step of a grid-stride loop
// (src 16-byte and dst 8-byte aligned; the tail one element at a time).
__global__ void __launch_bounds__(kThreads)
cast_bf16_kernel(const float* __restrict__ src, bf16* __restrict__ dst, int n) {
  const int n4 = n / 4;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n4; i += gridDim.x * kThreads) {
    const float4 v = reinterpret_cast<const float4*>(src)[i];
    __nv_bfloat162* d = reinterpret_cast<__nv_bfloat162*>(dst + 4 * (size_t)i);
    d[0] = __floats2bfloat162_rn(v.x, v.y);
    d[1] = __floats2bfloat162_rn(v.z, v.w);
  }
  if (blockIdx.x == 0)
    for (int i = 4 * n4 + threadIdx.x; i < n; i += kThreads) dst[i] = __float2bfloat16(src[i]);
}

template <int EPI>
cudaError_t launch_nn(dim3 grid, size_t smem, cudaStream_t stream, const bf16* a, const bf16* w,
                      const float* bias, float* aux, void* out, float* colsum, int T, int K,
                      int Nout, int ldw, int wstride, int epi, int fast) {
  cudaError_t err = cudaFuncSetAttribute(gemm_nn_kernel<EPI>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  gemm_nn_kernel<EPI><<<grid, kThreads, smem, stream>>>(a, w, bias, aux, out, colsum, T, K,
                                                         Nout, ldw, wstride, epi, fast);
  return cudaGetLastError();
}

}  // namespace
}  // namespace ddm

using ddm::bf16;

// out = epi(a[T, K] . w[K, Nout]) for each of `batch` slabs (a: batch x T
// x K contiguous; w: K rows of row stride ldw per slab, slabs wstride
// elements apart; out and aux: batch x T x Nout; bias: batch x Nout). epi 2
// reads aux (gelu'(h)) and writes db = column sums of dh through
// colsum_ws[batch, ceil(T / 64), Nout] into colsum_out[batch, Nout]; epi 5
// writes aux. With `fast`, epilogues 4 and 5 take the sigmoid GELU of
// --fast-gelu.
extern "C" int ddm_gemm_nn(const void* a, const void* w, const void* bias, void* aux, void* out,
                           void* colsum_ws, void* colsum_out, int T, int K, int Nout, int ldw,
                           int wstride, int epi, int batch, int fast, void* stream) {
  using namespace ddm;
  const size_t smem = (size_t)(BM * ALD + BK * WLD) * sizeof(bf16) +
                      (size_t)BM * CLD * sizeof(float);
  const int nblk = (T + BM - 1) / BM;
  const dim3 grid(nblk, (Nout + BN - 1) / BN, batch);
  decltype(&launch_nn<kNNF32>) launch;
  switch (batch > 1 || epi > kNNDGelu ? epi : -1) {
    case -1: launch = launch_nn<-1>; break;
    case kNNF32: launch = launch_nn<kNNF32>; break;
    case kNNBf16: launch = launch_nn<kNNBf16>; break;
    case kNNDGelu: launch = launch_nn<kNNDGelu>; break;
    case kNNBias: launch = launch_nn<kNNBias>; break;
    case kNNBiasGelu: launch = launch_nn<kNNBiasGelu>; break;
    case kNNBiasGeluGrad: launch = launch_nn<kNNBiasGeluGrad>; break;
    default: return (int)cudaErrorInvalidValue;
  }
  const cudaError_t err = launch(grid, smem, (cudaStream_t)stream, (const bf16*)a,
                                 (const bf16*)w, (const float*)bias, (float*)aux, out,
                                 (float*)colsum_ws, T, K, Nout, ldw, wstride, epi, fast);
  if (err != cudaSuccess || epi != kNNDGelu) return (int)err;
  return (int)reduce_rows((const float*)colsum_ws, (float*)colsum_out, nblk, Nout,
                          (cudaStream_t)stream, batch);
}

// dw[e, Ma, Nb] = a[e, T, Ma]^T . b[e, T, Nb] for each of `batch` slabs, in
// `splits` fixed row ranges of `rows` rows (ws holds batch x splits x Ma x
// Nb fp32); with colsum_ws set, also colsum_out[e] = column sums of a
// (colsum_of_b = 0, length Ma) or of b (1, length Nb), through colsum_ws
// (batch x splits x that length).
extern "C" int ddm_gemm_tn(const void* a, const void* b, void* ws, void* dw, void* colsum_ws,
                           void* colsum_out, int T, int Ma, int Nb, int splits, int rows,
                           int colsum_of_b, int batch, void* stream) {
  using namespace ddm;
  const size_t smem = (size_t)(BK * TLD + BK * WLD) * sizeof(bf16) +
                      (size_t)BM * CLD * sizeof(float);
  const auto kernel = batch > 1 || colsum_of_b ? gemm_tn_kernel<true> : gemm_tn_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Ma + BM - 1) / BM, (Nb + BN - 1) / BN, splits * batch);
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const bf16*)a, (const bf16*)b, (float*)ws, (float*)colsum_ws, T, Ma, Nb, rows, splits,
      colsum_of_b);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = reduce_rows((const float*)ws, (float*)dw, splits, Ma * Nb, (cudaStream_t)stream, batch);
  if (err != cudaSuccess || colsum_ws == nullptr) return (int)err;
  return (int)reduce_rows((const float*)colsum_ws, (float*)colsum_out, splits,
                          colsum_of_b ? Nb : Ma, (cudaStream_t)stream, batch);
}

// dx = LN backward + residual (none where dres is null); dscale_dbias[2, D] =
// (sum dy * xhat, sum dy) through partial[ceil(T / 64), 2, D].
extern "C" int ddm_ln_bwd(const void* x, const void* dy, const void* dres, const void* scale,
                          void* dx, void* partial, void* dscale_dbias, int T, int D,
                          void* stream) {
  using namespace ddm;
  constexpr size_t kMaxSmem = 232448;  // a block's shared memory on the H100
  const bool wide = (size_t)8 * 2 * D * sizeof(float) > kMaxSmem;
  const int warps = wide ? 4 : 8;
  const auto kernel = wide ? ln_bwd_kernel<4> : ln_bwd_kernel<8>;
  const size_t smem = (size_t)warps * 2 * D * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int nblk = (T + kLnRows - 1) / kLnRows;
  kernel<<<nblk, warps * 32, smem, (cudaStream_t)stream>>>(
      (const bf16*)x, (const float*)dy, (const bf16*)dres, (const float*)scale, (bf16*)dx,
      (float*)partial, T, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)reduce_rows((const float*)partial, (float*)dscale_dbias, nblk, 2 * D,
                          (cudaStream_t)stream);
}

// X3's LN-backward ablation: dx = bf16(dres + dy) over (T, D) rows, the
// instance of ln_bwd_kernel without the LN algebra (dscale = dbias = 0 are
// the caller's).
extern "C" int ddm_ln_bwd_residual(const void* dy, const void* dres, void* dx, int T, int D,
                                   void* stream) {
  using namespace ddm;
  const int nblk = (T + kLnRows - 1) / kLnRows;
  ln_bwd_kernel<8, false><<<nblk, 8 * 32, 0, (cudaStream_t)stream>>>(
      nullptr, (const float*)dy, (const bf16*)dres, nullptr, (bf16*)dx, nullptr, T, D);
  return (int)cudaGetLastError();
}

// dst[n] = bf16(src[n]): K6b's fp32 cotangent rounded for its products.
extern "C" int ddm_cast_bf16(const void* src, void* dst, int n, void* stream) {
  using namespace ddm;
  const int blocks = (int)std::min<long long>(((long long)n / 4 + kThreads - 1) / kThreads + 1,
                                              132 * 16);
  cast_bf16_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>((const float*)src, (bf16*)dst,
                                                                   n);
  return (int)cudaGetLastError();
}
