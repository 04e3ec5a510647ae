// Row-panel GEMMs with fused prologues and epilogues for the DiT half-blocks.
//
// The WMMA products that the F-chunked MLP forward K6f and (with
// gemm_bwd.cu) K6b ran before gemm_wg.cu's, kept as the earlier designs
// chip_smoke.py times beside them. Both dense half-blocks left them for the
// wgmma products of gemm_wg.cu: the MLP half-block K1f and K1b, and the
// attention half-block (ddm_tpu/ops/attention.py `_blk_fwd_kernel`, out = x
// + proj(MHA(qkv(LN(x))))), whose chains K2f, K2b, K4 and the third rung's
// ran ddm_ln_gemm(gelu=0), ddm_attention_core, ddm_gemm_residual here
// until then. X2f (whole_block.cu) reproduces this file's pair of products
// for both halves, and its bit check composes them: the WMMA K2f chain
// (ddm_ln_gemm with the bias epilogue, the resident core,
// ddm_gemm_residual) and the WMMA MLP half.
//
// What bounds it on the H100: at the DiT-S/4 sampling shape (T = 16384 rows,
// D = 384, F = 1536) the MLP products are 2 x 19.3 GFLOP against ~12.6 MB of
// activations in and out plus the (T, F) bf16 hidden activation (50 MB
// written and read back), so the kernels sit near the compute/bandwidth
// ridge. The TPU kernel kept both weight matrices and the hidden activation
// in VMEM for the whole grid; W1 + W2 are 2.4 MB in bf16 against 227 KB of
// shared memory per block, so that design does not transfer. Here:
//   * the LayerNorm is a prologue: a block loads its 64-row panel once,
//     normalises it in fp32 and keeps it in shared memory as bf16 while it
//     streams weight column tiles past it. Past D 1344 that panel no longer
//     fits 227 KB; there ln_gemm_stream_kernel keeps only each row's mean
//     and rstd and normalises 64-column chunks of x as they stream in
//     beside the weight tiles (the same rounding, so the same bits);
//   * bias, exact-erf GELU (or, with the launch parameter `fast`, the
//     sigmoid GELU of --fast-gelu) and the residual are epilogues on the fp32
//     accumulators, so no fp32 intermediate reaches device memory;
//   * the (T, F) hidden activation still goes through device memory.
//     These products are WMMA (mma.sync) on synchronously loaded tiles;
//     gemm_wg.cu's wgmma mainloop fed by a TMA ring, which K1 and K2 run,
//     is what K6 and K10 move onto next.
//
// Numerics follow the TPU kernels: LN statistics in fp32 with eps 1e-6,
// bf16 operands with fp32 accumulation, GELU in fp32 (exact erf, where the
// TPU kernel used a polynomial erf as a Mosaic workaround), the residual
// added in fp32 and rounded to bf16 once.
//
// The F-chunked MLP forward (DiT-L widths) replaces
// ddm_tpu/ops/mlp_block.py `_partial_fwd_kernel` (K5/K6f, via
// `_fused_partial_fwd_call`, run k times by `_fchunked_fwd_call`): per hidden
// chunk, ddm_ln_gemm(gelu=1) on the W1 row chunk and ddm_gemm_partial on the
// W2 column chunk, read in place (row stride F). The fp32 partials sum in
// chunk order, acc = p0 + p1 + ..., and the last chunk's epilogue rounds
// (x + acc) + b2 once, as the JAX package's XLA sum does. The TPU chunked
// because both weight chunks had to sit in VMEM; here that costs one more
// LN prologue and one (T, D) fp32 round trip per extra chunk.
//
// The earlier K6b chain reused ddm_ln_gemm for its forward recompute: it
// can also write the normalised panel y =
// bf16(LN(x)) and, for the MLP, the fp32 GELU derivative beside the bf16
// GELU output.
#include "common.cuh"

namespace ddm {
namespace {

constexpr int BM = 64;         // rows per block
constexpr int BN = 128;        // output columns per tile
constexpr int BK = 64;         // depth per streamed chunk
constexpr int kThreads = 256;  // 8 warps as 2 (rows) x 4 (cols), 32x32 each
constexpr int BLD = BK + kPadH;
constexpr int CLD = BN + kPadF;
constexpr int kTilesPerBlock = 4;  // column tiles one LN-prologue block walks
constexpr float kLnEps = 1e-6f;
constexpr float kInvSqrt2 = 0.70710678118654752440f;
constexpr float kInvSqrt2Pi = 0.39894228040143267794f;

// ln_gemm epilogues on h = acc + bias
enum LnGemmEpi : int {
  kEpiBias = 0,      // out = bf16(h)
  kEpiGelu = 1,      // out = bf16(gelu(h))
  kEpiGeluGrad = 2,  // out = bf16(gelu(h)), out2 = gelu'(h) in fp32
};

// fp32-partial epilogues of gemm_partial_kernel on sum = a . W^T (the
// F-chunked MLP forward: one launch per hidden chunk, in chunk order)
enum PartialEpi : int {
  kPartStore = 0,     // acc = sum
  kPartAdd = 1,       // acc = acc + sum
  kPartFinalRes = 2,  // out = bf16((res + (acc + sum)) + bias)
};

// Copy a (BN x BK) tile of W (Nout rows of ldw elements, row-major:
// nn.Linear's layout, or a column chunk of it) into shared memory; rows past
// Nout are zero.
__device__ __forceinline__ void load_w_tile(bf16* Bs, const bf16* __restrict__ w,
                                            int n0, int k0, int ldw, int Nout) {
  constexpr int kVec = BK / 8;
  for (int i = threadIdx.x; i < BN * kVec; i += kThreads) {
    const int r = i / kVec, c = i % kVec;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (n0 + r < Nout)
      v = *reinterpret_cast<const uint4*>(w + (size_t)(n0 + r) * ldw + k0 + c * 8);
    *reinterpret_cast<uint4*>(Bs + r * BLD + c * 8) = v;
  }
}

// acc[i][j] += A[32 rows of this warp, BK] * W-tile^T[BK, 32 cols of this warp]
__device__ __forceinline__ void mma_chunk(FragC (&acc)[2][2], const bf16* As, int lda,
                                          const bf16* Bs, int wm, int wn) {
#pragma unroll
  for (int kk = 0; kk < BK; kk += kFrag) {
    FragA a[2];
    FragBCol b[2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      wmma::load_matrix_sync(a[i], As + (wm * 32 + i * kFrag) * lda + kk, lda);
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::load_matrix_sync(b[j], Bs + (wn * 32 + j * kFrag) * BLD + kk, BLD);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
  }
}

__device__ __forceinline__ void store_acc(float* Cs, FragC (&acc)[2][2], int wm, int wn) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * kFrag) * CLD + wn * 32 + j * kFrag,
                              acc[i][j], CLD, wmma::mem_row_major);
}

__device__ __forceinline__ void zero_acc(FragC (&acc)[2][2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
}

// Cs[BM, BN] (fp32, row stride CLD) = a[row0 : row0 + BM, :K] @ W[n0 : n0 +
// BN, :K]^T, a row-major with K columns, W with row stride ldw; rows past T
// or Nout are zero. Ends with a barrier: Cs is complete.
__device__ __forceinline__ void gemm_tile(float* Cs, bf16* As, bf16* Bs,
                                          const bf16* __restrict__ a,
                                          const bf16* __restrict__ w, int ldw, int row0,
                                          int n0, int T, int K, int Nout) {
  const int warp = threadIdx.x / 32;
  const int wm = warp / 4, wn = warp % 4;
  FragC acc[2][2];
  zero_acc(acc);
  constexpr int kVec = BK / 8;
  for (int k0 = 0; k0 < K; k0 += BK) {
    __syncthreads();
    for (int i = threadIdx.x; i < BM * kVec; i += kThreads) {
      const int r = i / kVec, c = i % kVec;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (row0 + r < T)
        v = *reinterpret_cast<const uint4*>(a + (size_t)(row0 + r) * K + k0 + c * 8);
      *reinterpret_cast<uint4*>(As + r * BLD + c * 8) = v;
    }
    load_w_tile(Bs, w, n0, k0, ldw, Nout);
    __syncthreads();
    mma_chunk(acc, As, BLD, Bs, wm, wn);
  }
  store_acc(Cs, acc, wm, wn);
  __syncthreads();
}

// The LN-prologue GEMMs' epilogue on one finished C tile (Cs, BM x BN
// fp32, output columns n0 .. n0 + BN): out = epi(Cs + bias) (see LnGemmEpi).
__device__ __forceinline__ void ln_gemm_epilogue(const float* Cs, const float* __restrict__ bias,
                                                 bf16* __restrict__ out, float* __restrict__ out2,
                                                 int row0, int n0, int T, int Nout, int epi,
                                                 int fast) {
  for (int i = threadIdx.x; i < BM * BN / 2; i += kThreads) {
    const int r = i / (BN / 2), c = 2 * (i % (BN / 2));
    const int row = row0 + r, col = n0 + c;
    if (row >= T || col >= Nout) continue;
    const size_t o = (size_t)row * Nout + col;
    float v0 = Cs[r * CLD + c] + bias[col];
    float v1 = Cs[r * CLD + c + 1] + bias[col + 1];
    if (epi != kEpiBias && fast) {
      // one sigmoid shared by the fast GELU and its derivative
      const float s0 = fast_gelu_sigmoid(v0), s1 = fast_gelu_sigmoid(v1);
      if (epi == kEpiGeluGrad)
        *reinterpret_cast<float2*>(out2 + o) =
            make_float2(s0 * (1.0f + kFastGeluC * v0 * (1.0f - s0)),
                        s1 * (1.0f + kFastGeluC * v1 * (1.0f - s1)));
      v0 *= s0;
      v1 *= s1;
    } else if (epi == kEpiGeluGrad) {
      // one erf shared by the GELU and its derivative (_act_fwd_bwd)
      const float e0 = erff(v0 * kInvSqrt2), e1 = erff(v1 * kInvSqrt2);
      *reinterpret_cast<float2*>(out2 + o) = make_float2(
          0.5f * (1.0f + e0) + v0 * kInvSqrt2Pi * expf(-0.5f * v0 * v0),
          0.5f * (1.0f + e1) + v1 * kInvSqrt2Pi * expf(-0.5f * v1 * v1));
      v0 = 0.5f * v0 * (1.0f + e0);
      v1 = 0.5f * v1 * (1.0f + e1);
    } else if (epi == kEpiGelu) {
      v0 = 0.5f * v0 * (1.0f + erff(v0 * kInvSqrt2));
      v1 = 0.5f * v1 * (1.0f + erff(v1 * kInvSqrt2));
    }
    *reinterpret_cast<__nv_bfloat162*>(out + o) = __floats2bfloat162_rn(v0, v1);
  }
}

// out[T, Nout] = epi(LN(x)[T, K] @ W^T + bias) (see LnGemmEpi); with y_out
// set, the blocks of the first column group also write y = bf16(LN(x)).
// The block's 64-row panel of LN(x) stays resident in shared memory: K up
// to 1344 fits (ln_gemm_stream_kernel takes any K).
__global__ void __launch_bounds__(kThreads)
ln_gemm_kernel(const bf16* __restrict__ x, const float* __restrict__ ln_scale,
               const float* __restrict__ ln_bias, const bf16* __restrict__ w,
               const float* __restrict__ bias, bf16* __restrict__ out,
               float* __restrict__ out2, bf16* __restrict__ y_out, int T, int K,
               int Nout, int epi, int fast) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ALD = K + kPadH;
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + BM * ALD;
  float* Cs = reinterpret_cast<float*>(Bs + BN * BLD);

  const int row0 = blockIdx.x * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4;

  // prologue 1: the raw row panel into shared memory (rows past T are zero)
  const int kVec = K / 8;
  for (int i = threadIdx.x; i < BM * kVec; i += kThreads) {
    const int r = i / kVec, c = i % kVec;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (row0 + r < T) v = *reinterpret_cast<const uint4*>(x + (size_t)(row0 + r) * K + c * 8);
    *reinterpret_cast<uint4*>(As + r * ALD + c * 8) = v;
  }
  __syncthreads();

  // prologue 2: fp32 LayerNorm in place, one warp per row, two-pass variance
  for (int r = warp; r < BM; r += kThreads / 32) {
    bf16* row = As + r * ALD;
    float s = 0.f;
    for (int c = lane; c < K; c += 32) s += __bfloat162float(row[c]);
    const float mu = warp_sum(s) / K;
    float q = 0.f;
    for (int c = lane; c < K; c += 32) {
      const float d = __bfloat162float(row[c]) - mu;
      q += d * d;
    }
    const float inv = rsqrtf(warp_sum(q) / K + kLnEps);
    for (int c = lane; c < K; c += 32) {
      const float xhat = (__bfloat162float(row[c]) - mu) * inv;
      row[c] = __float2bfloat16(xhat * ln_scale[c] + ln_bias[c]);
    }
  }

  if (y_out != nullptr && blockIdx.y == 0) {
    __syncthreads();
    for (int i = threadIdx.x; i < BM * kVec; i += kThreads) {
      const int r = i / kVec, c = i % kVec;
      if (row0 + r < T)
        *reinterpret_cast<uint4*>(y_out + (size_t)(row0 + r) * K + c * 8) =
            *reinterpret_cast<const uint4*>(As + r * ALD + c * 8);
    }
  }

  const int ntiles = (Nout + BN - 1) / BN;
  const int t_end = min(ntiles, (int)(blockIdx.y + 1) * kTilesPerBlock);
  for (int t = blockIdx.y * kTilesPerBlock; t < t_end; ++t) {
    const int n0 = t * BN;
    FragC acc[2][2];
    zero_acc(acc);
    for (int k0 = 0; k0 < K; k0 += BK) {
      __syncthreads();  // LN done / previous chunk consumed
      load_w_tile(Bs, w, n0, k0, K, Nout);
      __syncthreads();
      mma_chunk(acc, As + k0, ALD, Bs, wm, wn);
    }
    store_acc(Cs, acc, wm, wn);
    __syncthreads();
    ln_gemm_epilogue(Cs, bias, out, out2, row0, n0, T, Nout, epi, fast);
  }
}

// Row statistics of the streamed kernel: each warp stages kStatCols columns
// of its row (one 16-byte load a lane) and sums them lane-strided, so every
// lane adds the same elements in the same order as ln_gemm_kernel's lanes.
constexpr int kStatCols = 32 * 8;

// The LN-prologue GEMM at any depth K % 64 == 0 (D past the resident
// panel's 1344: the MLP half-block's W1 products at D 1408-4096). Same
// function, epilogues and bits as ln_gemm_kernel; shared memory ~61 KB
// whatever K. A block of 64 rows runs two passes:
//   1. one warp per row reads the row from device memory (16-byte loads,
//      staged per warp) and keeps mean and rstd: lane-strided sums, warp_sum,
//      two-pass variance, eps 1e-6, as the panel kernel;
//   2. for each of its column tiles and each 64-deep chunk it loads the x
//      chunk, normalises it in fp32 and rounds it to bf16 into the A tile
//      (the panel kernel's rounding), then loads the W tile and runs
//      mma_chunk. The blocks of column group 0 write y = bf16(LN(x)) chunk
//      by chunk on their first tile.
// The normalised chunk is recomputed for each column tile (up to
// kTilesPerBlock times); copies are synchronous, as in the other kernels.
__global__ void __launch_bounds__(kThreads)
ln_gemm_stream_kernel(const bf16* __restrict__ x, const float* __restrict__ ln_scale,
                      const float* __restrict__ ln_bias, const bf16* __restrict__ w,
                      const float* __restrict__ bias, bf16* __restrict__ out,
                      float* __restrict__ out2, bf16* __restrict__ y_out, int T, int K,
                      int Nout, int epi, int fast) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + BM * BLD;
  float* Cs = reinterpret_cast<float*>(Bs + BN * BLD);
  float* mean = Cs + BM * CLD;
  float* rstd = mean + BM;

  const int row0 = blockIdx.x * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4;

  // pass 1: row statistics; Cs is free until the first tile's epilogue
  bf16* stage = reinterpret_cast<bf16*>(Cs) + warp * kStatCols;
  for (int r = warp; r < BM; r += kThreads / 32) {
    const int row = row0 + r;
    if (row >= T) {  // rows past T are zero in the A tile and never stored
      if (lane == 0) mean[r] = rstd[r] = 0.f;
      continue;
    }
    const bf16* xr = x + (size_t)row * K;
    float s = 0.f;
    for (int c0 = 0; c0 < K; c0 += kStatCols) {
      const int n = min(kStatCols, K - c0);
      if (8 * lane < n)
        *reinterpret_cast<uint4*>(stage + 8 * lane) =
            *reinterpret_cast<const uint4*>(xr + c0 + 8 * lane);
      __syncwarp();
      for (int c = lane; c < n; c += 32) s += __bfloat162float(stage[c]);
      __syncwarp();
    }
    const float mu = warp_sum(s) / K;
    float q = 0.f;
    for (int c0 = 0; c0 < K; c0 += kStatCols) {
      const int n = min(kStatCols, K - c0);
      if (8 * lane < n)
        *reinterpret_cast<uint4*>(stage + 8 * lane) =
            *reinterpret_cast<const uint4*>(xr + c0 + 8 * lane);
      __syncwarp();
      for (int c = lane; c < n; c += 32) {
        const float d = __bfloat162float(stage[c]) - mu;
        q += d * d;
      }
      __syncwarp();
    }
    const float inv = rsqrtf(warp_sum(q) / K + kLnEps);
    if (lane == 0) {
      mean[r] = mu;
      rstd[r] = inv;
    }
  }

  // pass 2: the column tiles, the normalised x chunk streamed into As
  constexpr int kVec = BK / 8;
  const int ntiles = (Nout + BN - 1) / BN;
  const int t_begin = blockIdx.y * kTilesPerBlock;
  const int t_end = min(ntiles, t_begin + kTilesPerBlock);
  for (int t = t_begin; t < t_end; ++t) {
    const int n0 = t * BN;
    const bool write_y = y_out != nullptr && t == 0;
    FragC acc[2][2];
    zero_acc(acc);
    for (int k0 = 0; k0 < K; k0 += BK) {
      __syncthreads();  // statistics done / previous chunk consumed
      for (int i = threadIdx.x; i < BM * kVec; i += kThreads) {
        const int r = i / kVec, c = (i % kVec) * 8;
        const int row = row0 + r;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (row < T) {
          const uint4 raw = *reinterpret_cast<const uint4*>(x + (size_t)row * K + k0 + c);
          const bf16* xv = reinterpret_cast<const bf16*>(&raw);
          bf16* yv = reinterpret_cast<bf16*>(&v);
          const float mu = mean[r], inv = rstd[r];
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float xhat = (__bfloat162float(xv[e]) - mu) * inv;
            yv[e] = __float2bfloat16(xhat * ln_scale[k0 + c + e] + ln_bias[k0 + c + e]);
          }
          if (write_y) *reinterpret_cast<uint4*>(y_out + (size_t)row * K + k0 + c) = v;
        }
        *reinterpret_cast<uint4*>(As + r * BLD + c) = v;
      }
      load_w_tile(Bs, w, n0, k0, K, Nout);
      __syncthreads();
      mma_chunk(acc, As, BLD, Bs, wm, wn);
    }
    store_acc(Cs, acc, wm, wn);
    __syncthreads();
    ln_gemm_epilogue(Cs, bias, out, out2, row0, n0, T, Nout, epi, fast);
  }
}

// out[T, Nout] = bf16(float(res) + (a[T, K] @ W^T + bias))
__global__ void __launch_bounds__(kThreads)
gemm_residual_kernel(const bf16* __restrict__ a, const bf16* __restrict__ w,
                     const float* __restrict__ bias, const bf16* __restrict__ res,
                     bf16* __restrict__ out, int T, int K, int Nout) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + BM * BLD;
  float* Cs = reinterpret_cast<float*>(Bs + BN * BLD);

  const int row0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  gemm_tile(Cs, As, Bs, a, w, K, row0, n0, T, K, Nout);
  for (int i = threadIdx.x; i < BM * BN / 2; i += kThreads) {
    const int r = i / (BN / 2), c = 2 * (i % (BN / 2));
    const int row = row0 + r, col = n0 + c;
    if (row >= T || col >= Nout) continue;
    const __nv_bfloat162 x2 =
        *reinterpret_cast<const __nv_bfloat162*>(res + (size_t)row * Nout + col);
    const float v0 = __low2float(x2) + (Cs[r * CLD + c] + bias[col]);
    const float v1 = __high2float(x2) + (Cs[r * CLD + c + 1] + bias[col + 1]);
    *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * Nout + col) =
        __floats2bfloat162_rn(v0, v1);
  }
}

// The F-chunked MLP's second product over one hidden chunk: sum[T, Nout] =
// a[T, K] @ W^T with W the (Nout, K) column chunk of nn.Linear's (Nout, F)
// weight (row stride ldw = F, read in place), in fp32, then the PartialEpi
// epilogue EPI against the running fp32 sum acc (T, Nout).
template <int EPI>
__global__ void __launch_bounds__(kThreads)
gemm_partial_kernel(const bf16* __restrict__ a, const bf16* __restrict__ w, int ldw,
                    float* __restrict__ acc, const float* __restrict__ bias,
                    const bf16* __restrict__ res, bf16* __restrict__ out, int T, int K,
                    int Nout) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + BM * BLD;
  float* Cs = reinterpret_cast<float*>(Bs + BN * BLD);

  const int row0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  gemm_tile(Cs, As, Bs, a, w, ldw, row0, n0, T, K, Nout);
  for (int i = threadIdx.x; i < BM * BN / 2; i += kThreads) {
    const int r = i / (BN / 2), c = 2 * (i % (BN / 2));
    const int row = row0 + r, col = n0 + c;
    if (row >= T || col >= Nout) continue;
    const size_t o = (size_t)row * Nout + col;
    const float s0 = Cs[r * CLD + c], s1 = Cs[r * CLD + c + 1];
    float2* dst = reinterpret_cast<float2*>(acc + o);
    if constexpr (EPI == kPartStore) {
      *dst = make_float2(s0, s1);
    } else if constexpr (EPI == kPartAdd) {
      const float2 p = *dst;
      *dst = make_float2(p.x + s0, p.y + s1);
    } else {
      const float2 p = *dst;
      const __nv_bfloat162 x2 = *reinterpret_cast<const __nv_bfloat162*>(res + o);
      const float v0 = (__low2float(x2) + (p.x + s0)) + bias[col];
      const float v1 = (__high2float(x2) + (p.y + s1)) + bias[col + 1];
      *reinterpret_cast<__nv_bfloat162*>(out + o) = __floats2bfloat162_rn(v0, v1);
    }
  }
}

template <int EPI>
cudaError_t launch_partial(const void* a, const void* w, int ldw, void* acc, const void* bias,
                           const void* res, void* out, int T, int K, int Nout,
                           cudaStream_t stream) {
  const size_t smem = (size_t)(BM + BN) * BLD * sizeof(bf16) + (size_t)BM * CLD * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(gemm_partial_kernel<EPI>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((T + BM - 1) / BM, (Nout + BN - 1) / BN);
  gemm_partial_kernel<EPI><<<grid, kThreads, smem, stream>>>(
      (const bf16*)a, (const bf16*)w, ldw, (float*)acc, (const float*)bias, (const bf16*)res,
      (bf16*)out, T, K, Nout);
  return cudaGetLastError();
}

constexpr size_t kMaxSmem = 232448;  // a block's shared memory on the H100

size_t ln_gemm_panel_smem(int K) {
  return (size_t)BM * (K + kPadH) * sizeof(bf16) + (size_t)BN * BLD * sizeof(bf16) +
         (size_t)BM * CLD * sizeof(float);
}

// The panel kernel where its resident panel fits a block (K <= 1344), else
// (or with `streamed`) the streamed kernel; one grid for both.
cudaError_t launch_ln_gemm(bool streamed, const void* x, const void* ln_scale,
                           const void* ln_bias, const void* w, const void* bias, void* out,
                           void* out2, void* y_out, int T, int K, int Nout, int epi, int fast,
                           cudaStream_t stream) {
  if (K % BK != 0) return cudaErrorInvalidValue;
  size_t smem = ln_gemm_panel_smem(K);
  auto kernel = ln_gemm_kernel;
  if (streamed || smem > kMaxSmem) {
    kernel = ln_gemm_stream_kernel;
    smem = (size_t)(BM + BN) * BLD * sizeof(bf16) + (size_t)BM * (CLD + 2) * sizeof(float);
  }
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const int ntiles = (Nout + BN - 1) / BN;
  dim3 grid((T + BM - 1) / BM, (ntiles + kTilesPerBlock - 1) / kTilesPerBlock);
  kernel<<<grid, kThreads, smem, stream>>>(
      (const bf16*)x, (const float*)ln_scale, (const float*)ln_bias, (const bf16*)w,
      (const float*)bias, (bf16*)out, (float*)out2, (bf16*)y_out, T, K, Nout, epi, fast);
  return cudaGetLastError();
}

}  // namespace
}  // namespace ddm

using ddm::bf16;

// One hidden chunk of the F-chunked MLP forward (K6f's second product):
// epi 0 acc = a . w^T, epi 1 acc += a . w^T, epi 2 out = bf16((res + (acc +
// a . w^T)) + bias); a (T, K) bf16, w (Nout, K) bf16 with row stride ldw,
// acc (T, Nout) fp32, res and out (T, Nout) bf16, bias (Nout,) fp32.
extern "C" int ddm_gemm_partial(const void* a, const void* w, int ldw, void* acc,
                                const void* bias, const void* res, void* out, int T, int K,
                                int Nout, int epi, void* stream) {
  using namespace ddm;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (epi) {
    case kPartStore:
      return (int)launch_partial<kPartStore>(a, w, ldw, acc, bias, res, out, T, K, Nout, st);
    case kPartAdd:
      return (int)launch_partial<kPartAdd>(a, w, ldw, acc, bias, res, out, T, K, Nout, st);
    case kPartFinalRes:
      return (int)launch_partial<kPartFinalRes>(a, w, ldw, acc, bias, res, out, T, K, Nout, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// out = epi(LN(x) w^T + bias); with `fast` the GELU epilogues take the
// sigmoid GELU. K up to 1344 runs the resident-panel kernel, any deeper K %
// 64 == 0 the streamed one.
extern "C" int ddm_ln_gemm(const void* x, const void* ln_scale, const void* ln_bias,
                           const void* w, const void* bias, void* out, void* out2,
                           void* y_out, int T, int K, int Nout, int epi, int fast,
                           void* stream) {
  return (int)ddm::launch_ln_gemm(false, x, ln_scale, ln_bias, w, bias, out, out2, y_out, T, K,
                                  Nout, epi, fast, (cudaStream_t)stream);
}

// ddm_ln_gemm through the streamed kernel at any K % 64 == 0: the card
// tests hold it to the panel kernel's bits where both take K.
extern "C" int ddm_ln_gemm_streamed(const void* x, const void* ln_scale, const void* ln_bias,
                                    const void* w, const void* bias, void* out, void* out2,
                                    void* y_out, int T, int K, int Nout, int epi, int fast,
                                    void* stream) {
  return (int)ddm::launch_ln_gemm(true, x, ln_scale, ln_bias, w, bias, out, out2, y_out, T, K,
                                  Nout, epi, fast, (cudaStream_t)stream);
}

extern "C" int ddm_gemm_residual(const void* a, const void* w, const void* bias,
                                 const void* res, void* out, int T, int K, int Nout,
                                 void* stream) {
  using namespace ddm;
  const size_t smem = (size_t)(BM + BN) * BLD * sizeof(bf16) + (size_t)BM * CLD * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(gemm_residual_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + BM - 1) / BM, (Nout + BN - 1) / BN);
  gemm_residual_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const bf16*)a, (const bf16*)w, (const float*)bias, (const bf16*)res, (bf16*)out, T,
      K, Nout);
  return (int)cudaGetLastError();
}

extern "C" const char* ddm_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}
