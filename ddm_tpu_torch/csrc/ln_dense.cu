// The DiT tail, final LayerNorm + unembed projection in one pass:
//   out[T, K] = f32(bf16(bf16(LN(x)) . W) + bf16(b)),  W (D, K), K = p*p*C.
//
// Replaces the fused tail of tools/exp_ln_dense.patch (X4):
//   * `_ln_dense_fwd_kernel` (patch line 49), X4f: ddm_ln_dense_fwd;
//   * `_ln_dense_bwd_kernel` (patch line 58), X4b: ddm_ln_dense_bwd.
// Numerics are the patch's, which are flax's `LayerNorm(f32) -> astype(bf16)
// -> Dense(bf16) -> astype(f32)`: LN statistics in fp32 with eps 1e-6, y
// rounded to bf16, y . W accumulated in fp32 and rounded to bf16, b rounded
// to bf16 and added in bf16, the sum stored as fp32. The row statistics
// follow ln_gemm's prologue (gemm.cu): one warp a row, lane l summing the
// elements l, l + 32, ... in order, warp_sum, a two-pass variance, so y
// holds the bits the LN-prologue GEMMs give it.
//
// The backward follows `_ln_dense_bwd_kernel`: dO (fp32) is rounded to bf16
// for the two products, dW = y^T . bf16(dO) and dy = bf16(dO) . W^T, both
// accumulated in fp32 and never rounded; db sums the fp32 dO; dscale and
// dbias sum dy * xhat and dy; dx = bf16(inv (dxhat - mean(dxhat) - xhat
// mean(dxhat xhat))), dxhat = dy * scale. The TPU kernel accumulated dW,
// db, dscale and dbias across its sequential grid; CUDA blocks run at once,
// so each row range writes fixed-order partials and reduce_rows
// (common.cuh) sums them in a fixed order: no atomics, and a second call
// gives the same bits.
//
// What bounds it on the H100: at the DiT-S/4 training shape (T = 131,072
// rows, D = 384, K = 48) the forward is 4.8 GFLOP against 100.7 MB of x
// read and 25.2 MB of fp32 output written, so it is bound by bytes, far
// below the ridge; the backward reads x and dO and writes dx. The design
// keeps every intermediate (the LN output, dy, the bf16 dO) on chip:
//   * X4f: one block per 64 rows and 64 output columns; the row statistics,
//     then the depth in 64-column chunks, each x chunk normalised and
//     rounded in shared memory beside its W chunk (any D % 128 == 0: no
//     resident panel), WMMA bf16 fragments with fp32 accumulators;
//   * X4b, three launches: (1) per 64 rows, the statistics (kept for (2)),
//     the bf16 dO tile and db's partial, then two passes over the depth
//     chunks, each recomputing dy = bf16(dO) . W^T for the chunk: pass A
//     sums the rows' mean(dxhat) and mean(dxhat xhat) and writes dscale's
//     and dbias's column partials, pass B writes dx; (2) dW as split-K over
//     fixed row ranges, y recomputed from the saved statistics, one block
//     per (64 rows of W, 64 columns, range); (3) the fixed-order sums.
// x is read about four times per backward (mostly from L2) and the tiles
// are loaded synchronously; wgmma, TMA and a pipelined copy are later work.
#include "common.cuh"

namespace ddm {
namespace {

constexpr int BM = 64;          // rows of x per block
constexpr int BK = 64;          // depth (D) chunk
constexpr int BN = 64;          // output columns per block (X4f) / dW tile
constexpr int kThreads = 128;   // 4 warps, 16 rows (X4f, X4b rows) or W rows (dW) each
constexpr int kWarps = kThreads / 32;
constexpr int kNF = BN / kFrag;  // fragments a warp holds across its 64 columns
constexpr int XLD = BK + kPadH;  // bf16 tiles of 64 columns
constexpr int FLD = BK + kPadF;  // fp32 tiles of 64 columns
constexpr float kLnEps = 1e-6f;
constexpr size_t kMaxSmem = 232448;  // a block's shared memory on the H100
constexpr int kMaxK = 512;

__host__ __device__ __forceinline__ int round16(int n) { return (n + kFrag - 1) / kFrag * kFrag; }

// mean and rstd of rows [row0, row0 + BM) of x (T x D), one warp a row, in
// ln_gemm's order; rows past T get zeros.
__device__ __forceinline__ void row_stats(const bf16* __restrict__ x, int T, int D, int row0,
                                          float* mean, float* rstd) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < BM; r += kWarps) {
    const int row = row0 + r;
    if (row >= T) {
      if (lane == 0) mean[r] = rstd[r] = 0.f;
      continue;
    }
    const bf16* xr = x + (size_t)row * D;
    float s = 0.f;
    for (int c = lane; c < D; c += 32) s += __bfloat162float(xr[c]);
    const float mu = warp_sum(s) / D;
    float q = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float d = __bfloat162float(xr[c]) - mu;
      q += d * d;
    }
    const float inv = rsqrtf(warp_sum(q) / D + kLnEps);
    if (lane == 0) {
      mean[r] = mu;
      rstd[r] = inv;
    }
  }
}

// The 64-column chunk [k0, k0 + 64) of y = bf16(LN(x)) for rows [row0, row0
// + BM) into Ys (bf16, stride XLD), rows at or past t_end zero; with Xh,
// also xhat in fp32 (stride FLD). Without Ys, ln_scale and ln_bias are not read.
__device__ __forceinline__ void load_y_chunk(bf16* Ys, float* Xh, const bf16* __restrict__ x,
                                             const float* __restrict__ ln_scale,
                                             const float* __restrict__ ln_bias, const float* mean,
                                             const float* rstd, int row0, int t_end, int D,
                                             int k0) {
  constexpr int kVec = BK / 8;
  for (int i = threadIdx.x; i < BM * kVec; i += kThreads) {
    const int r = i / kVec, c = (i % kVec) * 8;
    const int row = row0 + r;
    uint4 v = make_uint4(0, 0, 0, 0);
    float xh[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (row < t_end) {
      const uint4 raw = *reinterpret_cast<const uint4*>(x + (size_t)row * D + k0 + c);
      const bf16* xv = reinterpret_cast<const bf16*>(&raw);
      bf16* yv = reinterpret_cast<bf16*>(&v);
      const float mu = mean[r], inv = rstd[r];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float xhat = (__bfloat162float(xv[e]) - mu) * inv;
        xh[e] = xhat;
        if (Ys != nullptr)
          yv[e] = __float2bfloat16(xhat * ln_scale[k0 + c + e] + ln_bias[k0 + c + e]);
      }
    }
    if (Ys != nullptr) *reinterpret_cast<uint4*>(Ys + r * XLD + c) = v;
    if (Xh != nullptr) {
#pragma unroll
      for (int e = 0; e < 8; ++e) Xh[r * FLD + c + e] = xh[e];
    }
  }
}

// Rows [r0, r0 + nrows) x columns [c0, c0 + ncols) of the bf16 matrix w (ld
// columns, `cols` valid) into a shared tile of stride dld; columns past
// `cols` are zero. 16-byte loads where a whole group of 8 is valid and
// aligned, else one element at a time.
__device__ __forceinline__ void load_w(bf16* dst, int dld, const bf16* __restrict__ w, int ld,
                                       int cols, int r0, int nrows, int c0, int ncols) {
  const int vec = ncols / 8;
  const bool aligned = ld % 8 == 0;
  for (int i = threadIdx.x; i < nrows * vec; i += kThreads) {
    const int r = i / vec, c = (i % vec) * 8;
    const bf16* src = w + (size_t)(r0 + r) * ld + c0 + c;
    bf16* out = dst + r * dld + c;
    if (aligned && c0 + c + 8 <= cols) {
      *reinterpret_cast<uint4*>(out) = *reinterpret_cast<const uint4*>(src);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) out[e] = c0 + c + e < cols ? src[e] : __float2bfloat16(0.f);
    }
  }
}

// X4f: block (rows [64 bx, +64), output columns [64 by, +64)).
__global__ void __launch_bounds__(kThreads)
ln_dense_fwd_kernel(const bf16* __restrict__ x, const float* __restrict__ ln_scale,
                    const float* __restrict__ ln_bias, const bf16* __restrict__ w,
                    const float* __restrict__ b, float* __restrict__ out, int T, int D, int K) {
  __shared__ __align__(128) bf16 Ys[BM * XLD];
  __shared__ __align__(128) bf16 Ws[BK * XLD];
  __shared__ __align__(128) float Cs[BM * FLD];
  __shared__ float mean[BM], rstd[BM];

  const int row0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int warp = threadIdx.x / 32;
  const int nf = min(kNF, (K - n0 + kFrag - 1) / kFrag);
  row_stats(x, T, D, row0, mean, rstd);

  FragC acc[kNF];
#pragma unroll
  for (int j = 0; j < kNF; ++j) wmma::fill_fragment(acc[j], 0.0f);
  for (int k0 = 0; k0 < D; k0 += BK) {
    __syncthreads();  // statistics done / previous chunk consumed
    load_y_chunk(Ys, nullptr, x, ln_scale, ln_bias, mean, rstd, row0, T, D, k0);
    load_w(Ws, XLD, w, K, K, k0, BK, n0, BN);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += kFrag) {
      FragA a;
      wmma::load_matrix_sync(a, Ys + warp * kFrag * XLD + kk, XLD);
#pragma unroll
      for (int j = 0; j < kNF; ++j) {
        if (j < nf) {
          FragBRow bm;
          wmma::load_matrix_sync(bm, Ws + kk * XLD + j * kFrag, XLD);
          wmma::mma_sync(acc[j], a, bm, acc[j]);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kNF; ++j)
    wmma::store_matrix_sync(Cs + warp * kFrag * FLD + j * kFrag, acc[j], FLD,
                            wmma::mem_row_major);
  __syncthreads();
  for (int i = threadIdx.x; i < BM * BN; i += kThreads) {
    const int r = i / BN, c = i % BN;
    const int row = row0 + r, col = n0 + c;
    if (row >= T || col >= K) continue;
    const float h = __bfloat162float(__float2bfloat16(Cs[r * FLD + c]));
    const float bb = __bfloat162float(__float2bfloat16(b[col]));
    out[(size_t)row * K + col] = __bfloat162float(__float2bfloat16(h + bb));
  }
}

// X4b's row kernel's shared memory at KP = K rounded up to 16.
size_t bwd_rows_smem(int KP) {
  return (size_t)2 * BM * (KP + kPadH) * sizeof(bf16) + (size_t)2 * BM * FLD * sizeof(float) +
         (size_t)4 * BM * sizeof(float);
}

// dy[BM, 64] (fp32, DY) = bf16(dO)[BM, KP] . W[d0 : d0 + 64, :KP]^T, warp w
// on rows [16 w, 16 w + 16); Ws holds the W rows (64 x KP, stride KP + 8).
__device__ __forceinline__ void dy_chunk(float* DY, const bf16* dOb, const bf16* Ws, int KP) {
  const int warp = threadIdx.x / 32, ld = KP + kPadH;
  FragC acc[kNF];
#pragma unroll
  for (int j = 0; j < kNF; ++j) wmma::fill_fragment(acc[j], 0.0f);
  for (int kk = 0; kk < KP; kk += kFrag) {
    FragA a;
    wmma::load_matrix_sync(a, dOb + warp * kFrag * ld + kk, ld);
#pragma unroll
    for (int j = 0; j < kNF; ++j) {
      FragBCol bm;  // element (k, d) of W^T at Ws[d * ld + k]
      wmma::load_matrix_sync(bm, Ws + j * kFrag * ld + kk, ld);
      wmma::mma_sync(acc[j], a, bm, acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < kNF; ++j)
    wmma::store_matrix_sync(DY + warp * kFrag * FLD + j * kFrag, acc[j], FLD,
                            wmma::mem_row_major);
}

// X4b (1): rows [64 bx, +64): the statistics (into stats, T x 2), db's
// partial (part_db[bx], K), dscale's and dbias's column partials
// (part_ln[bx], 2 x D) and dx.
__global__ void __launch_bounds__(kThreads)
ln_dense_bwd_rows_kernel(const bf16* __restrict__ x, const float* __restrict__ ln_scale,
                         const bf16* __restrict__ w, const float* __restrict__ dout,
                         bf16* __restrict__ dx, float* __restrict__ stats,
                         float* __restrict__ part_ln, float* __restrict__ part_db, int T, int D,
                         int K) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int KP = round16(K), ld = KP + kPadH;
  bf16* dOb = reinterpret_cast<bf16*>(smem);
  bf16* Ws = dOb + BM * ld;
  float* Xh = reinterpret_cast<float*>(Ws + BM * ld);
  float* DY = Xh + BM * FLD;
  float* mean = DY + BM * FLD;
  float* rstd = mean + BM;
  float* m1s = rstd + BM;
  float* m2s = m1s + BM;

  const int row0 = blockIdx.x * BM, rows = min(BM, T - row0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  row_stats(x, T, D, row0, mean, rstd);
  for (int i = threadIdx.x; i < BM * KP; i += kThreads) {
    const int r = i / KP, c = i % KP;
    const float v = r < rows && c < K ? dout[(size_t)(row0 + r) * K + c] : 0.f;
    dOb[r * ld + c] = __float2bfloat16(v);
  }
  for (int c = threadIdx.x; c < K; c += kThreads) {  // db: the fp32 dO, rows in order
    float s = 0.f;
    for (int r = 0; r < rows; ++r) s += dout[(size_t)(row0 + r) * K + c];
    part_db[(size_t)blockIdx.x * K + c] = s;
  }
  __syncthreads();
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    stats[2 * (size_t)(row0 + r)] = mean[r];
    stats[2 * (size_t)(row0 + r) + 1] = rstd[r];
  }

  // pass A: the rows' sums of dxhat and dxhat * xhat, the column partials
  constexpr int kRowsPerWarp = BM / kWarps;
  float m1[kRowsPerWarp], m2[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) m1[i] = m2[i] = 0.f;
  for (int d0 = 0; d0 < D; d0 += BK) {
    __syncthreads();
    load_y_chunk(nullptr, Xh, x, nullptr, nullptr, mean, rstd, row0, T, D, d0);
    load_w(Ws, ld, w, K, K, d0, BK, 0, KP);
    __syncthreads();
    dy_chunk(DY, dOb, Ws, KP);
    __syncthreads();
    if (threadIdx.x < 2 * BK) {  // column c: sum of dy * xhat (first 64 threads) or of dy
      const int c = threadIdx.x % BK;
      const bool with_xhat = threadIdx.x < BK;
      float s = 0.f;
      for (int r = 0; r < rows; ++r)
        s += with_xhat ? DY[r * FLD + c] * Xh[r * FLD + c] : DY[r * FLD + c];
      part_ln[((size_t)blockIdx.x * 2 + (with_xhat ? 0 : 1)) * D + d0 + c] = s;
    }
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp + kWarps * i;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = lane + 32 * h;
        const float g = DY[r * FLD + c] * ln_scale[d0 + c];
        m1[i] += g;
        m2[i] += g * Xh[r * FLD + c];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const float s1 = warp_sum(m1[i]) / D, s2 = warp_sum(m2[i]) / D;
    if (lane == 0) {
      m1s[warp + kWarps * i] = s1;
      m2s[warp + kWarps * i] = s2;
    }
  }

  // pass B: dx, dy recomputed chunk by chunk
  for (int d0 = 0; d0 < D; d0 += BK) {
    __syncthreads();
    load_y_chunk(nullptr, Xh, x, nullptr, nullptr, mean, rstd, row0, T, D, d0);
    load_w(Ws, ld, w, K, K, d0, BK, 0, KP);
    __syncthreads();
    dy_chunk(DY, dOb, Ws, KP);
    __syncthreads();
    for (int i = threadIdx.x; i < rows * BK; i += kThreads) {
      const int r = i / BK, c = i % BK;
      const float g = DY[r * FLD + c] * ln_scale[d0 + c];
      const float v = rstd[r] * (g - m1s[r] - Xh[r * FLD + c] * m2s[r]);
      dx[(size_t)(row0 + r) * D + d0 + c] = __float2bfloat16(v);
    }
  }
}

// X4b (2): block (W rows [64 bx, +64), columns [64 by, +64), row range bz)
// sums y^T . bf16(dO) over rows [bz rows_per, (bz + 1) rows_per) into
// ws[bz] (D x K fp32); y from the saved statistics, as X4f rounds it.
__global__ void __launch_bounds__(kThreads)
ln_dense_bwd_dw_kernel(const bf16* __restrict__ x, const float* __restrict__ ln_scale,
                       const float* __restrict__ ln_bias, const float* __restrict__ stats,
                       const float* __restrict__ dout, float* __restrict__ ws, int T, int D,
                       int K, int rows_per) {
  __shared__ __align__(128) bf16 Ys[BM * XLD];
  __shared__ __align__(128) bf16 Gs[BM * XLD];
  __shared__ __align__(128) float Cs[BK * FLD];
  __shared__ float mean[BM], rstd[BM];

  const int d0 = blockIdx.x * BK, n0 = blockIdx.y * BN, z = blockIdx.z;
  const int t_begin = z * rows_per, t_end = min(T, t_begin + rows_per);
  const int warp = threadIdx.x / 32;
  const int nf = min(kNF, (K - n0 + kFrag - 1) / kFrag);
  FragC acc[kNF];
#pragma unroll
  for (int j = 0; j < kNF; ++j) wmma::fill_fragment(acc[j], 0.0f);
  for (int t0 = t_begin; t0 < t_end; t0 += BM) {
    __syncthreads();
    for (int r = threadIdx.x; r < BM; r += kThreads) {
      const bool in = t0 + r < t_end;
      mean[r] = in ? stats[2 * (size_t)(t0 + r)] : 0.f;
      rstd[r] = in ? stats[2 * (size_t)(t0 + r) + 1] : 0.f;
    }
    for (int i = threadIdx.x; i < BM * BN; i += kThreads) {
      const int r = i / BN, c = i % BN;
      const float v = t0 + r < t_end && n0 + c < K ? dout[(size_t)(t0 + r) * K + n0 + c] : 0.f;
      Gs[r * XLD + c] = __float2bfloat16(v);
    }
    __syncthreads();
    load_y_chunk(Ys, nullptr, x, ln_scale, ln_bias, mean, rstd, t0, t_end, D, d0);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BM; kk += kFrag) {
      FragACol a;  // element (d, t) of y^T at Ys[t * XLD + d]
      wmma::load_matrix_sync(a, Ys + kk * XLD + warp * kFrag, XLD);
#pragma unroll
      for (int j = 0; j < kNF; ++j) {
        if (j < nf) {
          FragBRow bm;
          wmma::load_matrix_sync(bm, Gs + kk * XLD + j * kFrag, XLD);
          wmma::mma_sync(acc[j], a, bm, acc[j]);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kNF; ++j)
    wmma::store_matrix_sync(Cs + warp * kFrag * FLD + j * kFrag, acc[j], FLD,
                            wmma::mem_row_major);
  __syncthreads();
  float* dst = ws + (size_t)z * D * K;
  for (int i = threadIdx.x; i < BK * BN; i += kThreads) {
    const int r = i / BN, c = i % BN;
    if (n0 + c < K) dst[(size_t)(d0 + r) * K + n0 + c] = Cs[r * FLD + c];
  }
}

bool takes(int T, int D, int K) { return T > 0 && D > 0 && D % 128 == 0 && K >= 1 && K <= kMaxK; }

}  // namespace
}  // namespace ddm

using ddm::bf16;

// X4f: out (T, K) fp32 = f32(bf16(bf16(LN(x)) . w) + bf16(b)); x (T, D) bf16,
// ln_scale, ln_bias (D,) fp32, w (D, K) bf16 row-major, b (K,) fp32; any T,
// D % 128 == 0, 1 <= K <= 512.
extern "C" int ddm_ln_dense_fwd(const void* x, const void* ln_scale, const void* ln_bias,
                                const void* w, const void* b, void* out, int T, int D, int K,
                                void* stream) {
  using namespace ddm;
  if (!takes(T, D, K)) return (int)cudaErrorInvalidValue;
  const dim3 grid((T + BM - 1) / BM, (K + BN - 1) / BN);
  ln_dense_fwd_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const bf16*)x, (const float*)ln_scale, (const float*)ln_bias, (const bf16*)w,
      (const float*)b, (float*)out, T, D, K);
  return (int)cudaGetLastError();
}

// X4b: dx (T, D) bf16, dscale_dbias (2, D), dw (D, K) and db (K,) fp32 for
// the fp32 cotangent dout (T, K). Scratch: stats (T, 2), part_ln
// (ceil(T / 64), 2, D), part_db (ceil(T / 64), K), ws (splits, D, K), all
// fp32; `splits` row ranges of `rows_per` rows (a multiple of 64) for dW.
extern "C" int ddm_ln_dense_bwd(const void* x, const void* ln_scale, const void* ln_bias,
                                const void* w, const void* dout, void* dx, void* stats,
                                void* part_ln, void* part_db, void* ws, void* dscale_dbias,
                                void* dw, void* db, int T, int D, int K, int splits,
                                int rows_per, void* stream) {
  using namespace ddm;
  if (!takes(T, D, K) || rows_per % BM != 0 || (long long)splits * rows_per < T)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int nblk = (T + BM - 1) / BM;
  const size_t smem = bwd_rows_smem(round16(K));
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(ln_dense_bwd_rows_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ln_dense_bwd_rows_kernel<<<nblk, kThreads, smem, st>>>(
      (const bf16*)x, (const float*)ln_scale, (const bf16*)w, (const float*)dout, (bf16*)dx,
      (float*)stats, (float*)part_ln, (float*)part_db, T, D, K);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const dim3 grid(D / BK, (K + BN - 1) / BN, splits);
  ln_dense_bwd_dw_kernel<<<grid, kThreads, 0, st>>>(
      (const bf16*)x, (const float*)ln_scale, (const float*)ln_bias, (const float*)stats,
      (const float*)dout, (float*)ws, T, D, K, rows_per);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if ((err = reduce_rows((const float*)part_ln, (float*)dscale_dbias, nblk, 2 * D, st)) !=
      cudaSuccess)
    return (int)err;
  if ((err = reduce_rows((const float*)part_db, (float*)db, nblk, K, st)) != cudaSuccess)
    return (int)err;
  return (int)reduce_rows((const float*)ws, (float*)dw, splits, D * K, st);
}
