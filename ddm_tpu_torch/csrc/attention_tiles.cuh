// The attention cores' tile helpers (sm_90a), shared by csrc/attention.cu
// (K2's, K4's and K7's cores and their X3 ablation instances) and
// csrc/phase_softmax.cu (X1's head-batched cores), so that every core runs
// the same 16 x 16 WMMA tiles over the same depth slices in the same order,
// the same row softmax and the same dS rows: where two cores compute one
// output they agree bit for bit. Blocks of kThreads (4 warps); shared tiles
// padded as common.cuh says.
#pragma once

#include <algorithm>
#include <type_traits>

#include "common.cuh"

namespace ddm {
namespace {

constexpr int kThreads = 128;  // 4 warps
constexpr size_t kMaxSmem = 232448;
constexpr int kChunk = 64;            // the streamed design's column chunk
constexpr int kOneBlockMaxTokens = 128;  // one backward block per (image, head) at most

// A head's width in shared memory: Dh up to the next whole fragment.
__host__ __device__ __forceinline__ int padded(int Dh) {
  return (Dh + kFrag - 1) / kFrag * kFrag;
}

// q, k and v of (B, N, H*Dh) rows of stride ld, heads contiguous: the thirds
// of a (B, N, 3D) [q | k | v] buffer (ld = 3D), or three tensors.
struct Heads {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  int ld;
  __device__ const bf16* row(const bf16* t, int b, int N, int r, int h, int Dh) const {
    return t + ((size_t)b * N + r) * ld + h * Dh;
  }
};

// dq, dk and dv, rows of stride ld.
struct DHeads {
  bf16* q;
  bf16* k;
  bf16* v;
  int ld;
  __device__ bf16* row(bf16* t, int b, int N, int r, int h, int Dh) const {
    return t + ((size_t)b * N + r) * ld + h * Dh;
  }
};

// C (M x Nc fp32, ldc) = op(A) op(B) over depth K, one 16 x 16 tile per
// warp at a time, each tile's products in increasing k: op(A) is the
// row-major A (lda) or, with A_T, the transpose of a row-major (K x M) A;
// op(B) the row-major (K x Nc) B (ldb) or, with B_T, the transpose of a
// row-major (Nc x K) B. With ACC a tile starts from C's values.
template <bool A_T, bool B_T, bool ACC>
__device__ void mma_tiles(const bf16* A, int lda, const bf16* B, int ldb, float* C, int ldc,
                          int M, int Nc, int K) {
  const int warp = threadIdx.x / 32, nwarps = kThreads / 32, nt = Nc / kFrag;
  for (int t = warp; t < (M / kFrag) * nt; t += nwarps) {
    const int ti = t / nt, tj = t % nt;
    float* c = C + ti * kFrag * ldc + tj * kFrag;
    FragC acc;
    if (ACC)
      wmma::load_matrix_sync(acc, c, ldc, wmma::mem_row_major);
    else
      wmma::fill_fragment(acc, 0.0f);
    for (int kk = 0; kk < K; kk += kFrag) {
      typename std::conditional<A_T, FragACol, FragA>::type a;
      typename std::conditional<B_T, FragBCol, FragBRow>::type bm;
      wmma::load_matrix_sync(a, A_T ? A + kk * lda + ti * kFrag : A + ti * kFrag * lda + kk, lda);
      wmma::load_matrix_sync(bm, B_T ? B + tj * kFrag * ldb + kk : B + kk * ldb + tj * kFrag,
                             ldb);
      wmma::mma_sync(acc, a, bm, acc);
    }
    wmma::store_matrix_sync(c, acc, ldc, wmma::mem_row_major);
  }
}

// The depth slices after the first of a product taken in chunks go on from
// the fp32 tile stored after the previous chunk.
template <bool A_T, bool B_T>
__device__ __forceinline__ void mma_tiles_from(bool acc, const bf16* A, int lda, const bf16* B,
                                               int ldb, float* C, int ldc, int M, int Nc, int K) {
  if (acc)
    mma_tiles<A_T, B_T, true>(A, lda, B, ldb, C, ldc, M, Nc, K);
  else
    mma_tiles<A_T, B_T, false>(A, lda, B, ldb, C, ldc, M, Nc, K);
}

// Columns [c0, c0 + w) of rows x Dh bf16 values (row stride src_ld) into a
// shared tile of stride ld; columns at or past Dh are zeros (the padding).
__device__ __forceinline__ void load_cols(bf16* dst, int ld, const bf16* __restrict__ src,
                                          int src_ld, int rows, int c0, int w, int Dh) {
  const int vec = w / 8;
  for (int i = threadIdx.x; i < rows * vec; i += kThreads) {
    const int r = i / vec, c = (i % vec) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (c0 + c < Dh) v = *reinterpret_cast<const uint4*>(src + (size_t)r * src_ld + c0 + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = v;
  }
}

// A whole head: each row followed by zeros up to padded(Dh) columns.
__device__ __forceinline__ void load_head(bf16* dst, int ld, const bf16* __restrict__ src,
                                          int src_ld, int rows, int Dh) {
  load_cols(dst, ld, src, src_ld, rows, 0, padded(Dh), Dh);
}

// Write a (rows x Dh) fp32 tile as bf16 into the rows of a row-major matrix
// with ld columns.
__device__ __forceinline__ void store_head(bf16* __restrict__ dst, int ld, const float* src,
                                           int sld, int rows, int Dh) {
  for (int i = threadIdx.x; i < rows * Dh / 2; i += kThreads) {
    const int r = i / (Dh / 2), c = 2 * (i % (Dh / 2));
    *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)r * ld + c) =
        __floats2bfloat162_rn(src[r * sld + c], src[r * sld + c + 1]);
  }
}

// Row softmax on rows of fp32 scores S (stride sld): p = exp(s * scale -
// max) / sum, bf16(p) into Pb; with keep, p kept in S; with stats, each
// row's (max, sum) saved at stats[3 r], stats[3 r + 1].
__device__ void softmax_rows(float* S, int sld, bf16* Pb, int pld, int rows, int N, float scale,
                             bool keep, float* stats) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, nwarps = kThreads / 32;
  for (int r = warp; r < rows; r += nwarps) {
    float* srow = S + r * sld;
    float m = -INFINITY;
    for (int c = lane; c < N; c += 32) m = fmaxf(m, srow[c] * scale);
    m = warp_max(m);
    float sum = 0.f;
    for (int c = lane; c < N; c += 32) {
      const float e = expf(srow[c] * scale - m);
      srow[c] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int c = lane; c < N; c += 32) {
      const float p = srow[c] / sum;
      if (keep) srow[c] = p;
      Pb[r * pld + c] = __float2bfloat16(p);
    }
    if (stats != nullptr && lane == 0) {
      stats[3 * r] = m;
      stats[3 * r + 1] = sum;
    }
  }
}

// dS = bf16(scale * P * (dP - rowsum(P * dP))) into Pb, over rows of the
// fp32 P and dP (stride sld); with stats, rowsum(P * dP) saved at
// stats[3 r + 2].
__device__ void ds_rows(const float* P, const float* dP, int sld, bf16* Pb, int pld, int rows,
                        int N, float scale, float* stats) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, nwarps = kThreads / 32;
  for (int r = warp; r < rows; r += nwarps) {
    const float* prow = P + r * sld;
    const float* drow = dP + r * sld;
    float s = 0.f;
    for (int c = lane; c < N; c += 32) s += prow[c] * drow[c];
    s = warp_sum(s);
    for (int c = lane; c < N; c += 32)
      Pb[r * pld + c] = __float2bfloat16(prow[c] * (drow[c] - s) * scale);
    if (stats != nullptr && lane == 0) stats[3 * r + 2] = s;
  }
}

cudaError_t set_smem(const void* kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// Launch `kernel` (an instance of a core kernel) with `smem` bytes of
// dynamic shared memory.
template <typename... Params, typename... Args>
cudaError_t launch(void (*kernel)(Params...), dim3 grid, size_t smem, cudaStream_t s,
                   Args... args) {
  cudaError_t err = set_smem((const void*)kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, s>>>(args...);
  return cudaGetLastError();
}

}  // namespace
}  // namespace ddm
