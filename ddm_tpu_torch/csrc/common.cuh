// Shared pieces of the DiT half-block kernels (sm_90a).
//
// The matrix products use WMMA bf16 fragments (16x16x16) with fp32
// accumulators, loaded from padded shared-memory tiles. Shared tiles pad
// each row by 8 bf16 (16 bytes) or 4 fp32 so that every 16-row fragment
// starts on a 32-byte boundary and rows fall on different banks.
#pragma once

#include <cmath>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace ddm {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int kFrag = 16;    // WMMA tile edge
constexpr int kPadH = 8;     // bf16 row padding of shared tiles
constexpr int kPadF = 4;     // fp32 row padding of shared tiles

using FragA = wmma::fragment<wmma::matrix_a, kFrag, kFrag, kFrag, bf16, wmma::row_major>;
// A^T read from a row-major tile: element (m, k) at ptr[m + k * ld]
using FragACol = wmma::fragment<wmma::matrix_a, kFrag, kFrag, kFrag, bf16, wmma::col_major>;
using FragBCol = wmma::fragment<wmma::matrix_b, kFrag, kFrag, kFrag, bf16, wmma::col_major>;
using FragBRow = wmma::fragment<wmma::matrix_b, kFrag, kFrag, kFrag, bf16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, kFrag, kFrag, kFrag, float>;

// The fast GELU of the JAX package's DDM_TPU_FAST_GELU (ddm_tpu/ops/
// mlp_block.py `_act`, `_act_fwd_bwd`): g = h s and g' = s (1 + c h (1 - s))
// with one sigmoid s = sigmoid(c h), c = 1.702, shared by the two. The GELU
// epilogues take it where their `fast` launch parameter is set, in place of
// the exact erf.
constexpr float kFastGeluC = 1.702f;

__device__ __forceinline__ float fast_gelu_sigmoid(float h) {
  return 1.0f / (1.0f + expf(-kFastGeluC * h));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

namespace {

// out[n] = sum over s = 0 .. S-1 of ws[s * N + n], in a fixed order: row
// group g of the block sums s = g, g + 8, ..., then the groups add in order.
// blockIdx.y is a batch index: ws advances by S*N, out by N. The second
// pass of every cross-block sum (split-K weight gradients, per-block and
// per-group partials): no atomics, so the same inputs give the same bits.
constexpr int kRedCols = 32, kRedGroups = 8;

__global__ void __launch_bounds__(kRedCols * kRedGroups)
reduce_rows_kernel(const float* __restrict__ ws, float* __restrict__ out, int S, int N) {
  __shared__ float part[kRedGroups][kRedCols];
  ws += (size_t)blockIdx.y * S * N;
  out += (size_t)blockIdx.y * N;
  const int c = threadIdx.x % kRedCols, g = threadIdx.x / kRedCols;
  const size_t n = (size_t)blockIdx.x * kRedCols + c;
  float s = 0.f;
  if (n < (size_t)N)
    for (int r = g; r < S; r += kRedGroups) s += ws[(size_t)r * N + n];
  part[g][c] = s;
  __syncthreads();
  if (g == 0 && n < (size_t)N) {
    float t = part[0][c];
    for (int k = 1; k < kRedGroups; ++k) t += part[k][c];
    out[n] = t;
  }
}

cudaError_t reduce_rows(const float* ws, float* out, int S, int N, cudaStream_t stream,
                        int batch = 1) {
  dim3 grid((N + kRedCols - 1) / kRedCols, batch);
  reduce_rows_kernel<<<grid, kRedCols * kRedGroups, 0, stream>>>(ws, out, S, N);
  return cudaGetLastError();
}

}  // namespace

}  // namespace ddm
