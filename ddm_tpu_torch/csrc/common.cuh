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

}  // namespace ddm
