// Register-fragment and copy helpers for the tensor-core kernels (sm_90a):
// mma.sync m16n8k16 (bf16 in, fp32 accumulate), ldmatrix, cp.async. The
// attention forwards in csrc/attention.cu (the "registers" core) and
// csrc/flash.cu (K8f's registers design) are built from them, and so are the
// two backwards (attention_bwd_regs.cuh).
//
// Fragment layouts (PTX ISA, "Matrix Fragments for mma.m16n8k16"): lane l of
// a warp is in row group g = l / 4 with column pair t = l % 4.
// - A (16 x 16, row-major), four 32-bit registers of two bf16 each: a[0]
//   row g, columns 2t and 2t + 1; a[1] row g + 8, the same columns; a[2]
//   row g, columns 2t + 8, 2t + 9; a[3] row g + 8, those columns.
// - B (16 x 8, k x n), two registers: b[0] rows (k) 2t, 2t + 1 of column g;
//   b[1] rows 2t + 8, 2t + 9.
// - C and D (16 x 8, fp32), four floats: c[0], c[1] row g, columns 2t and
//   2t + 1; c[2], c[3] row g + 8, the same columns.
// So the accumulators of two neighbouring 16 x 8 tiles of a product, packed
// to bf16 pairs, are the A fragment of the 16 x 16 tile they make: a score
// tile S becomes the operand P of P V without leaving the registers
// (pack_a below).
//
// Shared tiles hold rows of a padded width DP (a multiple of 16 columns)
// followed by kPadH = 8 bf16: a row is 16 (DP / 8 + 1) bytes, an odd number
// of 16-byte units, so the eight row addresses of every 8 x 8 ldmatrix
// matrix fall on eight different groups of four banks.
#pragma once

#include <cstdint>

#include "common.cuh"

namespace ddm {
namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from device memory into shared memory without passing through
// registers; where !valid, 16 zero bytes (src is not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// 8 bytes likewise, by cp.async.ca (the .cg form moves 16 bytes only): the
// piece of a head that starts on an 8-byte boundary (K8 at Dh 4).
__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 8 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 8 bf16 matrices: lanes 8i .. 8i + 7 give the row addresses of
// matrix i, and lane l receives row l / 4, columns 2 (l % 4) and 2 (l % 4)
// + 1 of matrix i in r[i] (TRANS: column l / 4, rows 2 (l % 4), + 1).
template <bool TRANS>
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  if constexpr (TRANS)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p)));
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p)));
}

// Two 8 x 8 bf16 matrices, row addresses from lanes 0-15, as ldmatrix_x4's
// first two.
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// d += A B over one 16 x 8 x 16 step, fp32 accumulators.
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two fp32 values rounded to a bf16 pair, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment of the 16 x 16 tile whose columns 0-7 are the accumulator
// c0 and 8-15 the accumulator c1, each value rounded to bf16 once.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// 2^x by the card's special-function unit (ex2.approx: two units in the
// last place, denormal results flushed to 0; 2^-inf = 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// log2(e): exp(x) = 2^(x log2 e). The kernels fold it into the softmax scale,
// so that exp(s scale - m) is 2^(s (scale log2 e) - m log2 e): one fused
// multiply-add and one ex2 a score, FlashAttention-2's form, a few fp32 units
// in the last place from expf where bf16(p) keeps 8 bits.
constexpr float kLog2e = 1.4426950408889634f;

// The max and the sum over the four lanes that share a row of a fragment.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// A ROWS x DP bf16 tile (row stride DP + kPadH in shared memory) from rows
// [r0, r0 + ROWS) of a head (row stride ld, Dh columns), by cp.async, all
// THREADS threads of the block, in pieces of PIECE bytes (16, or 8 where a
// head starts on an 8-byte boundary only): rows at or past `rows` and
// columns at or past Dh are zero-filled (a piece is either wholly in the
// head or wholly padding: Dh a multiple of PIECE / 2). Commits nothing.
template <int ROWS, int DP, int THREADS, int PIECE = 16>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* __restrict__ src, size_t ld,
                                                int r0, int rows, int Dh) {
  static_assert(PIECE == 16 || PIECE == 8, "cp.async pieces of 16 or 8 bytes");
  constexpr int kCols = PIECE / 2, kVec = DP / kCols, kLd = DP + kPadH, kPieces = ROWS * kVec;
#pragma unroll
  for (int n = 0; n < (kPieces + THREADS - 1) / THREADS; ++n) {
    const int i = threadIdx.x + n * THREADS, r = i / kVec, c = (i % kVec) * kCols;
    if (kPieces % THREADS == 0 || i < kPieces) {
      const bool valid = r0 + r < rows && c < Dh;
      const bf16* from = valid ? src + (size_t)(r0 + r) * ld + c : src;
      if constexpr (PIECE == 16)
        cp_async16(dst + r * kLd + c, from, valid);
      else
        cp_async8(dst + r * kLd + c, from, valid);
    }
  }
}

// A warp's 16 rows of Q as A fragments, DP / 16 depth steps, from a shared
// tile (row stride DP + kPadH) at its first row.
template <int DP>
__device__ __forceinline__ void load_a_frags(uint32_t (&a)[DP / 16][4], const bf16* tile,
                                             int lane) {
  constexpr int kLd = DP + kPadH;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
    ldmatrix_x4<false>(a[kk], tile + (lane % 16) * kLd + kk * 16 + (lane / 16) * 8);
}

// s[m][j] = rows [16 m, 16 m + 16) of the warp's MT x 16 rows of Q times keys
// [8j, 8j + 8) of a 64-key K tile (shared, row stride DP + kPadH), over the
// depth DP in increasing order; s starts from zero. Each B fragment read
// from shared memory serves the warp's MT row tiles.
template <int DP, int MT>
__device__ __forceinline__ void qk_tile(float (&s)[MT][8][4],
                                        const uint32_t (&qa)[MT][DP / 16][4], const bf16* Ks,
                                        int lane) {
  constexpr int kLd = DP + kPadH;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 8; ++j) s[m][j][0] = s[m][j][1] = s[m][j][2] = s[m][j][3] = 0.f;
  // matrices: keys n0 .. n0 + 7 at depth kk, kk + 8; keys n0 + 8 .. + 15 at both
  const int row = (lane % 8) + (lane / 16) * 8, col = ((lane / 8) % 2) * 8;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      uint32_t b[4];
      ldmatrix_x4<false>(b, Ks + (n * 16 + row) * kLd + kk * 16 + col);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        mma_16816(s[m][2 * n], qa[m][kk], b[0], b[1]);
        mma_16816(s[m][2 * n + 1], qa[m][kk], b[2], b[3]);
      }
    }
  }
}

// o[m][j] += P V for the warp's row tile m: P the A fragments of 64 keys
// (four 16-key steps, in increasing order), V a 64-key tile (shared, row
// stride DP + kPadH), o[m][j] columns [8j, 8j + 8) of the head.
template <int DP, int MT>
__device__ __forceinline__ void pv_tile(float (&o)[MT][DP / 8][4], const uint32_t (&pa)[MT][4][4],
                                        const bf16* Vs, int lane) {
  constexpr int kLd = DP + kPadH;
  // matrices (transposed): keys k0 .. k0 + 7 and k0 + 8 .. + 15 at columns
  // d0, then the same keys at d0 + 8
  const int row = (lane % 8) + ((lane / 8) % 2) * 8, col = (lane / 16) * 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int d = 0; d < DP / 16; ++d) {
      uint32_t b[4];
      ldmatrix_x4<true>(b, Vs + (kk * 16 + row) * kLd + d * 16 + col);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        mma_16816(o[m][2 * d], pa[m][kk], b[0], b[1]);
        mma_16816(o[m][2 * d + 1], pa[m][kk], b[2], b[3]);
      }
    }
  }
}

// Store rows g and g + 8 of a warp's fp32 output fragments o (columns [8j,
// 8j + 8) in o[j]), each divided by its row's divisor and rounded to bf16
// once, as 4-byte pairs into rows of stride ld; rows at or past `rows` and
// columns at or past Dh (even: at Dh 4 half a fragment's pairs) are not
// written.
template <int DP>
__device__ __forceinline__ void store_rows_bf16(bf16* __restrict__ dst, size_t ld,
                                                const float (&o)[DP / 8][4], float div_g,
                                                float div_g8, int r, int rows, int Dh, int lane) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    if (j * 8 >= Dh) break;
    const int c = j * 8 + 2 * t;
    if (c >= Dh) continue;
    if (r + g < rows)
      *reinterpret_cast<uint32_t*>(dst + (size_t)(r + g) * ld + c) =
          pack_bf16(o[j][0] / div_g, o[j][1] / div_g);
    if (r + g + 8 < rows)
      *reinterpret_cast<uint32_t*>(dst + (size_t)(r + g + 8) * ld + c) =
          pack_bf16(o[j][2] / div_g8, o[j][3] / div_g8);
  }
}


// ---- the wide forwards: K8f at Dh 256-896, the core past a padded head of 128 ----
// (the wide backwards in attention_bwd_regs.cuh take the same column split)
//
// A 64 x Dh fp32 output tile is 64 Dh registers (49,152 at Dh 768 against
// the SM's 65,536), so no warp can hold a row tile's whole O. A block of
// WARPS warps (8 or 16) is RT row tiles of 16 query rows times G column
// groups (RT G = WARPS): the warps of a row tile split O's columns, group g
// holding columns [128 c + g 128 / G, 128 c + (g + 1) 128 / G) of every
// 128-column chunk c as mma.sync accumulators (at most 112 fp32 a lane),
// and split each 16 x 64 score tile's keys, group g computing keys [g 64 /
// G, (g + 1) 64 / G) at the full depth, so that every score is one warp's
// in-order sum over the head. K and V pass through a ring of S stages of
// 64 keys x 128 columns, copied by cp.async S - 1 stages ahead, with one
// barrier where a stage is handed over: each K stage is one depth chunk of
// the score tile, each V stage one column chunk of P V, and every warp
// works on every stage. Q is copied once and read by ldmatrix at each depth
// step (a whole head of A fragments would not fit a lane's registers past
// Dh 128).
constexpr int kWideKeys = 64;                  // keys a tile
constexpr int kWideCols = 128;                 // head columns a ring stage
constexpr int kWideLd = kWideCols + kPadH;     // a stage's row stride
constexpr int kWideStage = kWideKeys * kWideLd;  // bf16 elements a stage
constexpr int kWideMaxWidth = 896;             // the widest padded head (7 chunks)

// Rows [r0, r0 + 64) x columns [c0, c0 + 128) of a head (row stride ld, Dh
// columns, padded to DP) into a ring stage, by cp.async, all THREADS
// threads of the block: rows at or past `rows` and columns at or past Dh
// are zeros; columns at or past DP (a last chunk narrower than 128) are not
// written, and no product reads them. Commits nothing.
template <int THREADS>
__device__ __forceinline__ void load_chunk_async(bf16* dst, const bf16* __restrict__ src,
                                                 size_t ld, int r0, int rows, int c0, int DP,
                                                 int Dh) {
  constexpr int kVec = kWideCols / 8;
  static_assert(kWideKeys * kVec % THREADS == 0, "a stage's pieces split over the threads");
#pragma unroll
  for (int n = 0; n < kWideKeys * kVec / THREADS; ++n) {
    const int i = threadIdx.x + n * THREADS, r = i / kVec, c = (i % kVec) * 8;
    if (c0 + c < DP) {
      const bool valid = r0 + r < rows && c0 + c < Dh;
      cp_async16(dst + r * kWideLd + c, valid ? src + (size_t)(r0 + r) * ld + c0 + c : src,
                 valid);
    }
  }
}

// ROWS rows of a head from row r0 (row stride ld, Dh columns) into a shared
// tile of DP columns (row stride dld), by cp.async, all THREADS threads of
// the block: rows at or past `rows` and columns at or past Dh are zeros.
template <int ROWS, int THREADS>
__device__ __forceinline__ void load_rows_async(bf16* dst, int dld, const bf16* __restrict__ src,
                                                size_t ld, int r0, int rows, int DP, int Dh) {
  const int vec = DP / 8;
  for (int i = threadIdx.x; i < ROWS * vec; i += THREADS) {
    const int r = i / vec, c = (i % vec) * 8;
    const bool valid = r0 + r < rows && c < Dh;
    cp_async16(dst + r * dld + c, valid ? src + (size_t)(r0 + r) * ld + c : src, valid);
  }
}

// load_chunk_async and load_rows_async (n rows) for a block whose threads
// are counted at run time.
__device__ __forceinline__ void load_chunk_async_any(bf16* dst, const bf16* __restrict__ src,
                                                     size_t ld, int r0, int rows, int c0, int DP,
                                                     int Dh) {
  constexpr int kVec = kWideCols / 8;
  for (int i = threadIdx.x; i < kWideKeys * kVec; i += blockDim.x) {
    const int r = i / kVec, c = (i % kVec) * 8;
    if (c0 + c < DP) {
      const bool valid = r0 + r < rows && c0 + c < Dh;
      cp_async16(dst + r * kWideLd + c, valid ? src + (size_t)(r0 + r) * ld + c0 + c : src,
                 valid);
    }
  }
}

__device__ __forceinline__ void load_rows_async_any(bf16* dst, int dld,
                                                    const bf16* __restrict__ src, size_t ld,
                                                    int r0, int n, int rows, int DP, int Dh) {
  const int vec = DP / 8;
  for (int i = threadIdx.x; i < n * vec; i += blockDim.x) {
    const int r = i / vec, c = (i % vec) * 8;
    const bool valid = r0 + r < rows && c < Dh;
    cp_async16(dst + r * dld + c, valid ? src + (size_t)(r0 + r) * ld + c : src, valid);
  }
}

// s[j] += the warp's 16 rows of Q (shared, row stride qld, from the chunk's
// first column) times keys [8j, 8j + 8) of a K stage (from the warp's first
// key), over the chunk's first w columns (a multiple of 16) in increasing
// order: the order of qk_tile, one chunk of the depth. At NJ = 1 (8 keys)
// each B fragment is an ldmatrix_x2.
template <int NJ>
__device__ __forceinline__ void qk_chunk(float (&s)[NJ][4], const bf16* Qc, int qld,
                                         const bf16* Kc, int w, int lane) {
  const bf16* qa = Qc + (lane % 16) * qld + (lane / 16) * 8;
  const int row = (lane % 8) + (lane / 16) * 8, col = ((lane / 8) % 2) * 8;
  const bf16* kb = Kc + row * kWideLd + col;
  const bf16* kb1 = Kc + (lane % 8) * kWideLd + col;  // NJ = 1: keys 0-7, lanes 0-15
#pragma unroll
  for (int kk = 0; kk < kWideCols / 16; ++kk) {
    if (16 * kk >= w) break;
    uint32_t a[4];
    ldmatrix_x4<false>(a, qa + kk * 16);
    if constexpr (NJ == 1) {
      uint32_t b[2];
      ldmatrix_x2(b, kb1 + kk * 16);
      mma_16816(s[0], a, b[0], b[1]);
    } else {
#pragma unroll
      for (int n = 0; n < NJ / 2; ++n) {
        uint32_t b[4];
        ldmatrix_x4<false>(b, kb + n * 16 * kWideLd + kk * 16);
        mma_16816(s[2 * n], a, b[0], b[1]);
        mma_16816(s[2 * n + 1], a, b[2], b[3]);
      }
    }
  }
}

// o[j] += P V over the tile's 64 keys: P the A fragments of its four 16-key
// steps (in increasing order), V a stage's columns [8j, 8j + 8) from the
// warp's first column, the first w of them (a multiple of 16; none past).
template <int NO>
__device__ __forceinline__ void pv_chunk(float (&o)[NO][4], const uint32_t (&pa)[4][4],
                                         const bf16* Vc, int w, int lane) {
  const int row = (lane % 8) + ((lane / 8) % 2) * 8, col = (lane / 16) * 8;
  const bf16* vb = Vc + row * kWideLd + col;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int d = 0; d < NO / 2; ++d) {
      if (16 * d >= w) break;
      uint32_t b[4];
      ldmatrix_x4<true>(b, vb + kk * 16 * kWideLd + d * 16);
      mma_16816(o[2 * d], pa[kk], b[0], b[1]);
      mma_16816(o[2 * d + 1], pa[kk], b[2], b[3]);
    }
  }
}

// The largest of rows g and g + 8 over the G groups of a row tile, from
// x[w 16 + r] (warp w's value of row r) at the row tile's first warp.
template <int G>
__device__ __forceinline__ void group_max(const float* x, int g, float (&m)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m[r] = x[g + 8 * r];
#pragma unroll
    for (int w = 1; w < G; ++w) m[r] = fmaxf(m[r], x[16 * w + g + 8 * r]);
  }
}

// The sum of rows g and g + 8 over the G groups, in group order.
template <int G>
__device__ __forceinline__ void group_sum(const float* x, int g, float (&l)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = x[g + 8 * r];
#pragma unroll
    for (int w = 1; w < G; ++w) l[r] += x[16 * w + g + 8 * r];
  }
}

// Rows g and g + 8 of the warp's chunk accumulators (o[c][j]: head columns
// 128 c + cs + [8j, 8j + 8)), each divided by its row's divisor and rounded
// to bf16 once, as 4-byte pairs into rows of stride ld from the head's row
// 0; rows at or past `rows` and columns at or past Dh are not written.
template <int NC, int NO>
__device__ __forceinline__ void store_wide(bf16* __restrict__ dst, size_t ld,
                                           const float (&o)[NC][NO][4], float div_g,
                                           float div_g8, int r, int rows, int cs, int Dh,
                                           int lane) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      const int col = c * kWideCols + cs + j * 8 + 2 * t;
      if (col >= Dh) continue;
      if (r + g < rows)
        *reinterpret_cast<uint32_t*>(dst + (size_t)(r + g) * ld + col) =
            pack_bf16(o[c][j][0] / div_g, o[c][j][1] / div_g);
      if (r + g + 8 < rows)
        *reinterpret_cast<uint32_t*>(dst + (size_t)(r + g + 8) * ld + col) =
            pack_bf16(o[c][j][2] / div_g8, o[c][j][3] / div_g8);
    }
}

}  // namespace
}  // namespace ddm
