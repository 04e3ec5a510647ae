// Multi-head attention cores of the DiT attention half-block, 16 <= N <= 512
// tokens (N a multiple of 16), head widths Dh a multiple of 8.
//
// Replace the attention part of ddm_tpu/ops/attention.py `_blk_fwd_kernel`
// (`_mha_packed_fwd`, K2f) and the per-head cores of the persist-probs
// backward `_blk_bwd_kernel` (K2b) and of the split backward
// `_blk_bwd_split_kernel` (K4, DiT-B and DiT-L widths); gemm.cu holds the
// LN + qkv product before them and the projection + residual after them.
// The same cores are the standalone attention core K7, `_fused_fwd_call` ->
// `_fwd_kernel` and `_fused_bwd` -> `_bwd_kernel`, which the JAX ladder's
// third rung runs between XLA's GEMMs (DiT-L at N = 256): K7f reads q, k and
// v as three (B, N, D) operands of one row stride, and K7b writes dq, dk and
// dv and no att, as JAX's K7 backward does. The TPU kernels packed g images
// under a -1e30 block mask, which adds exact zeros to every softmax sum, so
// one image at a time gives the same values.
//
// What bounds them on the H100: at DiT-S/4 (N = 64 tokens, Dh = 64) one
// (image, head) pair is 1 MFLOP over 24 KB of q/k/v, so a core is bound by
// reading qkv and writing its outputs (~50 MB per forward call at B = 256),
// and by latency: the tiles are far too small to fill a tensor core for
// long. At N = 256 the products grow with N^2 and each (image, head)'s K
// and V are read again, from L2, by every query tile. The TPU kernels
// packed several images into one block-diagonal masked product to fill its
// 128-wide matrix unit; here one image is already a whole tile, so there is
// no packing and no mask.
//
// The rounding plan is the TPU kernels' everywhere: scores in fp32, a
// max-subtracted softmax over the whole row, P rounded to bf16 once after
// normalising (K8's online softmax would round against a running max), P V
// accumulated in fp32 and rounded once; in the backward dv = bf16(bf16(P)^T
// dO), dP = dO V^T in fp32, dS = bf16(scale * P * (dP - rowsum(P * dP)))
// with the fp32 P, dq = bf16(dS K), dk = bf16(dS^T Q), and att =
// bf16(bf16(P) V), the attention output that the projection's weight
// gradient reads, from the same fp32 P. The TPU needs two backward kernels
// because of VMEM; on the H100 K2b and K4 share these cores.
//
// The forward core: one block per (image, head, query tile) holds its QT
// full score rows in shared memory (K, then V, pass through one N-row
// buffer). The backward has two designs, picked by N. Where one (image,
// head)'s fp32 P and dP tiles fit a block (N <= 112 at Dh = 64) one block
// per (image, head) keeps Q, K, V, dO, P and dP in shared memory (81 KB at
// N = Dh = 64) and computes the scores once. Past that, two passes with no
// atomics and a fixed order: pass 1, over query tiles, computes P, att, dP,
// the row terms rowsum(P dP) and dq, and saves each row's (max, sum,
// rowsum(P dP)) in fp32; pass 2, over key tiles, walks the query tiles in
// order, recomputes P from the saved max and sum, and accumulates dv and dk
// in fp32 in shared memory, rounding once. Every product runs its 16 x 16
// tiles over the same depth slices in the same order in every design, and
// the recomputed P is the same expression of the same scores, so where two
// designs take a shape their outputs agree bit for bit.
//
// Head widths: the WMMA fragments are 16 deep and 16 wide, and the JAX gates
// take any Dh % 8 = 0 (DiT-XL's 16 heads of 72, DiT-S at --heads 16: 24).
// Each head's tile in shared memory is padded to the next multiple of 16
// (72 -> 80, 24 -> 32) with zero columns: zeros added to q and k leave Q K^T
// as it is, and the padded columns of P V, dS K and the other products are
// never written back. A head's columns start at h Dh elements, a multiple
// of 16 bytes, so the 16-byte loads hold; a head row is Dh / 8 of them (9 at
// Dh 72). Where Dh % 16 = 0 nothing is padded and the products are the ones
// before the padding existed.
#include <type_traits>

#include "common.cuh"

namespace ddm {
namespace {

constexpr int kThreads = 128;  // 4 warps
constexpr size_t kMaxSmem = 232448;

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

// rows x Dh bf16 values, row stride src_ld, into a shared tile of stride ld,
// each row followed by zeros up to padded(Dh) columns.
__device__ __forceinline__ void load_head(bf16* dst, int ld, const bf16* __restrict__ src,
                                          int src_ld, int rows, int Dh) {
  const int vec = padded(Dh) / 8;
  for (int i = threadIdx.x; i < rows * vec; i += kThreads) {
    const int r = i / vec, c = (i % vec) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (c < Dh) v = *reinterpret_cast<const uint4*>(src + (size_t)r * src_ld + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = v;
  }
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

size_t core_smem(int N, int Dh, int QT) {
  Dh = padded(Dh);
  const int QLD = Dh + kPadH, SLD = (N > Dh ? N : Dh) + kPadF;
  return (size_t)(QT + N) * QLD * sizeof(bf16) + (size_t)QT * SLD * sizeof(float) +
         (size_t)QT * (N + kPadH) * sizeof(bf16);
}

// K2f's and K7f's core: block (b H + h, t) writes rows [t QT, (t + 1) QT)
// of one (image, head).
__global__ void __launch_bounds__(kThreads)
attention_core_kernel(Heads in, bf16* __restrict__ out, int N, int H, int Dh, float scale,
                      int QT) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int D = H * Dh, DP = padded(Dh);
  const int QLD = DP + kPadH, SLD = max(N, DP) + kPadF, PLD = N + kPadH;
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* KV = Qs + QT * QLD;
  float* S = reinterpret_cast<float*>(KV + N * QLD);  // scores, then the output
  bf16* P = reinterpret_cast<bf16*>(S + QT * SLD);

  const int b = blockIdx.x / H, h = blockIdx.x % H, r0 = blockIdx.y * QT;
  load_head(Qs, QLD, in.row(in.q, b, N, r0, h, Dh), in.ld, QT, Dh);
  load_head(KV, QLD, in.row(in.k, b, N, 0, h, Dh), in.ld, N, Dh);
  __syncthreads();
  mma_tiles<false, true, false>(Qs, QLD, KV, QLD, S, SLD, QT, N, DP);  // S = Q K^T
  __syncthreads();
  load_head(KV, QLD, in.row(in.v, b, N, 0, h, Dh), in.ld, N, Dh);  // V over K
  softmax_rows(S, SLD, P, PLD, QT, N, scale, false, nullptr);
  __syncthreads();
  mma_tiles<false, false, false>(P, PLD, KV, QLD, S, SLD, QT, DP, N);  // O = P V
  __syncthreads();
  store_head(out + ((size_t)b * N + r0) * D + h * Dh, D, S, SLD, QT, Dh);
}

size_t core_bwd_smem(int N, int Dh) {
  Dh = padded(Dh);
  const int SLD = (N > Dh ? N : Dh) + kPadF;
  return (size_t)4 * N * (Dh + kPadH) * sizeof(bf16) + (size_t)2 * N * SLD * sizeof(float) +
         (size_t)N * (N + kPadH) * sizeof(bf16);
}

// The one-block backward: block b H + h holds all N rows of one (image,
// head) and writes dq, dk, dv, and att where att is not null.
__global__ void __launch_bounds__(kThreads)
attention_core_bwd_kernel(Heads in, const bf16* __restrict__ datt, bf16* __restrict__ att,
                          DHeads out, int N, int H, int Dh, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int D = H * Dh, DP = padded(Dh);
  const int QLD = DP + kPadH, SLD = max(N, DP) + kPadF, PLD = N + kPadH;
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + N * QLD;
  bf16* Vs = Ks + N * QLD;
  bf16* dOs = Vs + N * QLD;
  float* P = reinterpret_cast<float*>(dOs + N * QLD);  // fp32 P, later dq
  float* F = P + N * SLD;                              // dv, att, dP, then dk
  bf16* Pb = reinterpret_cast<bf16*>(F + N * SLD);     // bf16 P, then bf16 dS

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  load_head(Qs, QLD, in.row(in.q, b, N, 0, h, Dh), in.ld, N, Dh);
  load_head(Ks, QLD, in.row(in.k, b, N, 0, h, Dh), in.ld, N, Dh);
  load_head(Vs, QLD, in.row(in.v, b, N, 0, h, Dh), in.ld, N, Dh);
  load_head(dOs, QLD, datt + (size_t)b * N * D + h * Dh, D, N, Dh);
  __syncthreads();
  mma_tiles<false, true, false>(Qs, QLD, Ks, QLD, P, SLD, N, N, DP);  // S = Q K^T
  __syncthreads();
  softmax_rows(P, SLD, Pb, PLD, N, N, scale, true, nullptr);
  __syncthreads();
  mma_tiles<true, false, false>(Pb, PLD, dOs, QLD, F, SLD, N, DP, N);  // dv = Pb^T dO
  __syncthreads();
  store_head(out.row(out.v, b, N, 0, h, Dh), out.ld, F, SLD, N, Dh);
  __syncthreads();
  if (att != nullptr) {
    mma_tiles<false, false, false>(Pb, PLD, Vs, QLD, F, SLD, N, DP, N);  // att = Pb V
    __syncthreads();
    store_head(att + (size_t)b * N * D + h * Dh, D, F, SLD, N, Dh);
    __syncthreads();
  }
  mma_tiles<false, true, false>(dOs, QLD, Vs, QLD, F, SLD, N, N, DP);  // dP = dO V^T
  __syncthreads();
  ds_rows(P, F, SLD, Pb, PLD, N, N, scale, nullptr);
  __syncthreads();
  mma_tiles<false, false, false>(Pb, PLD, Ks, QLD, P, SLD, N, DP, N);  // dq = dS K
  mma_tiles<true, false, false>(Pb, PLD, Qs, QLD, F, SLD, N, DP, N);   // dk = dS^T Q
  __syncthreads();
  store_head(out.row(out.q, b, N, 0, h, Dh), out.ld, P, SLD, N, Dh);
  store_head(out.row(out.k, b, N, 0, h, Dh), out.ld, F, SLD, N, Dh);
}

size_t bwd_rows_smem(int N, int Dh, int QT) {
  Dh = padded(Dh);
  const int QLD = Dh + kPadH, SLD = (N > Dh ? N : Dh) + kPadF;
  return (size_t)(2 * QT + N) * QLD * sizeof(bf16) + (size_t)2 * QT * SLD * sizeof(float) +
         (size_t)QT * (N + kPadH) * sizeof(bf16);
}

// Backward pass 1: block (b H + h, t) takes query rows [r0, r0 + QT): P
// (fp32, kept), att (where att is not null), dP, dS, dq; each row's (max,
// sum, rowsum(P dP)) to stats. K, V, then K again pass through one N-row
// buffer.
__global__ void __launch_bounds__(kThreads)
attention_core_bwd_rows_kernel(Heads in, const bf16* __restrict__ datt, bf16* __restrict__ att,
                               DHeads out, float* __restrict__ stats, int N, int H, int Dh,
                               float scale, int QT) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int D = H * Dh, DP = padded(Dh);
  const int QLD = DP + kPadH, SLD = max(N, DP) + kPadF, PLD = N + kPadH;
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + QT * QLD;
  bf16* KV = dOs + QT * QLD;
  float* P = reinterpret_cast<float*>(KV + N * QLD);  // fp32 P, later dq
  float* F = P + QT * SLD;                            // att, then dP
  bf16* Pb = reinterpret_cast<bf16*>(F + QT * SLD);   // bf16 P, then bf16 dS

  const int b = blockIdx.x / H, h = blockIdx.x % H, r0 = blockIdx.y * QT;
  float* st = stats + ((size_t)blockIdx.x * N + r0) * 3;
  load_head(Qs, QLD, in.row(in.q, b, N, r0, h, Dh), in.ld, QT, Dh);
  load_head(dOs, QLD, datt + ((size_t)b * N + r0) * D + h * Dh, D, QT, Dh);
  load_head(KV, QLD, in.row(in.k, b, N, 0, h, Dh), in.ld, N, Dh);
  __syncthreads();
  mma_tiles<false, true, false>(Qs, QLD, KV, QLD, P, SLD, QT, N, DP);  // S = Q K^T
  __syncthreads();
  load_head(KV, QLD, in.row(in.v, b, N, 0, h, Dh), in.ld, N, Dh);  // V over K
  softmax_rows(P, SLD, Pb, PLD, QT, N, scale, true, st);
  __syncthreads();
  if (att != nullptr) {
    mma_tiles<false, false, false>(Pb, PLD, KV, QLD, F, SLD, QT, DP, N);  // att = Pb V
    __syncthreads();
    store_head(att + ((size_t)b * N + r0) * D + h * Dh, D, F, SLD, QT, Dh);
    __syncthreads();
  }
  mma_tiles<false, true, false>(dOs, QLD, KV, QLD, F, SLD, QT, N, DP);  // dP = dO V^T
  __syncthreads();
  load_head(KV, QLD, in.row(in.k, b, N, 0, h, Dh), in.ld, N, Dh);  // K over V
  ds_rows(P, F, SLD, Pb, PLD, QT, N, scale, st);
  __syncthreads();
  mma_tiles<false, false, false>(Pb, PLD, KV, QLD, P, SLD, QT, DP, N);  // dq = dS K
  __syncthreads();
  store_head(out.row(out.q, b, N, r0, h, Dh), out.ld, P, SLD, QT, Dh);
}

size_t bwd_cols_smem(int Dh, int KT, int QT) {
  Dh = padded(Dh);
  const int QLD = Dh + kPadH, TLD = KT + kPadF, ALD = Dh + kPadF;
  return (size_t)(2 * KT + 2 * QT) * QLD * sizeof(bf16) +
         (size_t)(2 * QT * TLD + 2 * KT * ALD + 3 * QT) * sizeof(float) +
         (size_t)QT * (KT + kPadH) * sizeof(bf16);
}

// Backward pass 2: block (b H + h, t) takes key rows [c0, c0 + KT) and walks
// the query tiles in order: S = Q K^T and dP = dO V^T on the tile, P from
// pass 1's (max, sum), dv += bf16(P)^T dO, dS from pass 1's rowsum(P dP),
// dk += dS^T Q, with dk and dv in fp32 in shared memory, rounded once.
__global__ void __launch_bounds__(kThreads)
attention_core_bwd_cols_kernel(Heads in, const bf16* __restrict__ datt,
                               const float* __restrict__ stats, DHeads out, int N, int H, int Dh,
                               float scale, int KT, int QT) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int D = H * Dh, DP = padded(Dh);
  const int QLD = DP + kPadH, TLD = KT + kPadF, ALD = DP + kPadF, TPLD = KT + kPadH;
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + KT * QLD;
  bf16* Qs = Vs + KT * QLD;
  bf16* dOs = Qs + QT * QLD;
  float* S = reinterpret_cast<float*>(dOs + QT * QLD);  // scores, then fp32 P
  float* F = S + QT * TLD;                              // dP
  float* dV = F + QT * TLD;
  float* dK = dV + KT * ALD;
  float* st = dK + KT * ALD;                            // QT x (max, sum, rowsum(P dP))
  bf16* Pb = reinterpret_cast<bf16*>(st + 3 * QT);      // bf16 P, then bf16 dS

  const int b = blockIdx.x / H, h = blockIdx.x % H, c0 = blockIdx.y * KT;
  const float* sb = stats + (size_t)blockIdx.x * N * 3;
  load_head(Ks, QLD, in.row(in.k, b, N, c0, h, Dh), in.ld, KT, Dh);
  load_head(Vs, QLD, in.row(in.v, b, N, c0, h, Dh), in.ld, KT, Dh);
  for (int i = threadIdx.x; i < 2 * KT * ALD; i += kThreads) dV[i] = 0.f;  // dV, dK
  for (int q0 = 0; q0 < N; q0 += QT) {
    __syncthreads();
    load_head(Qs, QLD, in.row(in.q, b, N, q0, h, Dh), in.ld, QT, Dh);
    load_head(dOs, QLD, datt + ((size_t)b * N + q0) * D + h * Dh, D, QT, Dh);
    for (int i = threadIdx.x; i < 3 * QT; i += kThreads) st[i] = sb[(size_t)q0 * 3 + i];
    __syncthreads();
    mma_tiles<false, true, false>(Qs, QLD, Ks, QLD, S, TLD, QT, KT, DP);   // S = Q K^T
    mma_tiles<false, true, false>(dOs, QLD, Vs, QLD, F, TLD, QT, KT, DP);  // dP = dO V^T
    __syncthreads();
    for (int i = threadIdx.x; i < QT * KT; i += kThreads) {
      const int r = i / KT, c = i % KT;
      const float p = expf(S[r * TLD + c] * scale - st[3 * r]) / st[3 * r + 1];
      S[r * TLD + c] = p;
      Pb[r * TPLD + c] = __float2bfloat16(p);
    }
    __syncthreads();
    mma_tiles<true, false, true>(Pb, TPLD, dOs, QLD, dV, ALD, KT, DP, QT);  // dv += P^T dO
    __syncthreads();
    for (int i = threadIdx.x; i < QT * KT; i += kThreads) {
      const int r = i / KT, c = i % KT;
      Pb[r * TPLD + c] =
          __float2bfloat16(S[r * TLD + c] * (F[r * TLD + c] - st[3 * r + 2]) * scale);
    }
    __syncthreads();
    mma_tiles<true, false, true>(Pb, TPLD, Qs, QLD, dK, ALD, KT, DP, QT);  // dk += dS^T Q
  }
  __syncthreads();
  store_head(out.row(out.k, b, N, c0, h, Dh), out.ld, dK, ALD, KT, Dh);
  store_head(out.row(out.v, b, N, c0, h, Dh), out.ld, dV, ALD, KT, Dh);
}

// The widest of 32 and 16 rows dividing N whose tile fits `limit`; 0 if none.
template <typename Smem>
int pick_rows(int N, size_t limit, Smem smem) {
  for (int t = 32; t >= 16; t /= 2)
    if (N % t == 0 && smem(t) <= limit) return t;
  return 0;
}

cudaError_t set_smem(const void* kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// The forward core over q, k, v into the (B, N, H*Dh) out.
cudaError_t launch_core(Heads in, bf16* out, int B, int N, int H, int Dh, float scale,
                        cudaStream_t stream) {
  const int QT = pick_rows(N, kMaxSmem, [&](int t) { return core_smem(N, Dh, t); });
  if (QT == 0) return cudaErrorInvalidValue;
  const size_t smem = core_smem(N, Dh, QT);
  cudaError_t err = set_smem((const void*)attention_core_kernel, smem);
  if (err != cudaSuccess) return err;
  attention_core_kernel<<<dim3(B * H, N / QT), kThreads, smem, stream>>>(in, out, N, H, Dh,
                                                                         scale, QT);
  return cudaGetLastError();
}

// The one-block backward: dq, dk, dv, and att where it is not null.
cudaError_t launch_bwd_one_block(Heads in, const bf16* datt, bf16* att, DHeads out, int B, int N,
                                 int H, int Dh, float scale, cudaStream_t stream) {
  const size_t smem = core_bwd_smem(N, Dh);
  cudaError_t err = set_smem((const void*)attention_core_bwd_kernel, smem);
  if (err != cudaSuccess) return err;
  attention_core_bwd_kernel<<<B * H, kThreads, smem, stream>>>(in, datt, att, out, N, H, Dh,
                                                               scale);
  return cudaGetLastError();
}

// The two-pass backward: the same outputs; stats holds B x H x N x 3 floats
// of scratch. Pass 1 takes two blocks per SM where its tile allows.
cudaError_t launch_bwd_tiled(Heads in, const bf16* datt, bf16* att, DHeads out, float* stats,
                             int B, int N, int H, int Dh, float scale, cudaStream_t s) {
  auto rows = [&](int t) { return bwd_rows_smem(N, Dh, t); };
  int QT = pick_rows(N, kMaxSmem / 2, rows);
  if (QT == 0) QT = pick_rows(N, kMaxSmem, rows);
  int KT = N % 64 == 0 ? 64 : N % 32 == 0 ? 32 : 16;
  const int QT2 = N % 32 == 0 ? 32 : 16;
  while (KT > 16 && bwd_cols_smem(Dh, KT, QT2) > kMaxSmem) KT /= 2;
  if (QT == 0 || bwd_cols_smem(Dh, KT, QT2) > kMaxSmem) return cudaErrorInvalidValue;
  size_t smem = rows(QT);
  cudaError_t err = set_smem((const void*)attention_core_bwd_rows_kernel, smem);
  if (err != cudaSuccess) return err;
  attention_core_bwd_rows_kernel<<<dim3(B * H, N / QT), kThreads, smem, s>>>(
      in, datt, att, out, stats, N, H, Dh, scale, QT);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  smem = bwd_cols_smem(Dh, KT, QT2);
  err = set_smem((const void*)attention_core_bwd_cols_kernel, smem);
  if (err != cudaSuccess) return err;
  attention_core_bwd_cols_kernel<<<dim3(B * H, N / KT), kThreads, smem, s>>>(
      in, datt, stats, out, N, H, Dh, scale, KT, QT2);
  return cudaGetLastError();
}

// dq, dk and dv into the thirds of a (B, N, 3D) buffer.
DHeads dqkv_heads(void* dqkv, int D) {
  bf16* p = (bf16*)dqkv;
  return {p, p + D, p + 2 * D, 3 * D};
}

}  // namespace
}  // namespace ddm

// The forward core (K2f's, and K7f): the (B, N, H*Dh) output of q, k and v
// given as (B, N, H*Dh) rows of stride ld (K2f passes the thirds of its
// [q | k | v] buffer, ld = 3D).
extern "C" int ddm_attention_core(const void* q, const void* k, const void* v, int ld, void* out,
                                  int B, int N, int H, int Dh, float scale, void* stream) {
  using namespace ddm;
  const Heads in{(const bf16*)q, (const bf16*)k, (const bf16*)v, ld};
  return (int)launch_core(in, (bf16*)out, B, N, H, Dh, scale, (cudaStream_t)stream);
}

// The backward core (K2b's and K4's, and K7b): dq, dk and dv of the core over
// q, k and v (rows of stride ld) for the (B, N, H*Dh) cotangent dout, into the
// thirds of the (B, N, 3D) dqkv rows, and att = bf16(P V) where att is not
// null (K7b writes none). One block per (image, head) unless tiled; then
// stats holds B x H x N x 3 floats of scratch.
extern "C" int ddm_attention_core_bwd(const void* q, const void* k, const void* v, int ld,
                                      const void* dout, void* att, void* dqkv, void* stats, int B,
                                      int N, int H, int Dh, float scale, int tiled,
                                      void* stream) {
  using namespace ddm;
  const Heads in{(const bf16*)q, (const bf16*)k, (const bf16*)v, ld};
  const DHeads out = dqkv_heads(dqkv, H * Dh);
  const cudaStream_t s = (cudaStream_t)stream;
  if (tiled)
    return (int)launch_bwd_tiled(in, (const bf16*)dout, (bf16*)att, out, (float*)stats, B, N, H,
                                 Dh, scale, s);
  return (int)launch_bwd_one_block(in, (const bf16*)dout, (bf16*)att, out, B, N, H, Dh, scale,
                                   s);
}
