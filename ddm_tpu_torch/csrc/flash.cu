// Online-softmax attention for long sequences (K8), forward and backward.
//
// Replaces ddm_tpu/ops/flash.py: the forward `_fwd_kernel` and its
// K/V-windowed tier `_fwd_win_kernel`, and the backward `_bwd_kernel` and
// its two-kernel windowed split `_bwd_dq_kernel` / `_bwd_dkv_kernel`. On the
// TPU those five bodies exist because VMEM holds a whole image's K/V at
// N <= 8192 and not beyond; a block here holds 64-row tiles at every N, so
// one design covers all of them. The TPU's head-pair lane packing and its
// phantom-head pad fill 128-lane vregs; WMMA tiles are 16 wide, so each
// block takes one head and any head count runs as it is. The head width Dh
// is a template parameter, built at 32, 64 and 128 (the JAX kernels also take
// 8, 16 and multiples of 128 above it): the score tiles stay 64 x 64 at every
// Dh, and only the q, k, v, o tiles and the output fragments a warp holds
// grow with it. At Dh = 64 every product, sum and rounding runs in the order
// it ran before Dh was a parameter.
//
// What bounds it on the H100: at DiT-S/4 and --image-size 128 (N = 1024,
// Dh = 64) one (image, head) is 4 N^2 Dh = 268 MFLOP against 384 KB of
// q/k/v (the same ratio at every Dh: both grow with Dh), far above the
// card's ~295 FLOP/byte, so the kernels are bound by
// the tensor cores and by how well these simple tiles feed them: WMMA
// 16x16x16 on tiles copied synchronously into shared memory, no wgmma, TMA
// or copy pipeline yet.
//
// Layouts: q, k and v are read in place from rows of stride `ld` (the
// (B*N, 3D) [q | k | v] buffer of the qkv GEMM, or plain (B, N, D)
// tensors); o, do are (B*N, D) rows; lse and dsum are (B, H, N) fp32; dq, dk
// and dv land in the thirds of one (B*N, 3D) buffer, the layout of the qkv
// GEMM's output that the backward GEMMs take.
//
// flash_fwd_kernel: one block per (64-query tile, head, image). Q stays in
// shared memory; the block walks 64-key tiles of K and V: S = Q K^T in fp32,
// times the scale; a running max from -1e30 (as flash.py:104, not -inf);
// p = exp(s - m_new), rounded to bf16 for P V; l and the fp32 output O are
// rescaled by exp(m_old - m_new) before P V is added. It writes
// o = bf16(O / l) and lse = m + log(l).
//
// Backward, FlashAttention-2's split, with no atomics: each output element
// is written by one block, in a fixed loop order, so a second call is
// bit-identical.
// flash_bwd_dq_kernel, one block per (q tile, head, image): first
// dsum = rowsum(fp32(do) fp32(o)) from the bf16 o (written out for the
// second kernel), then over the k tiles p = exp(s * scale - lse),
// dp = dO V^T, ds = bf16(p (dp - dsum) scale), dq += ds K in register
// fragments; dq is rounded once.
// flash_bwd_dkv_kernel, one block per (k tile, head, image): over the q
// tiles the same p and ds, dv += bf16(p)^T dO, dk += ds^T Q in register
// fragments; dk and dv are rounded once.
#include "common.cuh"

namespace ddm {
namespace {

constexpr int kTile = 64;            // query rows and key rows per tile
constexpr int kThreads = 128;        // 4 warps; warp w owns rows [16w, 16w + 16)
constexpr int kPld = kTile + kPadH;  // bf16 probability tile row stride
constexpr int kSld = kTile + kPadF;  // fp32 score tile row stride
constexpr int kPTiles = kTile * kPld;     // bf16 elements of a probability tile
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = kTile / kWarps;
constexpr float kNegBig = -1e30f;

// The shapes that follow from the head width Dh: q/k/v/do tiles are 64 x Dh
// bf16 (row stride kLd), output tiles 64 x Dh fp32 (row stride kOld), and a
// warp holds kFrags of the 4 x (Dh / 16) output fragments of a 64 x Dh
// product: fragment f of warp w is tile t = w + 4 f, at (t / kCols, t % kCols).
template <int Dh>
struct Width {
  static_assert(Dh % 32 == 0 && Dh <= 128, "the kernels are built for Dh = 32, 64, 128");
  static constexpr int kLd = Dh + kPadH;
  static constexpr int kOld = Dh + kPadF;
  static constexpr int kHalfTiles = kTile * kLd;
  // an fp32 region that holds a 64 x 64 score tile or a 64 x Dh output tile
  static constexpr int kFTiles = kTile * (Dh > kTile ? kOld : kSld);
  static constexpr int kCols = Dh / kFrag;
  static constexpr int kFrags = kTile / kFrag * kCols / kWarps;
};

// Copy 64 rows of one head (Dh bf16 each) from rows of stride ld into a tile.
template <int Dh>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* __restrict__ src, int ld) {
  for (int i = threadIdx.x; i < kTile * (Dh / 8); i += kThreads) {
    const int r = i / (Dh / 8), c = (i % (Dh / 8)) * 8;
    *reinterpret_cast<uint4*>(dst + r * Width<Dh>::kLd + c) =
        *reinterpret_cast<const uint4*>(src + (size_t)r * ld + c);
  }
}

// out (64 x 64 fp32) = A B^T for two 64 x Dh bf16 tiles, depth Dh.
template <int Dh>
__device__ __forceinline__ void mma_abt(float* out, const bf16* A, const bf16* B, int warp) {
  constexpr int kLd = Width<Dh>::kLd;
  for (int t = warp; t < 16; t += kWarps) {
    const int ti = t / 4, tj = t % 4;
    FragC acc;
    wmma::fill_fragment(acc, 0.0f);
#pragma unroll
    for (int kk = 0; kk < Dh; kk += kFrag) {
      FragA a;
      FragBCol b;
      wmma::load_matrix_sync(a, A + ti * kFrag * kLd + kk, kLd);
      wmma::load_matrix_sync(b, B + tj * kFrag * kLd + kk, kLd);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(out + ti * kFrag * kSld + tj * kFrag, acc, kSld,
                            wmma::mem_row_major);
  }
}

// Round a 64 x Dh fp32 tile (row stride kOld) to bf16 rows of stride ld.
template <int Dh>
__device__ __forceinline__ void store_tile(bf16* __restrict__ dst, int ld, const float* src) {
  constexpr int kOld = Width<Dh>::kOld;
  for (int i = threadIdx.x; i < kTile * Dh / 2; i += kThreads) {
    const int r = i / (Dh / 2), c = 2 * (i % (Dh / 2));
    *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)r * ld + c) =
        __floats2bfloat162_rn(src[r * kOld + c], src[r * kOld + c + 1]);
  }
}

// Store a warp's output fragments into a 64 x Dh fp32 tile (row stride kOld).
template <int Dh>
__device__ __forceinline__ void store_frags(float* out, const FragC* frags, int warp) {
  constexpr int kCols = Width<Dh>::kCols, kOld = Width<Dh>::kOld;
#pragma unroll
  for (int f = 0; f < Width<Dh>::kFrags; ++f) {
    const int t = warp + kWarps * f;
    wmma::store_matrix_sync(out + (t / kCols) * kFrag * kOld + (t % kCols) * kFrag, frags[f],
                            kOld, wmma::mem_row_major);
  }
}

template <int Dh>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, int ld, bf16* __restrict__ o,
                 float* __restrict__ lse, int N, int H, float scale) {
  using W = Width<Dh>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + W::kHalfTiles;
  bf16* Vs = Ks + W::kHalfTiles;
  bf16* P = Vs + W::kHalfTiles;
  float* S = reinterpret_cast<float*>(P + kPTiles);
  float* O = S + kTile * kSld;
  float* row_m = O + kTile * W::kOld;
  float* row_l = row_m + kTile;

  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int D = H * Dh;
  const size_t row0 = (size_t)b * N;
  load_tile<Dh>(Qs, q + (row0 + q0) * ld + h * Dh, ld);
  for (int i = threadIdx.x; i < kTile * W::kOld; i += kThreads) O[i] = 0.f;
  if (threadIdx.x < kTile) {
    row_m[threadIdx.x] = kNegBig;
    row_l[threadIdx.x] = 0.f;
  }

  for (int k0 = 0; k0 < N; k0 += kTile) {
    __syncthreads();  // the last tile's P V is done with Ks, Vs and P
    load_tile<Dh>(Ks, k + (row0 + k0) * ld + h * Dh, ld);
    load_tile<Dh>(Vs, v + (row0 + k0) * ld + h * Dh, ld);
    __syncthreads();
    mma_abt<Dh>(S, Qs, Ks, warp);
    __syncthreads();

    // online softmax: each lane takes columns lane and lane + 32
    for (int r = warp * kRowsPerWarp; r < (warp + 1) * kRowsPerWarp; ++r) {
      const float s0 = S[r * kSld + lane] * scale;
      const float s1 = S[r * kSld + lane + 32] * scale;
      const float m_old = row_m[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      const float corr = expf(m_old - m_new);
      const float sum = warp_sum(p0 + p1);
      P[r * kPld + lane] = __float2bfloat16(p0);
      P[r * kPld + lane + 32] = __float2bfloat16(p1);
#pragma unroll
      for (int c = lane; c < Dh; c += 32) O[r * W::kOld + c] *= corr;
      if (lane == 0) {
        row_l[r] = row_l[r] * corr + sum;
        row_m[r] = m_new;
      }
      __syncwarp();
    }
    __syncthreads();

    // O += P V
    for (int t = warp; t < kTile / kFrag * W::kCols; t += kWarps) {
      const int ti = t / W::kCols, tj = t % W::kCols;
      FragC acc;
      wmma::load_matrix_sync(acc, O + ti * kFrag * W::kOld + tj * kFrag, W::kOld,
                             wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < kTile; kk += kFrag) {
        FragA a;
        FragBRow bv;
        wmma::load_matrix_sync(a, P + ti * kFrag * kPld + kk, kPld);
        wmma::load_matrix_sync(bv, Vs + kk * W::kLd + tj * kFrag, W::kLd);
        wmma::mma_sync(acc, a, bv, acc);
      }
      wmma::store_matrix_sync(O + ti * kFrag * W::kOld + tj * kFrag, acc, W::kOld,
                              wmma::mem_row_major);
    }
  }
  __syncthreads();

  bf16* dst = o + (row0 + q0) * D + h * Dh;
  for (int i = threadIdx.x; i < kTile * Dh / 2; i += kThreads) {
    const int r = i / (Dh / 2), c = 2 * (i % (Dh / 2));
    const float l = row_l[r];
    *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)r * D + c) =
        __floats2bfloat162_rn(O[r * W::kOld + c] / l, O[r * W::kOld + c + 1] / l);
  }
  if (threadIdx.x < kTile)
    lse[((size_t)b * H + h) * N + q0 + threadIdx.x] =
        row_m[threadIdx.x] + logf(row_l[threadIdx.x]);
}

// p = exp(s * scale - lse) and ds = bf16(p (dp - dsum) scale) for one
// 64 x 64 (q rows, k columns) tile; Pb (bf16 p) is written when non-null.
__device__ __forceinline__ void probs_and_ds(const float* S, const float* dP,
                                             const float* row_lse, const float* row_dsum,
                                             bf16* Pb, bf16* DS, float scale, int warp,
                                             int lane) {
  for (int r = warp * kRowsPerWarp; r < (warp + 1) * kRowsPerWarp; ++r) {
    const float l = row_lse[r], ds = row_dsum[r];
#pragma unroll
    for (int c = lane; c < kTile; c += 32) {
      const float p = expf(S[r * kSld + c] * scale - l);
      if (Pb) Pb[r * kPld + c] = __float2bfloat16(p);
      DS[r * kPld + c] = __float2bfloat16(p * (dP[r * kSld + c] - ds) * scale);
    }
  }
}

// rowsum(fp32(do) fp32(o)) of one row's Dh entries: the lane's products
// summed in pairs of columns (c, c + 32), then across the warp.
template <int Dh>
__device__ __forceinline__ float row_dot(const bf16* a, const bf16* o, int lane) {
  float s;
  if constexpr (Dh == 32) {
    s = __bfloat162float(a[lane]) * __bfloat162float(o[lane]);
  } else {
    s = __bfloat162float(a[lane]) * __bfloat162float(o[lane]) +
        __bfloat162float(a[lane + 32]) * __bfloat162float(o[lane + 32]);
#pragma unroll
    for (int c = lane + 64; c < Dh; c += 64)
      s += __bfloat162float(a[c]) * __bfloat162float(o[c]) +
           __bfloat162float(a[c + 32]) * __bfloat162float(o[c + 32]);
  }
  return warp_sum(s);
}

template <int Dh>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, int ld, const bf16* __restrict__ o,
                    const bf16* __restrict__ dout, const float* __restrict__ lse,
                    float* __restrict__ dsum, bf16* __restrict__ dqkv, int N, int H,
                    float scale) {
  using W = Width<Dh>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + W::kHalfTiles;
  bf16* Ks = dOs + W::kHalfTiles;
  bf16* Vs = Ks + W::kHalfTiles;
  bf16* DS = Vs + W::kHalfTiles;
  float* S = reinterpret_cast<float*>(DS + kPTiles);  // scores, then dq
  float* dP = S + W::kFTiles;
  float* row_lse = dP + kTile * kSld;
  float* row_dsum = row_lse + kTile;

  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int D = H * Dh;
  const size_t row0 = (size_t)b * N;
  const size_t stat0 = ((size_t)b * H + h) * N + q0;
  load_tile<Dh>(Qs, q + (row0 + q0) * ld + h * Dh, ld);
  load_tile<Dh>(dOs, dout + (row0 + q0) * D + h * Dh, D);
  if (threadIdx.x < kTile) row_lse[threadIdx.x] = lse[stat0 + threadIdx.x];
  __syncthreads();

  // dsum from the bf16 o the forward wrote (flash.py:398)
  for (int r = warp * kRowsPerWarp; r < (warp + 1) * kRowsPerWarp; ++r) {
    const float s = row_dot<Dh>(dOs + r * W::kLd, o + (row0 + q0 + r) * D + h * Dh, lane);
    if (lane == 0) {
      row_dsum[r] = s;
      dsum[stat0 + r] = s;
    }
  }

  FragC dq[W::kFrags];
#pragma unroll
  for (int f = 0; f < W::kFrags; ++f) wmma::fill_fragment(dq[f], 0.0f);

  for (int k0 = 0; k0 < N; k0 += kTile) {
    __syncthreads();  // the last tile's ds K is done with Ks and DS
    load_tile<Dh>(Ks, k + (row0 + k0) * ld + h * Dh, ld);
    load_tile<Dh>(Vs, v + (row0 + k0) * ld + h * Dh, ld);
    __syncthreads();
    mma_abt<Dh>(S, Qs, Ks, warp);
    mma_abt<Dh>(dP, dOs, Vs, warp);
    __syncthreads();
    probs_and_ds(S, dP, row_lse, row_dsum, nullptr, DS, scale, warp, lane);
    __syncthreads();
#pragma unroll
    for (int f = 0; f < W::kFrags; ++f) {
      const int t = warp + kWarps * f, ti = t / W::kCols, tj = t % W::kCols;
#pragma unroll
      for (int kk = 0; kk < kTile; kk += kFrag) {
        FragA a;
        FragBRow bk;
        wmma::load_matrix_sync(a, DS + ti * kFrag * kPld + kk, kPld);
        wmma::load_matrix_sync(bk, Ks + kk * W::kLd + tj * kFrag, W::kLd);
        wmma::mma_sync(dq[f], a, bk, dq[f]);
      }
    }
  }
  __syncthreads();
  store_frags<Dh>(S, dq, warp);
  __syncthreads();
  store_tile<Dh>(dqkv + (row0 + q0) * 3 * D + h * Dh, 3 * D, S);
}

template <int Dh>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, int ld, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ dsum,
                     bf16* __restrict__ dqkv, int N, int H, float scale) {
  using W = Width<Dh>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + W::kHalfTiles;
  bf16* Qs = Vs + W::kHalfTiles;
  bf16* dOs = Qs + W::kHalfTiles;
  bf16* Pb = dOs + W::kHalfTiles;
  bf16* DS = Pb + kPTiles;
  float* S = reinterpret_cast<float*>(DS + kPTiles);  // scores, then dk
  float* dP = S + W::kFTiles;                         // dP, then dv
  float* row_lse = dP + W::kFTiles;
  float* row_dsum = row_lse + kTile;

  const int k0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int D = H * Dh;
  const size_t row0 = (size_t)b * N;
  const size_t stat0 = ((size_t)b * H + h) * N;
  load_tile<Dh>(Ks, k + (row0 + k0) * ld + h * Dh, ld);
  load_tile<Dh>(Vs, v + (row0 + k0) * ld + h * Dh, ld);

  FragC dk[W::kFrags], dv[W::kFrags];
#pragma unroll
  for (int f = 0; f < W::kFrags; ++f) {
    wmma::fill_fragment(dk[f], 0.0f);
    wmma::fill_fragment(dv[f], 0.0f);
  }

  for (int q0 = 0; q0 < N; q0 += kTile) {
    __syncthreads();  // the last tile's products are done with Qs, dOs, Pb and DS
    load_tile<Dh>(Qs, q + (row0 + q0) * ld + h * Dh, ld);
    load_tile<Dh>(dOs, dout + (row0 + q0) * D + h * Dh, D);
    if (threadIdx.x < kTile) {
      row_lse[threadIdx.x] = lse[stat0 + q0 + threadIdx.x];
      row_dsum[threadIdx.x] = dsum[stat0 + q0 + threadIdx.x];
    }
    __syncthreads();
    mma_abt<Dh>(S, Qs, Ks, warp);
    mma_abt<Dh>(dP, dOs, Vs, warp);
    __syncthreads();
    probs_and_ds(S, dP, row_lse, row_dsum, Pb, DS, scale, warp, lane);
    __syncthreads();
    // dv += Pb^T dO, dk += DS^T Q, summed over this tile's 64 query rows
#pragma unroll
    for (int f = 0; f < W::kFrags; ++f) {
      const int t = warp + kWarps * f, ti = t / W::kCols, tj = t % W::kCols;
#pragma unroll
      for (int kk = 0; kk < kTile; kk += kFrag) {
        FragACol a;
        FragBRow bm;
        wmma::load_matrix_sync(a, Pb + kk * kPld + ti * kFrag, kPld);
        wmma::load_matrix_sync(bm, dOs + kk * W::kLd + tj * kFrag, W::kLd);
        wmma::mma_sync(dv[f], a, bm, dv[f]);
        wmma::load_matrix_sync(a, DS + kk * kPld + ti * kFrag, kPld);
        wmma::load_matrix_sync(bm, Qs + kk * W::kLd + tj * kFrag, W::kLd);
        wmma::mma_sync(dk[f], a, bm, dk[f]);
      }
    }
  }
  __syncthreads();
  store_frags<Dh>(S, dk, warp);
  store_frags<Dh>(dP, dv, warp);
  __syncthreads();
  bf16* out = dqkv + (row0 + k0) * 3 * D + h * Dh;
  store_tile<Dh>(out + D, 3 * D, S);
  store_tile<Dh>(out + 2 * D, 3 * D, dP);
}

// Shared memory per block: at Dh = 64, 72 KB, 81 KB and 90 KB (two or three
// blocks per SM); at Dh = 128, 111 KB, 128 KB and 153 KB.
template <int Dh>
struct Smem {
  using W = Width<Dh>;
  static constexpr size_t kFwd = (3 * W::kHalfTiles + kPTiles) * sizeof(bf16) +
                                 (kTile * kSld + kTile * W::kOld + 2 * kTile) * sizeof(float);
  static constexpr size_t kDq = (4 * W::kHalfTiles + kPTiles) * sizeof(bf16) +
                                (W::kFTiles + kTile * kSld + 2 * kTile) * sizeof(float);
  static constexpr size_t kDkv = (4 * W::kHalfTiles + 2 * kPTiles) * sizeof(bf16) +
                                 (2 * W::kFTiles + 2 * kTile) * sizeof(float);
};

template <int Dh>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, int ld, void* o, void* lse,
                       int B, int N, int H, float scale, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<Dh>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)Smem<Dh>::kFwd);
  if (err != cudaSuccess) return err;
  const dim3 grid(N / kTile, H, B);
  flash_fwd_kernel<Dh><<<grid, kThreads, Smem<Dh>::kFwd, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, ld, (bf16*)o, (float*)lse, N, H, scale);
  return cudaGetLastError();
}

template <int Dh>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, int ld, const void* o,
                       const void* dout, const void* lse, void* dsum, void* dqkv, int B, int N,
                       int H, float scale, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<Dh>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)Smem<Dh>::kDq);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<Dh>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Smem<Dh>::kDkv);
  if (err != cudaSuccess) return err;
  const dim3 grid(N / kTile, H, B);
  // the dq kernel writes dsum, which the dk/dv kernel reads: same stream, in order
  flash_bwd_dq_kernel<Dh><<<grid, kThreads, Smem<Dh>::kDq, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, ld, (const bf16*)o, (const bf16*)dout,
      (const float*)lse, (float*)dsum, (bf16*)dqkv, N, H, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_kernel<Dh><<<grid, kThreads, Smem<Dh>::kDkv, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, ld, (const bf16*)dout, (const float*)lse,
      (const float*)dsum, (bf16*)dqkv, N, H, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace ddm

extern "C" int ddm_flash_fwd(const void* q, const void* k, const void* v, int ld, void* o,
                             void* lse, int B, int N, int H, int Dh, float scale, void* stream) {
  using namespace ddm;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (Dh) {
    case 32: return (int)launch_fwd<32>(q, k, v, ld, o, lse, B, N, H, scale, s);
    case 64: return (int)launch_fwd<64>(q, k, v, ld, o, lse, B, N, H, scale, s);
    case 128: return (int)launch_fwd<128>(q, k, v, ld, o, lse, B, N, H, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int ddm_flash_bwd(const void* q, const void* k, const void* v, int ld, const void* o,
                             const void* dout, const void* lse, void* dsum, void* dqkv, int B,
                             int N, int H, int Dh, float scale, void* stream) {
  using namespace ddm;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (Dh) {
    case 32: return (int)launch_bwd<32>(q, k, v, ld, o, dout, lse, dsum, dqkv, B, N, H, scale, s);
    case 64: return (int)launch_bwd<64>(q, k, v, ld, o, dout, lse, dsum, dqkv, B, N, H, scale, s);
    case 128:
      return (int)launch_bwd<128>(q, k, v, ld, o, dout, lse, dsum, dqkv, B, N, H, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
