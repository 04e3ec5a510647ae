// Multi-head attention core of the DiT attention half-block, one block per
// (image, head).
//
// Replaces the attention part of ddm_tpu/ops/attention.py `_blk_fwd_kernel`
// (`_mha_packed_fwd`); gemm.cu holds the LN + qkv product before it and the
// projection + residual after it.
//
// What bounds it on the H100: at DiT-S/4 (N = 64 tokens, Dh = 64) one
// (image, head) pair is 1 MFLOP over 24 KB of q/k/v, so the core is bound by
// reading qkv and writing the output (~50 MB per call at B = 256), and by
// latency: the tiles are far too small to fill a tensor core for long. The
// TPU kernel packed several images into one block-diagonal masked product
// to fill its 128-wide matrix unit; here one image's N = 64 is already a
// whole tile, so there is no packing and no mask: Q, K and V (3 x 64 x 64
// bf16) and the fp32 scores (64 x 64) live in shared memory, the softmax is
// fp32 and max-subtracted, the probabilities are rounded to bf16, and P V
// accumulates in fp32 before one rounding to bf16.
//
// attention_core_bwd_kernel replaces the per-head core of the persist-probs
// backward, ddm_tpu/ops/attention.py `_blk_bwd_kernel` (K2b), again one
// block per (image, head): it recomputes P from Q and K, keeps the fp32 P
// and dP tiles and Q, K, V, dO in shared memory (81 KB at N = Dh = 64), and
// writes dq, dk, dv into the [q | k | v] heads-contiguous dqkv rows. The
// roundings are the TPU kernel's: dv = bf16(bf16(P)^T dO), dP = dO V^T in
// fp32, dS = bf16(scale * P * (dP - rowsum(P * dP))) with the fp32 P,
// dq = bf16(dS K), dk = bf16(dS^T Q).
//
// From the one fp32 P it also writes att = bf16(bf16(P) V), the attention
// output that the projection's weight gradient reads. That makes it the
// core of the split backward K4 as well, ddm_tpu/ops/attention.py
// `_blk_bwd_split_kernel` (DiT-B and DiT-L widths), which persists att for
// XLA's dW products for the same reason; its single loop over the (pack,
// head) tiles (:753-786) is this block's body. The TPU needs two kernels
// because of VMEM; on the H100 K2b and K4 share this one, and K2b needs no
// second launch of the forward core for att. One extra 64 x 64 x 64
// product per (image, head) and no extra shared memory: O goes through the
// fp32 tile that dv left, before dP takes it.
#include "common.cuh"

namespace ddm {
namespace {

constexpr int kThreads = 128;  // 4 warps

__global__ void __launch_bounds__(kThreads)
attention_core_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out, int N, int H,
                      int Dh, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int D = H * Dh;
  const int QLD = Dh + kPadH, SLD = max(N, Dh) + kPadF, PLD = N + kPadH;
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + N * QLD;
  bf16* Vs = Ks + N * QLD;
  float* S = reinterpret_cast<float*>(Vs + N * QLD);  // scores, then the output
  bf16* P = reinterpret_cast<bf16*>(S + N * SLD);

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nwarps = kThreads / 32;
  const bf16* base = qkv + (size_t)b * N * 3 * D + h * Dh;

  const int dVec = Dh / 8;
  for (int i = threadIdx.x; i < N * dVec; i += kThreads) {
    const int r = i / dVec, c = (i % dVec) * 8;
    const bf16* src = base + (size_t)r * 3 * D + c;
    *reinterpret_cast<uint4*>(Qs + r * QLD + c) = *reinterpret_cast<const uint4*>(src);
    *reinterpret_cast<uint4*>(Ks + r * QLD + c) = *reinterpret_cast<const uint4*>(src + D);
    *reinterpret_cast<uint4*>(Vs + r * QLD + c) = *reinterpret_cast<const uint4*>(src + 2 * D);
  }
  __syncthreads();

  // S = Q K^T (fp32)
  const int nt = N / kFrag;
  for (int t = warp; t < nt * nt; t += nwarps) {
    const int ti = t / nt, tj = t % nt;
    FragC acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int kk = 0; kk < Dh; kk += kFrag) {
      FragA a;
      FragBCol bk;
      wmma::load_matrix_sync(a, Qs + ti * kFrag * QLD + kk, QLD);
      wmma::load_matrix_sync(bk, Ks + tj * kFrag * QLD + kk, QLD);
      wmma::mma_sync(acc, a, bk, acc);
    }
    wmma::store_matrix_sync(S + ti * kFrag * SLD + tj * kFrag, acc, SLD, wmma::mem_row_major);
  }
  __syncthreads();

  // row softmax in fp32: e = exp(s*scale - max), p = bf16(e / sum)
  for (int r = warp; r < N; r += nwarps) {
    float* srow = S + r * SLD;
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
    for (int c = lane; c < N; c += 32) P[r * PLD + c] = __float2bfloat16(srow[c] / sum);
  }
  __syncthreads();

  // O = P V (fp32), written over the dead scores
  const int dt = Dh / kFrag;
  for (int t = warp; t < nt * dt; t += nwarps) {
    const int ti = t / dt, tj = t % dt;
    FragC acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int kk = 0; kk < N; kk += kFrag) {
      FragA a;
      FragBRow bv;
      wmma::load_matrix_sync(a, P + ti * kFrag * PLD + kk, PLD);
      wmma::load_matrix_sync(bv, Vs + kk * QLD + tj * kFrag, QLD);
      wmma::mma_sync(acc, a, bv, acc);
    }
    wmma::store_matrix_sync(S + ti * kFrag * SLD + tj * kFrag, acc, SLD, wmma::mem_row_major);
  }
  __syncthreads();

  bf16* dst = out + (size_t)b * N * D + h * Dh;
  for (int i = threadIdx.x; i < N * Dh / 2; i += kThreads) {
    const int r = i / (Dh / 2), c = 2 * (i % (Dh / 2));
    *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)r * D + c) =
        __floats2bfloat162_rn(S[r * SLD + c], S[r * SLD + c + 1]);
  }
}

// Write an (N x Dh) fp32 tile as bf16 into columns [col0, col0 + Dh) of the
// rows of one image in a row-major matrix with ld columns.
__device__ __forceinline__ void store_head(bf16* __restrict__ dst, int ld, const float* src,
                                           int sld, int N, int Dh) {
  for (int i = threadIdx.x; i < N * Dh / 2; i += kThreads) {
    const int r = i / (Dh / 2), c = 2 * (i % (Dh / 2));
    *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)r * ld + c) =
        __floats2bfloat162_rn(src[r * sld + c], src[r * sld + c + 1]);
  }
}

__global__ void __launch_bounds__(kThreads)
attention_core_bwd_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ datt,
                          bf16* __restrict__ att, bf16* __restrict__ dqkv, int N, int H,
                          int Dh, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int D = H * Dh;
  const int QLD = Dh + kPadH, SLD = max(N, Dh) + kPadF, PLD = N + kPadH;
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + N * QLD;
  bf16* Vs = Ks + N * QLD;
  bf16* dOs = Vs + N * QLD;
  float* P = reinterpret_cast<float*>(dOs + N * QLD);  // fp32 P, later dq
  float* F = P + N * SLD;                              // dv, dP, then dk
  bf16* Pb = reinterpret_cast<bf16*>(F + N * SLD);     // bf16 P, then bf16 dS

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nwarps = kThreads / 32;
  const bf16* base = qkv + (size_t)b * N * 3 * D + h * Dh;
  const bf16* dbase = datt + (size_t)b * N * D + h * Dh;

  const int dVec = Dh / 8;
  for (int i = threadIdx.x; i < N * dVec; i += kThreads) {
    const int r = i / dVec, c = (i % dVec) * 8;
    const bf16* src = base + (size_t)r * 3 * D + c;
    *reinterpret_cast<uint4*>(Qs + r * QLD + c) = *reinterpret_cast<const uint4*>(src);
    *reinterpret_cast<uint4*>(Ks + r * QLD + c) = *reinterpret_cast<const uint4*>(src + D);
    *reinterpret_cast<uint4*>(Vs + r * QLD + c) = *reinterpret_cast<const uint4*>(src + 2 * D);
    *reinterpret_cast<uint4*>(dOs + r * QLD + c) =
        *reinterpret_cast<const uint4*>(dbase + (size_t)r * D + c);
  }
  __syncthreads();

  const int nt = N / kFrag, dt = Dh / kFrag;
  // S = Q K^T
  for (int t = warp; t < nt * nt; t += nwarps) {
    const int ti = t / nt, tj = t % nt;
    FragC acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int kk = 0; kk < Dh; kk += kFrag) {
      FragA a;
      FragBCol bk;
      wmma::load_matrix_sync(a, Qs + ti * kFrag * QLD + kk, QLD);
      wmma::load_matrix_sync(bk, Ks + tj * kFrag * QLD + kk, QLD);
      wmma::mma_sync(acc, a, bk, acc);
    }
    wmma::store_matrix_sync(P + ti * kFrag * SLD + tj * kFrag, acc, SLD, wmma::mem_row_major);
  }
  __syncthreads();

  // P = softmax(scale * S) in fp32, kept; Pb = bf16(P)
  for (int r = warp; r < N; r += nwarps) {
    float* prow = P + r * SLD;
    float m = -INFINITY;
    for (int c = lane; c < N; c += 32) m = fmaxf(m, prow[c] * scale);
    m = warp_max(m);
    float sum = 0.f;
    for (int c = lane; c < N; c += 32) {
      const float e = expf(prow[c] * scale - m);
      prow[c] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int c = lane; c < N; c += 32) {
      const float p = prow[c] / sum;
      prow[c] = p;
      Pb[r * PLD + c] = __float2bfloat16(p);
    }
  }
  __syncthreads();

  // dv = Pb^T dO
  for (int t = warp; t < nt * dt; t += nwarps) {
    const int ti = t / dt, tj = t % dt;
    FragC acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int kk = 0; kk < N; kk += kFrag) {
      FragACol a;
      FragBRow bo;
      wmma::load_matrix_sync(a, Pb + kk * PLD + ti * kFrag, PLD);
      wmma::load_matrix_sync(bo, dOs + kk * QLD + tj * kFrag, QLD);
      wmma::mma_sync(acc, a, bo, acc);
    }
    wmma::store_matrix_sync(F + ti * kFrag * SLD + tj * kFrag, acc, SLD, wmma::mem_row_major);
  }
  __syncthreads();
  bf16* out = dqkv + (size_t)b * N * 3 * D + h * Dh;
  store_head(out + 2 * D, 3 * D, F, SLD, N, Dh);
  __syncthreads();

  // att = Pb V (fp32), rounded once, as the forward core computes it
  for (int t = warp; t < nt * dt; t += nwarps) {
    const int ti = t / dt, tj = t % dt;
    FragC acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int kk = 0; kk < N; kk += kFrag) {
      FragA a;
      FragBRow bv;
      wmma::load_matrix_sync(a, Pb + ti * kFrag * PLD + kk, PLD);
      wmma::load_matrix_sync(bv, Vs + kk * QLD + tj * kFrag, QLD);
      wmma::mma_sync(acc, a, bv, acc);
    }
    wmma::store_matrix_sync(F + ti * kFrag * SLD + tj * kFrag, acc, SLD, wmma::mem_row_major);
  }
  __syncthreads();
  store_head(att + (size_t)b * N * D + h * Dh, D, F, SLD, N, Dh);
  __syncthreads();

  // dP = dO V^T (fp32)
  for (int t = warp; t < nt * nt; t += nwarps) {
    const int ti = t / nt, tj = t % nt;
    FragC acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int kk = 0; kk < Dh; kk += kFrag) {
      FragA a;
      FragBCol bv;
      wmma::load_matrix_sync(a, dOs + ti * kFrag * QLD + kk, QLD);
      wmma::load_matrix_sync(bv, Vs + tj * kFrag * QLD + kk, QLD);
      wmma::mma_sync(acc, a, bv, acc);
    }
    wmma::store_matrix_sync(F + ti * kFrag * SLD + tj * kFrag, acc, SLD, wmma::mem_row_major);
  }
  __syncthreads();

  // dS = bf16(scale * P * (dP - rowsum(P * dP))), over Pb
  for (int r = warp; r < N; r += nwarps) {
    const float* prow = P + r * SLD;
    const float* drow = F + r * SLD;
    float s = 0.f;
    for (int c = lane; c < N; c += 32) s += prow[c] * drow[c];
    s = warp_sum(s);
    for (int c = lane; c < N; c += 32)
      Pb[r * PLD + c] = __float2bfloat16(prow[c] * (drow[c] - s) * scale);
  }
  __syncthreads();

  // dq = dS K (into P), dk = dS^T Q (into F)
  for (int t = warp; t < 2 * nt * dt; t += nwarps) {
    const bool is_k = t >= nt * dt;
    const int tt = is_k ? t - nt * dt : t;
    const int ti = tt / dt, tj = tt % dt;
    FragC acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int kk = 0; kk < N; kk += kFrag) {
      FragBRow bm;
      if (is_k) {
        FragACol a;
        wmma::load_matrix_sync(a, Pb + kk * PLD + ti * kFrag, PLD);
        wmma::load_matrix_sync(bm, Qs + kk * QLD + tj * kFrag, QLD);
        wmma::mma_sync(acc, a, bm, acc);
      } else {
        FragA a;
        wmma::load_matrix_sync(a, Pb + ti * kFrag * PLD + kk, PLD);
        wmma::load_matrix_sync(bm, Ks + kk * QLD + tj * kFrag, QLD);
        wmma::mma_sync(acc, a, bm, acc);
      }
    }
    wmma::store_matrix_sync((is_k ? F : P) + ti * kFrag * SLD + tj * kFrag, acc, SLD,
                            wmma::mem_row_major);
  }
  __syncthreads();
  store_head(out, 3 * D, P, SLD, N, Dh);
  store_head(out + D, 3 * D, F, SLD, N, Dh);
}

}  // namespace
}  // namespace ddm

extern "C" int ddm_attention_core(const void* qkv, void* out, int B, int N, int H, int Dh,
                                  float scale, void* stream) {
  using namespace ddm;
  const int sld = (N > Dh ? N : Dh) + kPadF;
  const size_t smem = (size_t)3 * N * (Dh + kPadH) * sizeof(bf16) +
                      (size_t)N * sld * sizeof(float) +
                      (size_t)N * (N + kPadH) * sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(attention_core_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  attention_core_kernel<<<B * H, kThreads, smem, (cudaStream_t)stream>>>(
      (const bf16*)qkv, (bf16*)out, N, H, Dh, scale);
  return (int)cudaGetLastError();
}

// K2b's and K4's core: dq, dk, dv into the (B, N, 3D) dqkv rows, and
// att = bf16(P V) (B, N, H*Dh).
extern "C" int ddm_attention_core_bwd_att(const void* qkv, const void* datt, void* att,
                                          void* dqkv, int B, int N, int H, int Dh, float scale,
                                          void* stream) {
  using namespace ddm;
  const int sld = (N > Dh ? N : Dh) + kPadF;
  const size_t smem = (size_t)4 * N * (Dh + kPadH) * sizeof(bf16) +
                      (size_t)2 * N * sld * sizeof(float) +
                      (size_t)N * (N + kPadH) * sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(attention_core_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  attention_core_bwd_kernel<<<B * H, kThreads, smem, (cudaStream_t)stream>>>(
      (const bf16*)qkv, (const bf16*)datt, (bf16*)att, (bf16*)dqkv, N, H, Dh, scale);
  return (int)cudaGetLastError();
}
