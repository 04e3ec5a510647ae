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
