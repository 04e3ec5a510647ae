// Generalized energy score: confinement and interaction terms and their
// gradient, over (B, m, D) fp32 predictions and (B, D) fp32 targets.
//
// Replaces ddm_tpu/ops/energy.py `_fwd_kernel` (K3f, via `_fused_fwd_call`)
// and `_bwd_kernel` (K3b, via `_fused_bwd`), the TPU's kernels for
// 2 <= m <= 16, and `_fwd_kernel_stream` (K9f, via `_stream_fwd_call`) and
// `_bwd_kernel_stream` (K9b, via `_stream_bwd`), its anchor-streaming ones
// for 16 < m <= 64:
//   conf  = mean_{b,i} pow(|x_bi - x0_b|^2),
//   inter = mean_{b, i != j} pow(|x_bi - x_bj|^2),
//   pow(d) = (d + 1e-12)^(beta / 2), exactly d at beta = 2,
// from direct differences (the Gram form diverged training at fractional
// beta, ddm_tpu/ops/losses.py), all in fp32.
//
// What bounds it on the H100: reading the predictions (25 MB at (256, 8,
// 3072), 100 MB at (256, 32, 3072)) once per pass, and writing their
// gradient: bandwidth and latency, not arithmetic. The TPU kernels summed
// the two scalars across their sequential grid; here every cross-block sum
// is a partial added in a fixed order by a later kernel, so the result does
// not depend on scheduling and a second call gives the same bits.
//
// One D-tiled design for K3 and K9 (an image's rows need not fit a block:
// K9's (32, 3072) predictions are 384 KB, K3's (4, 12288) and target of the
// 64-px recipe 240 KB): block (c, b) holds a chunk of L columns of image b's m + 1 rows and
// writes the pairs' partial distances; one block per image sums the chunks
// in order and applies pow (forward) or the pair weights' dpow (backward);
// the backward's last pass writes each chunk of every gradient row from the
// chunk and the weights, each anchor row complete in one pass as
// `_bwd_kernel_stream` has it.
#include "common.cuh"

namespace ddm {
namespace {

constexpr int kThreads = 256;
constexpr float kStabEps = 1e-12f;

__device__ __forceinline__ float pow_beta(float d2, float beta) {
  return beta == 2.0f ? d2 : powf(d2 + kStabEps, 0.5f * beta);
}

__device__ __forceinline__ float dpow_beta(float d2, float beta) {
  return beta == 2.0f ? 1.0f : (0.5f * beta) * powf(d2 + kStabEps, 0.5f * beta - 1.0f);
}

// Pair p < m is (x_p, x0); pair m + q is the q-th (i, j), i < j, in
// lexicographic order.
__device__ __forceinline__ void pair_rows(int p, int m, int* i, int* j) {
  if (p < m) {
    *i = p;
    *j = -1;
    return;
  }
  int q = p - m, a = 0;
  while (q >= m - 1 - a) {
    q -= m - 1 - a;
    ++a;
  }
  *i = a;
  *j = a + 1 + q;
}

__device__ __forceinline__ int pair_index(int i, int j, int m) {  // i < j
  return m + i * (2 * m - i - 1) / 2 + (j - i - 1);
}

// Rows [c0, c0 + L) of image b's m predictions, then of its target, into
// xs (m + 1 rows of L fp32 values).
__device__ void load_rows(const float* __restrict__ xh, const float* __restrict__ x0, float* xs,
                          int b, int m, int D, int c0, int L) {
  const int vecs = L / 4;
  for (int idx = threadIdx.x; idx < (m + 1) * vecs; idx += kThreads) {
    const int r = idx / vecs, k = idx % vecs;
    const float* src = r < m ? xh + ((size_t)b * m + r) * D + c0 : x0 + (size_t)b * D + c0;
    reinterpret_cast<float4*>(xs + (size_t)r * L)[k] = reinterpret_cast<const float4*>(src)[k];
  }
}

// d2[p] for the m + m(m-1)/2 pairs over the L columns of the rows in xs
// (one warp per pair, direct differences).
__device__ void pair_distances(const float* xs, float* d2, int m, int L) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int npairs = m + m * (m - 1) / 2;
  for (int p = warp; p < npairs; p += kThreads / 32) {
    int i, j;
    pair_rows(p, m, &i, &j);
    const float4* a = reinterpret_cast<const float4*>(xs + (size_t)i * L);
    const float4* c = reinterpret_cast<const float4*>(xs + (size_t)(j < 0 ? m : j) * L);
    float s = 0.f;
    for (int k = lane; k < L / 4; k += 32) {
      const float4 u = a[k], v = c[k];
      const float d0 = u.x - v.x, d1 = u.y - v.y, d2v = u.z - v.z, d3 = u.w - v.w;
      s += d0 * d0 + d1 * d1 + d2v * d2v + d3 * d3;
    }
    s = warp_sum(s);
    if (lane == 0) d2[p] = s;
  }
}

// out = (sum_b conf_b / (B m), sum_b inter_b / (B m (m-1))), one block, in a
// fixed order: thread t sums b = t, t + 256, ..., then a fixed tree.
__global__ void __launch_bounds__(kThreads)
energy_sum_kernel(const float* __restrict__ partial, float* __restrict__ out, int B, int m) {
  __shared__ float sc[kThreads], si[kThreads];
  float c = 0.f, v = 0.f;
  for (int b = threadIdx.x; b < B; b += kThreads) {
    c += partial[2 * b];
    v += partial[2 * b + 1];
  }
  sc[threadIdx.x] = c;
  si[threadIdx.x] = v;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
      sc[threadIdx.x] += sc[threadIdx.x + s];
      si[threadIdx.x] += si[threadIdx.x + s];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    out[0] = sc[0] / (float)(B * m);
    out[1] = si[0] / (float)(B * m * (m - 1));
  }
}

// ---- Block (c, b) of a (D / L, B) grid holds columns [c L, (c + 1) L) of
// image b's m + 1 rows.

// part[(b * nc + c) * npairs + p] = the pair's squared distance over chunk c.
__global__ void __launch_bounds__(kThreads)
energy_chunk_d2_kernel(const float* __restrict__ xh, const float* __restrict__ x0,
                       float* __restrict__ part, int m, int D, int L) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);
  const int npairs = m + m * (m - 1) / 2;
  load_rows(xh, x0, xs, blockIdx.y, m, D, blockIdx.x * L, L);
  __syncthreads();
  pair_distances(xs, part + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * npairs, m, L);
}

// One block per image: d2_p = the nc chunk partials summed in chunk order.
// With coef, writes coef[b, p] = (p < m ? 2 g0 : 4 g1) dpow(d2_p) (the
// backward's pair weights); else partial[b] = (sum_i pow(d2_i0),
// 2 sum_{i<j} pow(d2_ij)), thread t summing pairs t, t + 256, ... and the
// threads then added by a fixed tree.
__global__ void __launch_bounds__(kThreads)
energy_pair_kernel(const float* __restrict__ part, int nc, int m, float beta,
                   const float* __restrict__ g, float* __restrict__ coef,
                   float* __restrict__ partial) {
  __shared__ float sc[kThreads], si[kThreads];
  const int b = blockIdx.x, npairs = m + m * (m - 1) / 2;
  const float* pb = part + (size_t)b * nc * npairs;
  float c = 0.f, v = 0.f;
  for (int p = threadIdx.x; p < npairs; p += kThreads) {
    float d2 = 0.f;
    for (int k = 0; k < nc; ++k) d2 += pb[(size_t)k * npairs + p];
    if (coef != nullptr)
      coef[(size_t)b * npairs + p] = (p < m ? 2.0f * g[0] : 4.0f * g[1]) * dpow_beta(d2, beta);
    else if (p < m)
      c += pow_beta(d2, beta);
    else
      v += pow_beta(d2, beta);
  }
  if (coef != nullptr) return;
  sc[threadIdx.x] = c;
  si[threadIdx.x] = v;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
      sc[threadIdx.x] += sc[threadIdx.x + s];
      si[threadIdx.x] += si[threadIdx.x + s];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    partial[2 * b] = sc[0];
    partial[2 * b + 1] = 2.0f * si[0];
  }
}

// The gradient rows of chunk c of image b, one thread per column, from the
// pair weights: W[i][j] (zero on the diagonal) and the confinement weights
// in shared memory beside the rows; each anchor row is complete in one pass
// (ddm_tpu/ops/energy.py `_bwd_kernel_stream`):
//   dxh_i = w0_i (x_i - x0) + sum_j W_ij (x_i - x_j),  dx0 = -sum_i w0_i (x_i - x0).
__global__ void __launch_bounds__(kThreads)
energy_chunk_bwd_kernel(const float* __restrict__ xh, const float* __restrict__ x0,
                        const float* __restrict__ coef, float* __restrict__ dxh,
                        float* __restrict__ dx0, int m, int D, int L) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);
  float* W = xs + (size_t)(m + 1) * L;
  float* w0 = W + m * m;
  const int b = blockIdx.y, col0 = blockIdx.x * L;
  const float* cb = coef + (size_t)b * (m + m * (m - 1) / 2);
  load_rows(xh, x0, xs, b, m, D, col0, L);
  for (int t = threadIdx.x; t < m * m; t += kThreads) {
    const int i = t / m, j = t % m;
    W[t] = i == j ? 0.f : cb[i < j ? pair_index(i, j, m) : pair_index(j, i, m)];
  }
  for (int i = threadIdx.x; i < m; i += kThreads) w0[i] = cb[i];
  __syncthreads();

  for (int k = threadIdx.x; k < L; k += kThreads) {
    const float t = xs[(size_t)m * L + k];
    float d0 = 0.f;
    for (int i = 0; i < m; ++i) {
      const float xi = xs[(size_t)i * L + k];
      const float gi = w0[i] * (xi - t);
      float acc = gi;
      d0 -= gi;
      for (int j = 0; j < m; ++j) acc += W[i * m + j] * (xi - xs[(size_t)j * L + k]);
      dxh[((size_t)b * m + i) * D + col0 + k] = acc;
    }
    dx0[(size_t)b * D + col0 + k] = d0;
  }
}

size_t chunk_smem(int m, int L) { return (size_t)(m + 1) * L * sizeof(float); }

size_t chunk_bwd_smem(int m, int L) { return chunk_smem(m, L) + (size_t)(m * m + m) * sizeof(float); }

cudaError_t set_smem(const void* kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// Pass 1 of both entry points: every chunk's pair distances into part.
cudaError_t chunk_distances(const float* xh, const float* x0, float* part, int B, int m, int D,
                            int L, cudaStream_t stream) {
  const size_t smem = chunk_smem(m, L);
  cudaError_t err = set_smem((const void*)energy_chunk_d2_kernel, smem);
  if (err != cudaSuccess) return err;
  energy_chunk_d2_kernel<<<dim3(D / L, B), kThreads, smem, stream>>>(xh, x0, part, m, D, L);
  return cudaGetLastError();
}

}  // namespace
}  // namespace ddm

// The forward (K3f, K9f): part holds B x (D / L) x (m + m(m-1)/2) floats
// of scratch, partial B x 2, out[2] = (conf, inter).
extern "C" int ddm_energy_fwd(const void* xh, const void* x0, void* part, void* partial,
                              void* out, int B, int m, int D, int L, float beta, void* stream) {
  using namespace ddm;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = chunk_distances((const float*)xh, (const float*)x0, (float*)part, B, m, D, L, s);
  if (err != cudaSuccess) return (int)err;
  energy_pair_kernel<<<B, kThreads, 0, s>>>((const float*)part, D / L, m, beta, nullptr, nullptr,
                                            (float*)partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  energy_sum_kernel<<<1, kThreads, 0, s>>>((const float*)partial, (float*)out, B, m);
  return (int)cudaGetLastError();
}

// The backward (K3b, K9b), with g = (gconf / (B m), ginter / (B m (m-1)))
// on the device: the distances again, the pair weights into coef
// (B x (m + m(m-1)/2)), then the gradient rows.
extern "C" int ddm_energy_bwd(const void* xh, const void* x0, const void* g, void* part,
                              void* coef, void* dxh, void* dx0, int B, int m, int D, int L,
                              float beta, void* stream) {
  using namespace ddm;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = chunk_distances((const float*)xh, (const float*)x0, (float*)part, B, m, D, L, s);
  if (err != cudaSuccess) return (int)err;
  energy_pair_kernel<<<B, kThreads, 0, s>>>((const float*)part, D / L, m, beta, (const float*)g,
                                            (float*)coef, nullptr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = chunk_bwd_smem(m, L);
  err = set_smem((const void*)energy_chunk_bwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  energy_chunk_bwd_kernel<<<dim3(D / L, B), kThreads, smem, s>>>(
      (const float*)xh, (const float*)x0, (const float*)coef, (float*)dxh, (float*)dx0, m, D, L);
  return (int)cudaGetLastError();
}
