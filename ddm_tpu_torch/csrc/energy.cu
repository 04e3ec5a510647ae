// Generalized energy score: confinement and interaction terms and their
// gradient, over (B, m, D) fp32 predictions and (B, D) fp32 targets.
//
// Replaces ddm_tpu/ops/energy.py `_fwd_kernel` (K3f, via `_fused_fwd_call`)
// and `_bwd_kernel` (K3b, via `_fused_bwd`):
//   conf  = mean_{b,i} pow(|x_bi - x0_b|^2),
//   inter = mean_{b, i != j} pow(|x_bi - x_bj|^2),
//   pow(d) = (d + 1e-12)^(beta / 2), exactly d at beta = 2,
// from direct differences (the Gram form diverged training at fractional
// beta, ddm_tpu/ops/losses.py), all in fp32.
//
// What bounds it on the H100: one image's m x D predictions (96 KB at m = 8,
// D = 3072) are read once and held in shared memory while the block forms
// all m + m(m-1)/2 distances from them, so the kernel reads the 25 MB of
// predictions once per pass: bandwidth and latency, not arithmetic. The TPU
// kernel summed the two scalars across its sequential grid; here each block
// writes its image's partial sums and a second one-block kernel adds the B
// partials in a fixed order, so the result does not depend on scheduling.
// The backward recomputes the distances and writes dx_hat and dx0 rows.
#include "common.cuh"

namespace ddm {
namespace {

constexpr int kThreads = 256;
constexpr int kMaxM = 16;
constexpr int kMaxPairs = kMaxM + kMaxM * (kMaxM - 1) / 2;
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

// Load image b's predictions (m x D) and target (D) into shared memory and
// write its m + m(m-1)/2 squared distances into d2 (one warp per pair).
__device__ void image_distances(const float* __restrict__ xh, const float* __restrict__ x0,
                                float* xs, float* x0s, float* d2, int m, int D) {
  const int b = blockIdx.x;
  const float4* src = reinterpret_cast<const float4*>(xh + (size_t)b * m * D);
  for (int i = threadIdx.x; i < m * D / 4; i += kThreads)
    reinterpret_cast<float4*>(xs)[i] = src[i];
  const float4* src0 = reinterpret_cast<const float4*>(x0 + (size_t)b * D);
  for (int i = threadIdx.x; i < D / 4; i += kThreads) reinterpret_cast<float4*>(x0s)[i] = src0[i];
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int npairs = m + m * (m - 1) / 2;
  for (int p = warp; p < npairs; p += kThreads / 32) {
    int i, j;
    pair_rows(p, m, &i, &j);
    const float4* a = reinterpret_cast<const float4*>(xs + (size_t)i * D);
    const float4* c = reinterpret_cast<const float4*>(j < 0 ? x0s : xs + (size_t)j * D);
    float s = 0.f;
    for (int k = lane; k < D / 4; k += 32) {
      const float4 u = a[k], v = c[k];
      const float d0 = u.x - v.x, d1 = u.y - v.y, d2v = u.z - v.z, d3 = u.w - v.w;
      s += d0 * d0 + d1 * d1 + d2v * d2v + d3 * d3;
    }
    s = warp_sum(s);
    if (lane == 0) d2[p] = s;
  }
  __syncthreads();
}

// partial[b] = (sum_i pow(d2_i0), 2 sum_{i<j} pow(d2_ij)) for image b.
__global__ void __launch_bounds__(kThreads)
energy_fwd_kernel(const float* __restrict__ xh, const float* __restrict__ x0,
                  float* __restrict__ partial, int m, int D, float beta) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float d2[kMaxPairs];
  float* xs = reinterpret_cast<float*>(smem);
  image_distances(xh, x0, xs, xs + (size_t)m * D, d2, m, D);
  if (threadIdx.x == 0) {
    float conf = 0.f, inter = 0.f;
    for (int p = 0; p < m; ++p) conf += pow_beta(d2[p], beta);
    for (int p = m; p < m + m * (m - 1) / 2; ++p) inter += pow_beta(d2[p], beta);
    partial[2 * blockIdx.x] = conf;
    partial[2 * blockIdx.x + 1] = 2.0f * inter;
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

// g = (gconf / (B m), ginter / (B m (m-1))) on the device. For image b:
//   dxh_i = 2 g0 dpow(d2_i0) (x_i - x0) + sum_{j != i} 4 g1 dpow(d2_ij) (x_i - x_j)
//   dx0   = -sum_i 2 g0 dpow(d2_i0) (x_i - x0)
__global__ void __launch_bounds__(kThreads)
energy_bwd_kernel(const float* __restrict__ xh, const float* __restrict__ x0,
                  const float* __restrict__ g, float* __restrict__ dxh,
                  float* __restrict__ dx0, int m, int D, float beta) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float d2[kMaxPairs];
  __shared__ float coef[kMaxPairs];
  float* xs = reinterpret_cast<float*>(smem);
  float* x0s = xs + (size_t)m * D;
  image_distances(xh, x0, xs, x0s, d2, m, D);
  const int npairs = m + m * (m - 1) / 2;
  for (int p = threadIdx.x; p < npairs; p += kThreads)
    coef[p] = (p < m ? 2.0f * g[0] : 4.0f * g[1]) * dpow_beta(d2[p], beta);
  __syncthreads();

  const size_t b = blockIdx.x;
  for (int c = threadIdx.x; c < D; c += kThreads) {
    const float t = x0s[c];
    float d0 = 0.f;
    for (int i = 0; i < m; ++i) {
      const float xi = xs[(size_t)i * D + c];
      const float gi = coef[i] * (xi - t);
      float acc = gi;
      d0 -= gi;
      for (int j = 0; j < m; ++j) {
        if (j == i) continue;
        const int q = i < j ? pair_index(i, j, m) : pair_index(j, i, m);
        acc += coef[q] * (xi - xs[(size_t)j * D + c]);
      }
      dxh[(b * m + i) * D + c] = acc;
    }
    dx0[b * D + c] = d0;
  }
}

size_t energy_smem(int m, int D) { return (size_t)(m + 1) * D * sizeof(float); }

}  // namespace
}  // namespace ddm

// out[2] = (conf, inter); partial holds B x 2 floats of scratch.
extern "C" int ddm_energy_fwd(const void* xh, const void* x0, void* partial, void* out, int B,
                              int m, int D, float beta, void* stream) {
  using namespace ddm;
  const size_t smem = energy_smem(m, D);
  cudaError_t err = cudaFuncSetAttribute(energy_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  energy_fwd_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)xh, (const float*)x0, (float*)partial, m, D, beta);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  energy_sum_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>((const float*)partial,
                                                             (float*)out, B, m);
  return (int)cudaGetLastError();
}

extern "C" int ddm_energy_bwd(const void* xh, const void* x0, const void* g, void* dxh,
                              void* dx0, int B, int m, int D, float beta, void* stream) {
  using namespace ddm;
  const size_t smem = energy_smem(m, D);
  cudaError_t err = cudaFuncSetAttribute(energy_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  energy_bwd_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)xh, (const float*)x0, (const float*)g, (float*)dxh, (float*)dx0, m, D,
      beta);
  return (int)cudaGetLastError();
}
