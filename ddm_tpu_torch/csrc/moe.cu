// MoE dispatch (LN2 -> router -> softmax -> top-k -> capacity queue -> slot
// rows) and combine (gate-scaled gather of the expert outputs, with the
// block's residual), forward and backward.
//
// Replaces the TPU kernels of ddm_tpu/ops/moe_dispatch.py:
//   * K11f `_dispatch_fwd_kernel` (`_route`, `_build_dd`): ddm_moe_dispatch_fwd;
//   * K11b `_dispatch_bwd_kernel` (with the `_thru` residual join):
//     ddm_moe_dispatch_bwd;
//   * K12f `_combine_fwd_kernel` (with the `_res` residual add):
//     ddm_moe_combine_fwd;
//   * K12b `_combine_bwd_kernel`: ddm_moe_combine_bwd.
//
// The TPU builds one-hot (gs, E*Cp) blocks and contracts them on the MXU.
// Here the same functions are a gather and a scatter of rows by slot index,
// one routing group per block, with no one-hot matrix:
//   * the queue: a token's slot in its expert is the count of that expert's
//     earlier first choices in the group (second choices queue after all
//     first choices). Thread e walks the group's tokens in order for expert
//     e; the kept slots of an expert are then the contiguous range
//     [0, min(cap, cnt1 + cnt2)), so each token writes its own slot rows
//     and the rest of the expert's Cp rows are written as zeros (the
//     expert FFN runs on every slot row, and uninitialised memory there
//     would reach dW through 0 * NaN);
//   * sums across groups (the aux statistics cnt and psum; dscale, dbias,
//     dwr, dbr) are per-group partials summed by reduce_rows in a fixed
//     order: no atomics, so the same inputs give the same bits.
//
// What bounds it on the H100: memory. At the DiT-S/4 training shape (T =
// 131,072 rows of D = 384, E = 8, gs = 256, Cp = 40) the dispatch reads x
// (101 MB) and writes xin (126 MB) plus the (T, E) routing tensors, about
// 0.07 ms at 3.35 TB/s; the combine reads the expert outputs and the
// residual and writes the tokens. The router product is 2*T*D*E = 0.8
// GFLOP in fp32. One warp handles one token row at a time (LN, router,
// softmax and top-k in registers and shuffles), so there is no on-chip
// reuse to win beyond that.
//
// Numerics follow the TPU kernels: LN statistics in fp32 with eps 1e-6 and
// a two-pass variance; yb = bf16(LN(x)); fp32 logits of fp32(yb) and fp32
// wr; softmax as exp(l - max) / sum; argmax keeps the first index on ties;
// top-2 renormalises with 1e-9; the `_res` combine rounds the combine to
// bf16 before adding the fp32 residual and rounds again.
#include "common.cuh"

namespace ddm {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxE = 32;      // one lane per expert
constexpr int kMaxPairs = 16;  // D <= 1024: bf16 pairs per lane
constexpr int kChunk = 32;     // rows per backward chunk (dwr from shared memory)
constexpr float kLnEps = 1e-6f;

struct Geometry {
  int G, gs, n_valid, D, E, cap, cpad, topk;
};

// Row `row` of x into registers as bf16 pairs (pair j = lane + 32 i covers
// columns 2j, 2j + 1); returns the count of pairs this lane holds.
__device__ __forceinline__ int load_row(const bf16* __restrict__ xr, int D, float (&v)[2 * kMaxPairs]) {
  const int lane = threadIdx.x % 32, np = D / 64;
  const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(xr);
#pragma unroll
  for (int i = 0; i < kMaxPairs; ++i) {
    if (i < np) {
      const float2 f = __bfloat1622float2(x2[lane + 32 * i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  return np;
}

__device__ __forceinline__ int col_of(int i) { return 2 * ((threadIdx.x % 32) + 32 * (i / 2)) + (i % 2); }

// fp32 LayerNorm statistics of a row held as in load_row: mean, then the
// centred variance.
__device__ __forceinline__ void ln_stats(const float (&v)[2 * kMaxPairs], int np, int D, float& mu,
                                         float& inv) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 2 * kMaxPairs; ++i)
    if (i < 2 * np) s += v[i];
  mu = warp_sum(s) / D;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < 2 * kMaxPairs; ++i)
    if (i < 2 * np) {
      const float d = v[i] - mu;
      q += d * d;
    }
  inv = rsqrtf(warp_sum(q) / D + kLnEps);
}

__device__ __forceinline__ float ln_y(float x, float mu, float inv, float s, float b) {
  return __fmaf_rn((x - mu) * inv, s, b);
}

// (value, index) argmax over the warp's lanes, first index on ties.
__device__ __forceinline__ void warp_argmax(float& v, int& idx) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, o);
    const int oi = __shfl_xor_sync(0xffffffffu, idx, o);
    if (ov > v || (ov == v && oi < idx)) {
      v = ov;
      idx = oi;
    }
  }
}

// The expert (or -1) and slot of a token's routed choice from its pos row
// (E fp32 values, -1 off route): lane e reads column e.
__device__ __forceinline__ void choice_of(const float* __restrict__ pos_row, int E, int& e,
                                          int& p) {
  const int lane = threadIdx.x % 32;
  const float v = lane < E ? pos_row[lane] : -1.f;
  const unsigned hit = __ballot_sync(0xffffffffu, v >= 0.f);
  e = hit ? __ffs(hit) - 1 : -1;
  p = (int)__shfl_sync(0xffffffffu, v, e < 0 ? 0 : e);
}

// Zero the slot rows [fill[e], Cp) of every expert in group g.
__device__ __forceinline__ void zero_unfilled(bf16* __restrict__ rows, const int* fill,
                                              const Geometry& q, int g) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t S = (size_t)q.G * q.cpad;
  for (int r = warp; r < q.E * q.cpad; r += kWarps) {
    const int e = r / q.cpad, c = r % q.cpad;
    if (c < fill[e]) continue;
    uint4* dst = reinterpret_cast<uint4*>(rows + ((size_t)e * S + (size_t)g * q.cpad + c) * q.D);
    for (int i = lane; i < q.D / 8; i += 32) dst[i] = make_uint4(0, 0, 0, 0);
  }
}

// ---------------------------------------------------------------- K11f

__global__ void __launch_bounds__(kThreads)
dispatch_fwd_kernel(const bf16* __restrict__ x, const float* __restrict__ scale,
                    const float* __restrict__ bias, const float* __restrict__ wr,
                    const float* __restrict__ br, bf16* __restrict__ xin,
                    float* __restrict__ gates, float* __restrict__ pos1,
                    float* __restrict__ pos2, float* __restrict__ probs,
                    float* __restrict__ part, Geometry q) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* mu_s = reinterpret_cast<float*>(smem);
  float* inv_s = mu_s + q.gs;
  int* idx1 = reinterpret_cast<int*>(inv_s + q.gs);
  int* idx2 = idx1 + q.gs;
  int* slot1 = idx2 + q.gs;
  int* slot2 = slot1 + q.gs;
  __shared__ float psum_w[kWarps][kMaxE];
  __shared__ int fill[kMaxE];

  const int g = blockIdx.x, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int E = q.E, D = q.D;
  float psum_acc = 0.f;

  // 1: per row, LN -> router -> softmax -> top-k (one warp per row)
  for (int t = warp; t < q.gs; t += kWarps) {
    const size_t row = (size_t)g * q.gs + t;
    const bool valid = row < (size_t)q.n_valid;
    float v[2 * kMaxPairs];
    const int np = load_row(x + row * D, D, v);
    float mu, inv;
    ln_stats(v, np, D, mu, inv);
#pragma unroll
    for (int i = 0; i < 2 * kMaxPairs; ++i)
      if (i < 2 * np) {
        const int c = col_of(i);
        v[i] = __bfloat162float(__float2bfloat16(ln_y(v[i], mu, inv, scale[c], bias[c])));
      }
    float logit = -INFINITY;
    for (int e = 0; e < E; ++e) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < 2 * kMaxPairs; ++i)
        if (i < 2 * np) s += v[i] * wr[(size_t)col_of(i) * E + e];
      s = warp_sum(s);
      if (lane == e) logit = s + br[e];
    }
    const float mx = warp_max(logit);
    const float ex = lane < E ? expf(logit - mx) : 0.f;
    const float p = ex / warp_sum(ex);
    if (lane < E) probs[row * E + lane] = p;
    psum_acc += (valid && lane < E) ? p : 0.f;

    float v1 = lane < E ? p : -INFINITY;
    int i1 = lane < E ? lane : kMaxE;
    warp_argmax(v1, i1);
    float g1 = v1, g2 = 0.f;
    int i2 = -1;
    if (q.topk == 2) {
      float v2 = (lane < E && lane != i1) ? p : -INFINITY;
      i2 = lane < E && lane != i1 ? lane : kMaxE;
      warp_argmax(v2, i2);
      const float denom = v1 + v2 + 1e-9f;
      g1 = v1 / denom;
      g2 = v2 / denom;
    }
    if (lane == 0) {
      mu_s[t] = mu;
      inv_s[t] = inv;
      idx1[t] = valid ? i1 : -1;
      idx2[t] = valid ? i2 : -1;
      gates[row * 2] = valid ? g1 : 0.f;
      gates[row * 2 + 1] = valid ? g2 : 0.f;
    }
  }
  if (lane < kMaxE) psum_w[warp][lane] = psum_acc;
  __syncthreads();

  // 2: the capacity queue, one thread per expert walking the tokens in order
  if (threadIdx.x < E) {
    const int e = threadIdx.x;
    int c = 0;
    for (int t = 0; t < q.gs; ++t)
      if (idx1[t] == e) slot1[t] = c++;
    const int cnt1 = c;
    if (q.topk == 2)
      for (int t = 0; t < q.gs; ++t)
        if (idx2[t] == e) slot2[t] = c++;
    fill[e] = min(q.cap, c);
    float ps = 0.f;
    for (int w = 0; w < kWarps; ++w) ps += psum_w[w][e];
    part[(size_t)g * 2 * E + e] = (float)cnt1;
    part[(size_t)g * 2 * E + E + e] = ps;
  }
  __syncthreads();

  // 3: positions, the kept tokens' slot rows, zeros in every other slot row
  for (int i = threadIdx.x; i < q.gs * E; i += kThreads) {
    const int t = i / E, e = i % E;
    const size_t o = ((size_t)g * q.gs + t) * E + e;
    pos1[o] = idx1[t] == e ? (float)slot1[t] : -1.f;
    pos2[o] = (q.topk == 2 && idx2[t] == e) ? (float)slot2[t] : -1.f;
  }
  const size_t S = (size_t)q.G * q.cpad;
  for (int t = warp; t < q.gs; t += kWarps) {
    const int e1 = idx1[t], e2 = q.topk == 2 ? idx2[t] : -1;
    const int c1 = e1 >= 0 ? slot1[t] : q.cap, c2 = e2 >= 0 ? slot2[t] : q.cap;
    if (c1 >= q.cap && c2 >= q.cap) continue;
    const size_t row = (size_t)g * q.gs + t;
    const float mu = mu_s[t], inv = inv_s[t];
    const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(x + row * D);
    __nv_bfloat162* d1 = c1 < q.cap ? reinterpret_cast<__nv_bfloat162*>(
        xin + ((size_t)e1 * S + (size_t)g * q.cpad + c1) * D) : nullptr;
    __nv_bfloat162* d2 = c2 < q.cap ? reinterpret_cast<__nv_bfloat162*>(
        xin + ((size_t)e2 * S + (size_t)g * q.cpad + c2) * D) : nullptr;
    for (int j = lane; j < D / 2; j += 32) {
      const float2 f = __bfloat1622float2(x2[j]);
      const int c = 2 * j;
      const __nv_bfloat162 y = __floats2bfloat162_rn(
          ln_y(f.x, mu, inv, scale[c], bias[c]), ln_y(f.y, mu, inv, scale[c + 1], bias[c + 1]));
      if (d1) d1[j] = y;
      if (d2) d2[j] = y;
    }
  }
  zero_unfilled(xin, fill, q, g);
}

// ---------------------------------------------------------------- K11b

__global__ void __launch_bounds__(kThreads)
dispatch_bwd_kernel(const bf16* __restrict__ x, const float* __restrict__ scale,
                    const float* __restrict__ bias, const float* __restrict__ wr,
                    const float* __restrict__ pos1, const float* __restrict__ pos2,
                    const float* __restrict__ probs, const bf16* __restrict__ dxin,
                    const float* __restrict__ dgates, const float* __restrict__ dpsum,
                    const bf16* __restrict__ dres, bf16* __restrict__ dx,
                    float* __restrict__ part, Geometry q) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int E = q.E, D = q.D;
  float* acc_sb = reinterpret_cast<float*>(smem);        // [kWarps][2][D]
  float* dwr_acc = acc_sb + kWarps * 2 * D;               // [D * E]
  float* dl_s = dwr_acc + D * E;                          // [kChunk][E]
  bf16* yb_s = reinterpret_cast<bf16*>(dl_s + kChunk * E);  // [kChunk][D]
  __shared__ float dbr_acc[kMaxE];

  const int g = blockIdx.x, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = threadIdx.x; i < kWarps * 2 * D; i += kThreads) acc_sb[i] = 0.f;
  for (int i = threadIdx.x; i < D * E; i += kThreads) dwr_acc[i] = 0.f;
  if (threadIdx.x < kMaxE) dbr_acc[threadIdx.x] = 0.f;
  float* wsc = acc_sb + (size_t)warp * 2 * D;
  const size_t S = (size_t)q.G * q.cpad;
  __syncthreads();

  for (int t0 = 0; t0 < q.gs; t0 += kChunk) {
    const int nrows = min(kChunk, q.gs - t0);
    // 1: per row (one warp per row), the LN recompute, dyb from the kept
    // slots, the router/softmax backward, dy and the LN backward
    for (int r = warp; r < nrows; r += kWarps) {
      const int t = t0 + r;
      const size_t row = (size_t)g * q.gs + t;
      const bool valid = row < (size_t)q.n_valid;
      float v[2 * kMaxPairs], dy[2 * kMaxPairs];
      const int np = load_row(x + row * D, D, v);
      float mu, inv;
      ln_stats(v, np, D, mu, inv);
#pragma unroll
      for (int i = 0; i < 2 * kMaxPairs; ++i)
        if (i < 2 * np) {
          const int c = col_of(i);
          v[i] = (v[i] - mu) * inv;  // xhat from here on
          yb_s[r * D + c] = __float2bfloat16(__fmaf_rn(v[i], scale[c], bias[c]));
          dy[i] = 0.f;
        }
      int e1, p1, e2 = -1, p2 = 0;
      choice_of(pos1 + row * E, E, e1, p1);
      if (q.topk == 2) choice_of(pos2 + row * E, E, e2, p2);
      for (int k = 0; k < 2; ++k) {
        const int e = k ? e2 : e1, p = k ? p2 : p1;
        if (e < 0 || p >= q.cap) continue;
        const bf16* src = dxin + ((size_t)e * S + (size_t)g * q.cpad + p) * D;
#pragma unroll
        for (int i = 0; i < 2 * kMaxPairs; ++i)
          if (i < 2 * np) dy[i] += __bfloat162float(src[col_of(i)]);
      }
      const float pr = lane < E ? probs[row * E + lane] : 0.f;
      float dprobs = (valid && lane < E) ? dpsum[lane] : 0.f;
      const float oh1 = lane == e1 ? 1.f : 0.f, oh2 = lane == e2 ? 1.f : 0.f;
      const float dg1 = dgates[row * 2], dg2 = dgates[row * 2 + 1];
      if (q.topk == 1) {
        dprobs += dg1 * oh1;
      } else {
        const float p1v = warp_sum(pr * oh1), p2v = warp_sum(pr * oh2);
        const float s = p1v + p2v + 1e-9f;
        const float inv_s2 = 1.0f / (s * s);
        const float dp1 = (dg1 * (p2v + 1e-9f) - dg2 * p2v) * inv_s2;
        const float dp2 = (dg2 * (p1v + 1e-9f) - dg1 * p1v) * inv_s2;
        dprobs = dprobs + dp1 * oh1 + dp2 * oh2;
      }
      const float dl = pr * (dprobs - warp_sum(dprobs * pr));
      if (lane < E) dl_s[r * E + lane] = dl;
#pragma unroll
      for (int i = 0; i < 2 * kMaxPairs; ++i)
        if (i < 2 * np) {
          const int c = col_of(i);
          float s = 0.f;
          for (int e = 0; e < E; ++e) s += __shfl_sync(0xffffffffu, dl, e) * wr[(size_t)c * E + e];
          dy[i] += s;
        }
      float m1 = 0.f, m2 = 0.f;
#pragma unroll
      for (int i = 0; i < 2 * kMaxPairs; ++i)
        if (i < 2 * np) {
          const int c = col_of(i);
          const float dxh = dy[i] * scale[c];
          m1 += dxh;
          m2 += dxh * v[i];
          wsc[c] += dy[i] * v[i];
          wsc[D + c] += dy[i];
        }
      m1 = warp_sum(m1) / D;
      m2 = warp_sum(m2) / D;
#pragma unroll
      for (int i = 0; i < 2 * kMaxPairs; ++i)
        if (i < 2 * np) {
          const int c = col_of(i);
          float d = inv * (dy[i] * scale[c] - m1 - v[i] * m2);
          if (dres != nullptr) d += __bfloat162float(dres[row * D + c]);
          dx[row * D + c] = __float2bfloat16(d);
        }
    }
    __syncthreads();
    // 2: this chunk's share of dwr = fp32(yb)^T dlogits and dbr, rows in order
    for (int j = threadIdx.x; j < D * E; j += kThreads) {
      const int d = j / E, e = j % E;
      float a = dwr_acc[j];
      for (int r = 0; r < nrows; ++r) a += __bfloat162float(yb_s[r * D + d]) * dl_s[r * E + e];
      dwr_acc[j] = a;
    }
    if (threadIdx.x < E) {
      float a = dbr_acc[threadIdx.x];
      for (int r = 0; r < nrows; ++r) a += dl_s[r * E + threadIdx.x];
      dbr_acc[threadIdx.x] = a;
    }
    __syncthreads();
  }

  // the group's partials: [dscale (D) | dbias (D) | dwr (D*E) | dbr (E)]
  float* out = part + (size_t)g * (2 * D + D * E + E);
  for (int c = threadIdx.x; c < 2 * D; c += kThreads) {
    float t = acc_sb[c];
    for (int w = 1; w < kWarps; ++w) t += acc_sb[(size_t)w * 2 * D + c];
    out[c] = t;
  }
  for (int j = threadIdx.x; j < D * E; j += kThreads) out[2 * D + j] = dwr_acc[j];
  if (threadIdx.x < E) out[2 * D + D * E + threadIdx.x] = dbr_acc[threadIdx.x];
}

// ---------------------------------------------------------------- K12f

__global__ void __launch_bounds__(kThreads)
combine_fwd_kernel(const bf16* __restrict__ eout, const float* __restrict__ gates,
                   const float* __restrict__ pos1, const float* __restrict__ pos2,
                   const bf16* __restrict__ res, bf16* __restrict__ tok, Geometry q) {
  const int g = blockIdx.x, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int E = q.E, D = q.D;
  const size_t S = (size_t)q.G * q.cpad;
  for (int t = warp; t < q.gs; t += kWarps) {
    const size_t row = (size_t)g * q.gs + t;
    int e1, p1, e2 = -1, p2 = 0;
    choice_of(pos1 + row * E, E, e1, p1);
    if (q.topk == 2) choice_of(pos2 + row * E, E, e2, p2);
    const __nv_bfloat162* o1 = (e1 >= 0 && p1 < q.cap) ? reinterpret_cast<const __nv_bfloat162*>(
        eout + ((size_t)e1 * S + (size_t)g * q.cpad + p1) * D) : nullptr;
    const __nv_bfloat162* o2 = (e2 >= 0 && p2 < q.cap) ? reinterpret_cast<const __nv_bfloat162*>(
        eout + ((size_t)e2 * S + (size_t)g * q.cpad + p2) * D) : nullptr;
    const float g1 = gates[row * 2], g2 = gates[row * 2 + 1];
    for (int j = lane; j < D / 2; j += 32) {
      float2 a = make_float2(0.f, 0.f);
      if (o1) {
        const float2 f = __bfloat1622float2(o1[j]);
        a.x = g1 * f.x;
        a.y = g1 * f.y;
      }
      if (o2) {
        const float2 f = __bfloat1622float2(o2[j]);
        a.x += g2 * f.x;
        a.y += g2 * f.y;
      }
      __nv_bfloat162 y = __floats2bfloat162_rn(a.x, a.y);
      if (res != nullptr) {
        // the combine rounded to bf16 first, then the fp32 residual add
        const float2 yr = __bfloat1622float2(y);
        const float2 xr = __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(res + row * D)[j]);
        y = __floats2bfloat162_rn(yr.x + xr.x, yr.y + xr.y);
      }
      reinterpret_cast<__nv_bfloat162*>(tok + row * D)[j] = y;
    }
  }
}

// ---------------------------------------------------------------- K12b

__global__ void __launch_bounds__(kThreads)
combine_bwd_kernel(const bf16* __restrict__ eout, const float* __restrict__ gates,
                   const float* __restrict__ pos1, const float* __restrict__ pos2,
                   const bf16* __restrict__ dpart, bf16* __restrict__ deout,
                   float* __restrict__ dgates, Geometry q) {
  __shared__ int fill[kMaxE];
  const int g = blockIdx.x, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int E = q.E, D = q.D;
  const size_t S = (size_t)q.G * q.cpad;
  if (threadIdx.x < kMaxE) fill[threadIdx.x] = 0;
  __syncthreads();
  for (int t = warp; t < q.gs; t += kWarps) {
    const size_t row = (size_t)g * q.gs + t;
    int ek[2], pk[2];
    ek[1] = -1;
    pk[1] = 0;
    choice_of(pos1 + row * E, E, ek[0], pk[0]);
    if (q.topk == 2) choice_of(pos2 + row * E, E, ek[1], pk[1]);
    const __nv_bfloat162* dy2 = reinterpret_cast<const __nv_bfloat162*>(dpart + row * D);
    for (int k = 0; k < 2; ++k) {
      float dg = 0.f;
      if (ek[k] >= 0 && pk[k] < q.cap) {
        const size_t slot = (size_t)ek[k] * S + (size_t)g * q.cpad + pk[k];
        const __nv_bfloat162* o = reinterpret_cast<const __nv_bfloat162*>(eout + slot * D);
        __nv_bfloat162* d = reinterpret_cast<__nv_bfloat162*>(deout + slot * D);
        const float gk = gates[row * 2 + k];
        float s = 0.f;
        for (int j = lane; j < D / 2; j += 32) {
          const float2 f = __bfloat1622float2(o[j]), dy = __bfloat1622float2(dy2[j]);
          s += f.x * dy.x + f.y * dy.y;
          d[j] = __floats2bfloat162_rn(gk * dy.x, gk * dy.y);
        }
        dg = warp_sum(s);
        if (lane == 0) atomicAdd(&fill[ek[k]], 1);  // an integer count: order-free
      }
      if (lane == 0) dgates[row * 2 + k] = dg;
    }
  }
  __syncthreads();
  zero_unfilled(deout, fill, q, g);
}

size_t dispatch_fwd_smem(const Geometry& q) { return (size_t)q.gs * 6 * sizeof(float); }

size_t dispatch_bwd_smem(const Geometry& q) {
  return ((size_t)kWarps * 2 * q.D + (size_t)q.D * q.E + (size_t)kChunk * q.E) * sizeof(float) +
         (size_t)kChunk * q.D * sizeof(bf16);
}

}  // namespace
}  // namespace ddm

using ddm::bf16;
using ddm::Geometry;

// x (G*gs, D) bf16 -> xin (E, G*Cp, D) bf16, gates (G*gs, 2), pos1, pos2,
// probs (G*gs, E) fp32, and cnt_psum (2, E) = (first-choice counts, prob
// sums) of the first n_valid rows, through part (G, 2, E).
extern "C" int ddm_moe_dispatch_fwd(const void* x, const void* scale, const void* bias,
                                    const void* wr, const void* br, void* xin, void* gates,
                                    void* pos1, void* pos2, void* probs, void* part,
                                    void* cnt_psum, int G, int gs, int n_valid, int D, int E,
                                    int cap, int cpad, int topk, void* stream) {
  using namespace ddm;
  const Geometry q{G, gs, n_valid, D, E, cap, cpad, topk};
  const size_t smem = dispatch_fwd_smem(q);
  cudaError_t err = cudaFuncSetAttribute(dispatch_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dispatch_fwd_kernel<<<G, kThreads, smem, (cudaStream_t)stream>>>(
      (const bf16*)x, (const float*)scale, (const float*)bias, (const float*)wr,
      (const float*)br, (bf16*)xin, (float*)gates, (float*)pos1, (float*)pos2, (float*)probs,
      (float*)part, q);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)reduce_rows((const float*)part, (float*)cnt_psum, G, 2 * E, (cudaStream_t)stream);
}

// The dispatch backward: dx (G*gs, D) bf16 (plus dres when given) and
// sums = [dscale (D) | dbias (D) | dwr (D, E) | dbr (E)] through part
// (G, 2D + D*E + E).
extern "C" int ddm_moe_dispatch_bwd(const void* x, const void* scale, const void* bias,
                                    const void* wr, const void* pos1, const void* pos2,
                                    const void* probs, const void* dxin, const void* dgates,
                                    const void* dpsum, const void* dres, void* dx, void* part,
                                    void* sums, int G, int gs, int n_valid, int D, int E,
                                    int cap, int cpad, int topk, void* stream) {
  using namespace ddm;
  const Geometry q{G, gs, n_valid, D, E, cap, cpad, topk};
  const size_t smem = dispatch_bwd_smem(q);
  cudaError_t err = cudaFuncSetAttribute(dispatch_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dispatch_bwd_kernel<<<G, kThreads, smem, (cudaStream_t)stream>>>(
      (const bf16*)x, (const float*)scale, (const float*)bias, (const float*)wr,
      (const float*)pos1, (const float*)pos2, (const float*)probs, (const bf16*)dxin,
      (const float*)dgates, (const float*)dpsum, (const bf16*)dres, (bf16*)dx, (float*)part, q);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)reduce_rows((const float*)part, (float*)sums, G, 2 * D + D * E + E,
                          (cudaStream_t)stream);
}

// Expert outputs (E, G*Cp, D) bf16 -> token rows (G*gs, D) bf16, plus the
// bf16 residual res (G*gs, D) when given.
extern "C" int ddm_moe_combine_fwd(const void* eout, const void* gates, const void* pos1,
                                   const void* pos2, const void* res, void* tok, int G, int gs,
                                   int D, int E, int cap, int cpad, int topk, void* stream) {
  using namespace ddm;
  const Geometry q{G, gs, G * gs, D, E, cap, cpad, topk};
  combine_fwd_kernel<<<G, kThreads, 0, (cudaStream_t)stream>>>(
      (const bf16*)eout, (const float*)gates, (const float*)pos1, (const float*)pos2,
      (const bf16*)res, (bf16*)tok, q);
  return (int)cudaGetLastError();
}

// The combine backward: deout (E, G*Cp, D) bf16, zero in every slot row no
// token holds, and dgates (G*gs, 2) fp32.
extern "C" int ddm_moe_combine_bwd(const void* eout, const void* gates, const void* pos1,
                                   const void* pos2, const void* dpart, void* deout,
                                   void* dgates, int G, int gs, int D, int E, int cap, int cpad,
                                   int topk, void* stream) {
  using namespace ddm;
  const Geometry q{G, gs, G * gs, D, E, cap, cpad, topk};
  combine_bwd_kernel<<<G, kThreads, 0, (cudaStream_t)stream>>>(
      (const bf16*)eout, (const float*)gates, (const float*)pos1, (const float*)pos2,
      (const bf16*)dpart, (bf16*)deout, (float*)dgates, q);
  return (int)cudaGetLastError();
}
