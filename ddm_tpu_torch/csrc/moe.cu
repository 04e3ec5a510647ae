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
// Widths: any D % 8 == 0 (the gate takes D % 128 == 0 up to 4096) and
// 2 <= E <= 64. One warp handles one token row at a time; the row is staged
// in shared memory as bf16 (8 warps x D x 2 B: 18 KB at D 1152, 64 KB at
// 4096) and walked in lane-strided bf16 pairs, so no width is held in
// registers. Each lane holds the experts lane and lane + 32 (softmax,
// argmax with the first index on ties, the choices of a pos row). The
// backward runs two passes over the group: pass 1, one warp per row over
// the whole row, takes the row-wide sums the LN backward needs (mean of
// dy * scale and of dy * scale * xhat) and the router's dlogits (E values,
// parked in a (T, E) scratch); pass 2 walks column tiles of kTile columns,
// and for each tile all rows of the group in order, recomputing dy, writing
// dx and accumulating the tile's dscale, dbias and dwr partials in shared
// memory. So shared memory does not grow with D * E, and every partial keeps
// a fixed summation order (per warp in row order, then the warps in order;
// dwr per chunk of kChunk rows in row order).
//
// What bounds it on the H100: memory. At the DiT-XL/4 training shape (T =
// 131,072 rows of D = 1152, E = 8, gs = 256, Cp = 40) the dispatch reads x
// (302 MB) and writes xin (377 MB) plus the (T, E) routing tensors, about
// 0.21 ms at 3.35 TB/s; the combine reads the held expert outputs and the
// residual and writes the tokens. The router product is 2*T*D*E = 2.4
// GFLOP in fp32, the backward's dlogits product and dwr twice that. The
// rows are walked from shared memory and the products are fp32 FMAs in
// registers, so there is no on-chip reuse to win beyond that.
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
constexpr int kMaxE = 64;      // two experts per lane: lane and lane + 32
constexpr int kChunk = 32;     // rows per backward chunk (dwr from shared memory)
constexpr int kTile = 256;     // columns per backward tile
constexpr int kRouterE = 8;    // experts per pass of the router product
constexpr float kLnEps = 1e-6f;
constexpr unsigned kFull = 0xffffffffu;

struct Geometry {
  int G, gs, n_valid, D, E, cap, cpad, topk;
};

// Row `xr` (D bf16) into the warp's shared row `sr`, 16 bytes a lane.
__device__ __forceinline__ void stage_row(bf16* sr, const bf16* __restrict__ xr, int D) {
  const int lane = threadIdx.x % 32;
  __syncwarp();  // every lane is done with the previous row
  const uint4* src = reinterpret_cast<const uint4*>(xr);
  uint4* dst = reinterpret_cast<uint4*>(sr);
  for (int i = lane; i < D / 8; i += 32) dst[i] = src[i];
  __syncwarp();
}

__device__ __forceinline__ const __nv_bfloat162* pairs(const bf16* p) {
  return reinterpret_cast<const __nv_bfloat162*>(p);
}

// fp32 LayerNorm statistics of a shared row, lane j reading the bf16 pairs
// j, j + 32, ...: mean, then the centred variance.
__device__ __forceinline__ void ln_stats(const bf16* sr, int D, float& mu, float& inv) {
  const int lane = threadIdx.x % 32;
  float s = 0.f;
  for (int j = lane; j < D / 2; j += 32) {
    const float2 f = __bfloat1622float2(pairs(sr)[j]);
    s += f.x;
    s += f.y;
  }
  mu = warp_sum(s) / D;
  float q = 0.f;
  for (int j = lane; j < D / 2; j += 32) {
    const float2 f = __bfloat1622float2(pairs(sr)[j]);
    const float a = f.x - mu, b = f.y - mu;
    q += a * a;
    q += b * b;
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
    const float ov = __shfl_xor_sync(kFull, v, o);
    const int oi = __shfl_xor_sync(kFull, idx, o);
    if (ov > v || (ov == v && oi < idx)) {
      v = ov;
      idx = oi;
    }
  }
}

// The expert (or -1) and slot of a token's routed choice from its pos row
// (E fp32 values, -1 off route): lane l reads columns l and l + 32.
__device__ __forceinline__ void choice_of(const float* __restrict__ pos_row, int E, int& e,
                                          int& p) {
  const int lane = threadIdx.x % 32;
  const float v0 = lane < E ? pos_row[lane] : -1.f;
  const float v1 = lane + 32 < E ? pos_row[lane + 32] : -1.f;
  const unsigned h0 = __ballot_sync(kFull, v0 >= 0.f), h1 = __ballot_sync(kFull, v1 >= 0.f);
  e = h0 ? __ffs(h0) - 1 : (h1 ? 31 + __ffs(h1) : -1);
  p = (int)__shfl_sync(kFull, e >= 32 ? v1 : v0, e < 0 ? 0 : e % 32);
}

// The flat slot row (e * S + g * Cp + p) of a kept choice, or -1.
__device__ __forceinline__ int slot_row(int e, int p, const Geometry& q, int g) {
  return (e >= 0 && p < q.cap) ? e * q.G * q.cpad + g * q.cpad + p : -1;
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
  bf16* rows_s = reinterpret_cast<bf16*>(slot2 + q.gs);  // [kWarps][D]
  __shared__ float psum_w[kWarps][kMaxE];
  __shared__ int fill[kMaxE];

  const int g = blockIdx.x, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int E = q.E, D = q.D;
  const bool has0 = lane < E, has1 = lane + 32 < E;
  bf16* sr = rows_s + (size_t)warp * D;
  __nv_bfloat162* sr2 = reinterpret_cast<__nv_bfloat162*>(sr);
  float psum0 = 0.f, psum1 = 0.f;

  // 1: per row, LN -> router -> softmax -> top-k (one warp per row)
  for (int t = warp; t < q.gs; t += kWarps) {
    const size_t row = (size_t)g * q.gs + t;
    const bool valid = row < (size_t)q.n_valid;
    stage_row(sr, x + row * D, D);
    float mu, inv;
    ln_stats(sr, D, mu, inv);
    // yb = bf16(LN(x)) in place: each lane rewrites and later reads only its own pairs
    for (int j = lane; j < D / 2; j += 32) {
      const float2 f = __bfloat1622float2(sr2[j]);
      const int c = 2 * j;
      sr2[j] = __floats2bfloat162_rn(ln_y(f.x, mu, inv, scale[c], bias[c]),
                                     ln_y(f.y, mu, inv, scale[c + 1], bias[c + 1]));
    }
    // the router product, kRouterE experts per pass over the row
    float l0 = -INFINITY, l1 = -INFINITY;
    for (int e0 = 0; e0 < E; e0 += kRouterE) {
      float acc[kRouterE];
#pragma unroll
      for (int k = 0; k < kRouterE; ++k) acc[k] = 0.f;
      for (int j = lane; j < D / 2; j += 32) {
        const float2 y = __bfloat1622float2(sr2[j]);
        const float* w0 = wr + (size_t)(2 * j) * E + e0;
        const float* w1 = w0 + E;
#pragma unroll
        for (int k = 0; k < kRouterE; ++k)
          if (e0 + k < E) {
            acc[k] += y.x * w0[k];
            acc[k] += y.y * w1[k];
          }
      }
#pragma unroll
      for (int k = 0; k < kRouterE; ++k) {
        const int e = e0 + k;
        if (e < E) {
          const float s = warp_sum(acc[k]);
          if (lane == e) l0 = s + br[e];
          if (lane + 32 == e) l1 = s + br[e];
        }
      }
    }
    const float mx = warp_max(fmaxf(l0, l1));
    const float ex0 = has0 ? expf(l0 - mx) : 0.f, ex1 = has1 ? expf(l1 - mx) : 0.f;
    const float den = warp_sum(ex0 + ex1);
    const float p0 = ex0 / den, p1 = ex1 / den;
    if (has0) probs[row * E + lane] = p0;
    if (has1) probs[row * E + lane + 32] = p1;
    psum0 += (valid && has0) ? p0 : 0.f;
    psum1 += (valid && has1) ? p1 : 0.f;

    float v1 = has0 ? p0 : -INFINITY;
    int i1 = has0 ? lane : kMaxE;
    if (has1 && p1 > v1) {
      v1 = p1;
      i1 = lane + 32;
    }
    warp_argmax(v1, i1);
    float g1 = v1, g2 = 0.f;
    int i2 = -1;
    if (q.topk == 2) {
      float v2 = (has0 && lane != i1) ? p0 : -INFINITY;
      i2 = (has0 && lane != i1) ? lane : kMaxE;
      if (has1 && lane + 32 != i1 && p1 > v2) {
        v2 = p1;
        i2 = lane + 32;
      }
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
  psum_w[warp][lane] = psum0;
  psum_w[warp][lane + 32] = psum1;
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
  for (int t = warp; t < q.gs; t += kWarps) {
    const int e1 = idx1[t], e2 = q.topk == 2 ? idx2[t] : -1;
    const int s1 = slot_row(e1, e1 >= 0 ? slot1[t] : q.cap, q, g);
    const int s2 = slot_row(e2, e2 >= 0 ? slot2[t] : q.cap, q, g);
    if (s1 < 0 && s2 < 0) continue;
    const size_t row = (size_t)g * q.gs + t;
    const float mu = mu_s[t], inv = inv_s[t];
    const __nv_bfloat162* x2 = pairs(x + row * D);
    __nv_bfloat162* d1 =
        s1 >= 0 ? reinterpret_cast<__nv_bfloat162*>(xin + (size_t)s1 * D) : nullptr;
    __nv_bfloat162* d2 =
        s2 >= 0 ? reinterpret_cast<__nv_bfloat162*>(xin + (size_t)s2 * D) : nullptr;
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

// dy at columns (2j, 2j + 1) of a row: its kept slot rows' cotangents (flat
// slot rows s1, s2 of dxin, -1 for none), then dlogits (shared, E values)
// times wr^T.
__device__ __forceinline__ float2 dy_pair(int j, int s1, int s2, const bf16* __restrict__ dxin,
                                          const float* dl, const float* __restrict__ wr, int E,
                                          int D) {
  float2 dy = make_float2(0.f, 0.f);
  if (s1 >= 0) {
    const float2 f = __bfloat1622float2(pairs(dxin + (size_t)s1 * D)[j]);
    dy.x += f.x;
    dy.y += f.y;
  }
  if (s2 >= 0) {
    const float2 f = __bfloat1622float2(pairs(dxin + (size_t)s2 * D)[j]);
    dy.x += f.x;
    dy.y += f.y;
  }
  const float* w0 = wr + (size_t)(2 * j) * E;
  const float* w1 = w0 + E;
  float a = 0.f, b = 0.f;
  for (int e = 0; e < E; ++e) {
    a += dl[e] * w0[e];
    b += dl[e] * w1[e];
  }
  dy.x += a;
  dy.y += b;
  return dy;
}

__global__ void __launch_bounds__(kThreads)
dispatch_bwd_kernel(const bf16* __restrict__ x, const float* __restrict__ scale,
                    const float* __restrict__ bias, const float* __restrict__ wr,
                    const float* __restrict__ pos1, const float* __restrict__ pos2,
                    const float* __restrict__ probs, const bf16* __restrict__ dxin,
                    const float* __restrict__ dgates, const float* __restrict__ dpsum,
                    const bf16* __restrict__ dres, bf16* __restrict__ dx,
                    float* __restrict__ dl_g, float* __restrict__ part, Geometry q) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int E = q.E, D = q.D, gs = q.gs;
  // per row of the group, from pass 1: LN statistics, the LN backward's
  // row means, the flat slot rows of its kept choices
  float* mu_s = reinterpret_cast<float*>(smem);
  float* inv_s = mu_s + gs;
  float* m1_s = inv_s + gs;
  float* m2_s = m1_s + gs;
  int* sl1 = reinterpret_cast<int*>(m2_s + gs);
  int* sl2 = sl1 + gs;
  unsigned char* work = reinterpret_cast<unsigned char*>(sl2 + gs);
  // pass 1: the warps' rows [kWarps][D] bf16, then their dlogits [kWarps][kMaxE]
  bf16* rows_s = reinterpret_cast<bf16*>(work);
  float* dlw_s = reinterpret_cast<float*>(rows_s + (size_t)kWarps * D);
  // pass 2 (the same bytes): per-warp [dscale | dbias] of the tile as pairs
  // [kWarps][2][kTile / 2], dwr of the tile [kTile][E], the chunk's dlogits
  // [kChunk][E], the chunk's yb [kChunk][kTile]
  float2* wsc = reinterpret_cast<float2*>(work);
  float* dwr_acc = reinterpret_cast<float*>(wsc + kWarps * kTile);
  float* dl_s = dwr_acc + kTile * E;
  __nv_bfloat162* yb_s = reinterpret_cast<__nv_bfloat162*>(dl_s + kChunk * E);
  __shared__ float dbr_acc[kMaxE];

  const int g = blockIdx.x, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool has0 = lane < E, has1 = lane + 32 < E;
  if (threadIdx.x < kMaxE) dbr_acc[threadIdx.x] = 0.f;

  // pass 1 (one warp per row): LN statistics, dlogits, and the means of
  // dy * scale and dy * scale * xhat over the row
  bf16* sr = rows_s + (size_t)warp * D;
  float* dlw = dlw_s + warp * kMaxE;
  for (int t = warp; t < gs; t += kWarps) {
    const size_t row = (size_t)g * gs + t;
    const bool valid = row < (size_t)q.n_valid;
    stage_row(sr, x + row * D, D);
    float mu, inv;
    ln_stats(sr, D, mu, inv);
    int e1, p1, e2 = -1, p2 = 0;
    choice_of(pos1 + row * E, E, e1, p1);
    if (q.topk == 2) choice_of(pos2 + row * E, E, e2, p2);
    // the router, softmax and gate chain: dlogits of experts lane and lane + 32
    const float pr0 = has0 ? probs[row * E + lane] : 0.f;
    const float pr1 = has1 ? probs[row * E + lane + 32] : 0.f;
    float dp0 = (valid && has0) ? dpsum[lane] : 0.f;
    float dp1 = (valid && has1) ? dpsum[lane + 32] : 0.f;
    const float a0 = lane == e1 ? 1.f : 0.f, a1 = lane + 32 == e1 ? 1.f : 0.f;
    const float b0 = lane == e2 ? 1.f : 0.f, b1 = lane + 32 == e2 ? 1.f : 0.f;
    const float dg1 = dgates[row * 2], dg2 = dgates[row * 2 + 1];
    if (q.topk == 1) {
      dp0 += dg1 * a0;
      dp1 += dg1 * a1;
    } else {
      const float p1v = warp_sum(pr0 * a0 + pr1 * a1), p2v = warp_sum(pr0 * b0 + pr1 * b1);
      const float s = p1v + p2v + 1e-9f;
      const float inv_s2 = 1.0f / (s * s);
      const float dq1 = (dg1 * (p2v + 1e-9f) - dg2 * p2v) * inv_s2;
      const float dq2 = (dg2 * (p1v + 1e-9f) - dg1 * p1v) * inv_s2;
      dp0 = dp0 + dq1 * a0 + dq2 * b0;
      dp1 = dp1 + dq1 * a1 + dq2 * b1;
    }
    const float dot = warp_sum(dp0 * pr0 + dp1 * pr1);
    const float dl0 = pr0 * (dp0 - dot), dl1 = pr1 * (dp1 - dot);
    dlw[lane] = dl0;
    dlw[lane + 32] = dl1;
    if (has0) dl_g[row * E + lane] = dl0;
    if (has1) dl_g[row * E + lane + 32] = dl1;
    __syncwarp();
    const int s1 = slot_row(e1, p1, q, g), s2 = slot_row(e2, p2, q, g);
    float m1 = 0.f, m2 = 0.f;
    for (int j = lane; j < D / 2; j += 32) {
      const float2 f = __bfloat1622float2(pairs(sr)[j]);
      const float2 dy = dy_pair(j, s1, s2, dxin, dlw, wr, E, D);
      const int c = 2 * j;
      const float dxa = dy.x * scale[c], dxb = dy.y * scale[c + 1];
      m1 += dxa;
      m2 += dxa * ((f.x - mu) * inv);
      m1 += dxb;
      m2 += dxb * ((f.y - mu) * inv);
    }
    m1 = warp_sum(m1) / D;
    m2 = warp_sum(m2) / D;
    if (lane == 0) {
      mu_s[t] = mu;
      inv_s[t] = inv;
      m1_s[t] = m1;
      m2_s[t] = m2;
      sl1[t] = s1;
      sl2[t] = s2;
    }
    __syncwarp();  // dlw is rewritten by the next row
  }
  __syncthreads();

  // pass 2: column tiles; in each, every row of the group in chunks of kChunk
  float* out = part + (size_t)g * (2 * D + D * E + E);
  const __nv_bfloat162* dres2 = dres ? pairs(dres) : nullptr;
  __nv_bfloat162* dx2 = reinterpret_cast<__nv_bfloat162*>(dx);
  for (int c0 = 0; c0 < D; c0 += kTile) {
    const int w = min(kTile, D - c0), hw = w / 2;
    for (int i = threadIdx.x; i < kWarps * kTile; i += kThreads) wsc[i] = make_float2(0.f, 0.f);
    for (int i = threadIdx.x; i < w * E; i += kThreads) dwr_acc[i] = 0.f;
    float2* ws = wsc + (size_t)warp * kTile;  // [dscale pairs | dbias pairs]
    for (int t0 = 0; t0 < gs; t0 += kChunk) {
      const int nrows = min(kChunk, gs - t0);
      __syncthreads();  // dl_s and yb_s are free
      for (int i = threadIdx.x; i < nrows * E; i += kThreads)
        dl_s[i] = dl_g[((size_t)g * gs + t0) * E + i];
      __syncthreads();
      for (int r = warp; r < nrows; r += kWarps) {
        const int t = t0 + r;
        const size_t row = (size_t)g * gs + t;
        const float mu = mu_s[t], inv = inv_s[t], m1 = m1_s[t], m2 = m2_s[t];
        const int s1 = sl1[t], s2 = sl2[t];
        const __nv_bfloat162* x2 = pairs(x + row * D);
        for (int h = lane; h < hw; h += 32) {
          const int j = c0 / 2 + h, c = 2 * j;
          const float2 f = __bfloat1622float2(x2[j]);
          const float xa = (f.x - mu) * inv, xb = (f.y - mu) * inv;
          yb_s[r * (kTile / 2) + h] = __floats2bfloat162_rn(
              __fmaf_rn(xa, scale[c], bias[c]), __fmaf_rn(xb, scale[c + 1], bias[c + 1]));
          const float2 dy = dy_pair(j, s1, s2, dxin, dl_s + r * E, wr, E, D);
          float da = inv * (dy.x * scale[c] - m1 - xa * m2);
          float db = inv * (dy.y * scale[c + 1] - m1 - xb * m2);
          if (dres2 != nullptr) {
            const float2 rr = __bfloat1622float2(dres2[row * (D / 2) + j]);
            da += rr.x;
            db += rr.y;
          }
          dx2[row * (D / 2) + j] = __floats2bfloat162_rn(da, db);
          float2 a = ws[h], b = ws[kTile / 2 + h];
          a.x += dy.x * xa;
          a.y += dy.y * xb;
          b.x += dy.x;
          b.y += dy.y;
          ws[h] = a;
          ws[kTile / 2 + h] = b;
        }
      }
      __syncthreads();
      // this chunk's share of the tile's dwr = fp32(yb)^T dlogits, and of dbr, rows in order
      for (int i = threadIdx.x; i < w * E; i += kThreads) {
        const int d = i / E, e = i % E;
        const bf16* yb = reinterpret_cast<const bf16*>(yb_s);
        float a = dwr_acc[i];
        for (int r = 0; r < nrows; ++r) a += __bfloat162float(yb[r * kTile + d]) * dl_s[r * E + e];
        dwr_acc[i] = a;
      }
      if (c0 == 0 && threadIdx.x < E) {
        float a = dbr_acc[threadIdx.x];
        for (int r = 0; r < nrows; ++r) a += dl_s[r * E + threadIdx.x];
        dbr_acc[threadIdx.x] = a;
      }
    }
    __syncthreads();
    // the tile's partials: dscale, dbias (the warps in order) and dwr
    for (int h = threadIdx.x; h < hw; h += kThreads) {
      float2 s = wsc[h], b = wsc[kTile / 2 + h];
      for (int v = 1; v < kWarps; ++v) {
        const float2 os = wsc[(size_t)v * kTile + h], ob = wsc[(size_t)v * kTile + kTile / 2 + h];
        s.x += os.x;
        s.y += os.y;
        b.x += ob.x;
        b.y += ob.y;
      }
      out[c0 + 2 * h] = s.x;
      out[c0 + 2 * h + 1] = s.y;
      out[D + c0 + 2 * h] = b.x;
      out[D + c0 + 2 * h + 1] = b.y;
    }
    for (int i = threadIdx.x; i < w * E; i += kThreads)
      out[2 * D + (size_t)c0 * E + i] = dwr_acc[i];
    __syncthreads();  // the next tile zeroes wsc and dwr_acc
  }
  if (threadIdx.x < E) out[2 * D + (size_t)D * E + threadIdx.x] = dbr_acc[threadIdx.x];
}

// ---------------------------------------------------------------- K12f

__global__ void __launch_bounds__(kThreads)
combine_fwd_kernel(const bf16* __restrict__ eout, const float* __restrict__ gates,
                   const float* __restrict__ pos1, const float* __restrict__ pos2,
                   const bf16* __restrict__ res, bf16* __restrict__ tok, Geometry q) {
  const int g = blockIdx.x, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int E = q.E, D = q.D;
  for (int t = warp; t < q.gs; t += kWarps) {
    const size_t row = (size_t)g * q.gs + t;
    int e1, p1, e2 = -1, p2 = 0;
    choice_of(pos1 + row * E, E, e1, p1);
    if (q.topk == 2) choice_of(pos2 + row * E, E, e2, p2);
    const int s1 = slot_row(e1, p1, q, g), s2 = slot_row(e2, p2, q, g);
    const __nv_bfloat162* o1 = s1 >= 0 ? pairs(eout + (size_t)s1 * D) : nullptr;
    const __nv_bfloat162* o2 = s2 >= 0 ? pairs(eout + (size_t)s2 * D) : nullptr;
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
        const float2 xr = __bfloat1622float2(pairs(res + row * D)[j]);
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
  if (threadIdx.x < kMaxE) fill[threadIdx.x] = 0;
  __syncthreads();
  for (int t = warp; t < q.gs; t += kWarps) {
    const size_t row = (size_t)g * q.gs + t;
    int ek[2], pk[2];
    ek[1] = -1;
    pk[1] = 0;
    choice_of(pos1 + row * E, E, ek[0], pk[0]);
    if (q.topk == 2) choice_of(pos2 + row * E, E, ek[1], pk[1]);
    const __nv_bfloat162* dy2 = pairs(dpart + row * D);
    for (int k = 0; k < 2; ++k) {
      float dg = 0.f;
      const int slot = slot_row(ek[k], pk[k], q, g);
      if (slot >= 0) {
        const __nv_bfloat162* o = pairs(eout + (size_t)slot * D);
        __nv_bfloat162* d = reinterpret_cast<__nv_bfloat162*>(deout + (size_t)slot * D);
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

size_t dispatch_fwd_smem(const Geometry& q) {
  return (size_t)q.gs * 6 * sizeof(float) + (size_t)kWarps * q.D * sizeof(bf16);
}

size_t dispatch_bwd_smem(const Geometry& q) {
  const size_t pass1 = (size_t)kWarps * q.D * sizeof(bf16) + (size_t)kWarps * kMaxE * sizeof(float);
  const size_t pass2 = ((size_t)kWarps * 2 * kTile + (size_t)kTile * q.E + (size_t)kChunk * q.E) *
                           sizeof(float) +
                       (size_t)kChunk * kTile * sizeof(bf16);
  return (size_t)q.gs * 6 * sizeof(float) + (pass1 > pass2 ? pass1 : pass2);
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
// (G, 2D + D*E + E); dl (G*gs, E) fp32 is scratch (the rows' dlogits).
extern "C" int ddm_moe_dispatch_bwd(const void* x, const void* scale, const void* bias,
                                    const void* wr, const void* pos1, const void* pos2,
                                    const void* probs, const void* dxin, const void* dgates,
                                    const void* dpsum, const void* dres, void* dx, void* dl,
                                    void* part, void* sums, int G, int gs, int n_valid, int D,
                                    int E, int cap, int cpad, int topk, void* stream) {
  using namespace ddm;
  const Geometry q{G, gs, n_valid, D, E, cap, cpad, topk};
  const size_t smem = dispatch_bwd_smem(q);
  cudaError_t err = cudaFuncSetAttribute(dispatch_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dispatch_bwd_kernel<<<G, kThreads, smem, (cudaStream_t)stream>>>(
      (const bf16*)x, (const float*)scale, (const float*)bias, (const float*)wr,
      (const float*)pos1, (const float*)pos2, (const float*)probs, (const bf16*)dxin,
      (const float*)dgates, (const float*)dpsum, (const bf16*)dres, (bf16*)dx, (float*)dl,
      (float*)part, q);
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
