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
//     first choices). Thread i walks the group's tokens in order for each
//     of its experts i, i + 256, ...; the kept slots of an expert are then
//     the contiguous range
//     [0, min(cap, cnt1 + cnt2)), so each token writes its own slot rows
//     and the rest of the expert's Cp rows are written as zeros (the
//     expert FFN runs on every slot row, and uninitialised memory there
//     would reach dW through 0 * NaN);
//   * sums across groups (the aux statistics cnt and psum; dscale, dbias,
//     dwr, dbr) are per-group partials summed by reduce_rows in a fixed
//     order: no atomics, so the same inputs give the same bits.
//
// Shapes: every one the JAX gate takes (D % 128 == 0, E >= 2, gs % 8 == 0
// up to 2048; the code needs only D % 8 == 0), as far as the card's 227 KB
// of shared memory holds a block's per-row and per-expert state. One warp
// handles one token row at a time, reading it from device memory (L1/L2)
// in lane-strided bf16 pairs and recomputing yb = bf16(LN(x)) where it is
// read, so no width is held in registers or shared memory. (Staging each
// warp's row in shared memory gives the same bits and, measured on the
// H100, takes as long or longer.) Lane l holds the experts l, l + 32, l + 64, ... in a
// per-warp [E] slab of shared memory (a row's logits, exps, probabilities,
// dprobs and dlogits), and every per-lane sum over its experts runs in that
// order before the warp's sum: at E <= 64 exactly the order of a lane
// holding experts lane and lane + 32 (softmax, argmax with the first index
// on ties, the choices of a pos row, which scan 32-expert slabs in order).
// The backward runs two passes over the group: pass 1, one warp per row
// over the whole row, takes the row-wide sums the LN backward needs (mean
// of dy * scale and of dy * scale * xhat) and the router's dlogits (E
// values, parked in a (T, E) scratch); pass 2 walks column tiles, and for
// each tile all rows of the group in chunks, recomputing dy, writing dx and
// accumulating the tile's dscale, dbias and dwr partials in shared memory.
// The tile width (256 columns at most) and the chunk (32 rows at most, a
// multiple of the 8 warps) shrink with E until (tile + chunk) x E x 4 B
// fits. That keeps the bits: each dwr and dbr element is one sum over the
// group's rows in row order, carried across chunks; each warp's dscale and
// dbias partial sums the rows t = warp (mod 8) in order, whatever the tile.
// The per-group partials (G, 2D + D*E + E) are reduced in column slabs
// where they would pass the caller's scratch bound: each slab reruns pass
// 1 and writes its columns' partials, and reduce_rows sums each column over
// the groups in the same fixed order, so slabs give the same bits.
//
// What bounds it on the H100: memory, and at large E the router's fp32
// FMAs. At the DiT-XL/4 training shape (T = 131,072 rows of D = 1152, E =
// 8, gs = 256, Cp = 40) the dispatch reads x (302 MB) and writes xin (377
// MB) plus the (T, E) routing tensors, about 0.21 ms at 3.35 TB/s; the
// combine reads the held expert outputs and the residual and writes the
// tokens. The router product is 2*T*D*E = 2.4 GFLOP in fp32 (12.9 GFLOP
// at D 384, E 128), the backward's dlogits product and dwr twice that. The
// router weights are read transposed, wr^T (E, D), so the lanes of a warp
// read consecutive columns of one expert.
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
constexpr int kChunk = 32;     // rows per backward chunk at most (dwr from shared memory)
constexpr int kTile = 256;     // columns per backward tile at most
constexpr int kRouterE = 8;    // experts per pass of the router product
constexpr float kLnEps = 1e-6f;
constexpr unsigned kFull = 0xffffffffu;

struct Geometry {
  int G, gs, n_valid, D, E, cap, cpad, topk;
  int tile, chunk;  // the backward's pass 2: columns per tile, rows per chunk
};

__device__ __forceinline__ const __nv_bfloat162* pairs(const bf16* p) {
  return reinterpret_cast<const __nv_bfloat162*>(p);
}

// fp32 LayerNorm statistics of a row of D bf16, lane j reading the pairs
// j, j + 32, ...: mean, then the centred variance.
__device__ __forceinline__ void ln_stats(const __nv_bfloat162* r, int D, float& mu, float& inv) {
  const int lane = threadIdx.x % 32;
  float s = 0.f;
  for (int j = lane; j < D / 2; j += 32) {
    const float2 f = __bfloat1622float2(r[j]);
    s += f.x;
    s += f.y;
  }
  mu = warp_sum(s) / D;
  float q = 0.f;
  for (int j = lane; j < D / 2; j += 32) {
    const float2 f = __bfloat1622float2(r[j]);
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
// (E fp32 values, -1 off route): the first hit, scanning 32-expert slabs in
// order, lane l reading column l of each.
__device__ __forceinline__ void choice_of(const float* __restrict__ pos_row, int E, int& e,
                                          int& p) {
  const int lane = threadIdx.x % 32;
  for (int base = 0; base < E; base += 32) {
    const float v = base + lane < E ? pos_row[base + lane] : -1.f;
    const unsigned h = __ballot_sync(kFull, v >= 0.f);
    if (h) {
      const int src = __ffs(h) - 1;
      e = base + src;
      p = (int)__shfl_sync(kFull, v, src);
      return;
    }
  }
  e = -1;
  p = -1;
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

// yb = bf16(LN(x)) at pair j of the row r, as fp32.
__device__ __forceinline__ float2 yb_pair(const __nv_bfloat162* r, int j, float mu, float inv,
                                          const float* __restrict__ scale,
                                          const float* __restrict__ bias) {
  const float2 f = __bfloat1622float2(r[j]);
  const int c = 2 * j;
  return __bfloat1622float2(__floats2bfloat162_rn(ln_y(f.x, mu, inv, scale[c], bias[c]),
                                                  ln_y(f.y, mu, inv, scale[c + 1], bias[c + 1])));
}

__global__ void __launch_bounds__(kThreads)
dispatch_fwd_kernel(const bf16* __restrict__ x, const float* __restrict__ scale,
                    const float* __restrict__ bias, const float* __restrict__ wrt,
                    const float* __restrict__ br, bf16* __restrict__ xin,
                    float* __restrict__ gates, float* __restrict__ pos1,
                    float* __restrict__ pos2, float* __restrict__ probs,
                    float* __restrict__ part, Geometry q) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int E = q.E, D = q.D, gs = q.gs;
  float* mu_s = reinterpret_cast<float*>(smem);
  float* inv_s = mu_s + gs;
  int* idx1 = reinterpret_cast<int*>(inv_s + gs);
  int* idx2 = idx1 + gs;
  int* slot1 = idx2 + gs;
  int* slot2 = slot1 + gs;
  float* psum_w = reinterpret_cast<float*>(slot2 + gs);  // [kWarps][E]
  float* pr_w = psum_w + (size_t)kWarps * E;  // [kWarps][E]: a row's logits, exps, probs
  int* fill = reinterpret_cast<int*>(pr_w + (size_t)kWarps * E);  // [E]

  const int g = blockIdx.x, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // every [E] slot of a warp's slabs is read and written by lane e % 32 only
  float* pw = psum_w + (size_t)warp * E;
  float* lw = pr_w + (size_t)warp * E;
  for (int e = lane; e < E; e += 32) pw[e] = 0.f;

  // 1: per row, LN -> router -> softmax -> top-k (one warp per row)
  for (int t = warp; t < gs; t += kWarps) {
    const size_t row = (size_t)g * gs + t;
    const bool valid = row < (size_t)q.n_valid;
    const __nv_bfloat162* xr = pairs(x + row * D);
    float mu, inv;
    ln_stats(xr, D, mu, inv);
    // the router product, kRouterE experts per pass over the row
    for (int e0 = 0; e0 < E; e0 += kRouterE) {
      float acc[kRouterE];
#pragma unroll
      for (int k = 0; k < kRouterE; ++k) acc[k] = 0.f;
      for (int j = lane; j < D / 2; j += 32) {
        const float2 y = yb_pair(xr, j, mu, inv, scale, bias);
        const float* w = wrt + (size_t)e0 * D + 2 * j;
#pragma unroll
        for (int k = 0; k < kRouterE; ++k)
          if (e0 + k < E) {
            const float2 wk = *reinterpret_cast<const float2*>(w + (size_t)k * D);
            acc[k] += y.x * wk.x;
            acc[k] += y.y * wk.y;
          }
      }
#pragma unroll
      for (int k = 0; k < kRouterE; ++k) {
        const int e = e0 + k;
        if (e < E) {
          const float s = warp_sum(acc[k]);
          if (lane == e % 32) lw[e] = s + br[e];
        }
      }
    }
    // softmax over the lanes' experts, each lane's share in expert order
    float mx = -INFINITY;
    for (int e = lane; e < E; e += 32) mx = fmaxf(mx, lw[e]);
    mx = warp_max(mx);
    float den = 0.f;
    for (int e = lane; e < E; e += 32) {
      const float ex = expf(lw[e] - mx);
      lw[e] = ex;
      den += ex;
    }
    den = warp_sum(den);
    float v1 = -INFINITY;
    int i1 = E;
    for (int e = lane; e < E; e += 32) {
      const float p = lw[e] / den;
      lw[e] = p;
      probs[row * E + e] = p;
      pw[e] += valid ? p : 0.f;
      if (p > v1) {
        v1 = p;
        i1 = e;
      }
    }
    warp_argmax(v1, i1);
    float g1 = v1, g2 = 0.f;
    int i2 = -1;
    if (q.topk == 2) {
      float v2 = -INFINITY;
      i2 = E;
      for (int e = lane; e < E; e += 32)
        if (e != i1 && lw[e] > v2) {
          v2 = lw[e];
          i2 = e;
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
  __syncthreads();

  // 2: the capacity queue, each thread walking the tokens in order for its
  // experts e, e + 256, ...
  for (int e = threadIdx.x; e < E; e += kThreads) {
    int c = 0;
    for (int t = 0; t < gs; ++t)
      if (idx1[t] == e) slot1[t] = c++;
    const int cnt1 = c;
    if (q.topk == 2)
      for (int t = 0; t < gs; ++t)
        if (idx2[t] == e) slot2[t] = c++;
    fill[e] = min(q.cap, c);
    float ps = 0.f;
    for (int w = 0; w < kWarps; ++w) ps += psum_w[(size_t)w * E + e];
    part[(size_t)g * 2 * E + e] = (float)cnt1;
    part[(size_t)g * 2 * E + E + e] = ps;
  }
  __syncthreads();

  // 3: positions, the kept tokens' slot rows, zeros in every other slot row
  for (int i = threadIdx.x; i < gs * E; i += kThreads) {
    const int t = i / E, e = i % E;
    const size_t o = ((size_t)g * gs + t) * E + e;
    pos1[o] = idx1[t] == e ? (float)slot1[t] : -1.f;
    pos2[o] = (q.topk == 2 && idx2[t] == e) ? (float)slot2[t] : -1.f;
  }
  for (int t = warp; t < gs; t += kWarps) {
    const int e1 = idx1[t], e2 = q.topk == 2 ? idx2[t] : -1;
    const int s1 = slot_row(e1, e1 >= 0 ? slot1[t] : q.cap, q, g);
    const int s2 = slot_row(e2, e2 >= 0 ? slot2[t] : q.cap, q, g);
    if (s1 < 0 && s2 < 0) continue;
    const size_t row = (size_t)g * gs + t;
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
                                          const float* dl, const float* __restrict__ wrt, int E,
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
  const float* w = wrt + 2 * j;
  float a = 0.f, b = 0.f;
  for (int e = 0; e < E; ++e) {
    const float2 we = *reinterpret_cast<const float2*>(w + (size_t)e * D);
    a += dl[e] * we.x;
    b += dl[e] * we.y;
  }
  dy.x += a;
  dy.y += b;
  return dy;
}

// Columns [c_lo, c_hi) of pass 2; its partials of group g at
// part + g * (2 w + w E + E), w = c_hi - c_lo: [dscale | dbias | dwr | dbr].
__global__ void __launch_bounds__(kThreads)
dispatch_bwd_kernel(const bf16* __restrict__ x, const float* __restrict__ scale,
                    const float* __restrict__ bias, const float* __restrict__ wrt,
                    const float* __restrict__ pos1, const float* __restrict__ pos2,
                    const float* __restrict__ probs, const bf16* __restrict__ dxin,
                    const float* __restrict__ dgates, const float* __restrict__ dpsum,
                    const bf16* __restrict__ dres, bf16* __restrict__ dx,
                    float* __restrict__ dl_g, float* __restrict__ part, Geometry q, int c_lo,
                    int c_hi) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int E = q.E, D = q.D, gs = q.gs, tile = q.tile, chunk = q.chunk;
  // per row of the group, from pass 1: LN statistics, the LN backward's
  // row means, the flat slot rows of its kept choices; then dbr's sums
  float* mu_s = reinterpret_cast<float*>(smem);
  float* inv_s = mu_s + gs;
  float* m1_s = inv_s + gs;
  float* m2_s = m1_s + gs;
  int* sl1 = reinterpret_cast<int*>(m2_s + gs);
  int* sl2 = sl1 + gs;
  float* dbr_acc = reinterpret_cast<float*>(sl2 + gs);
  unsigned char* work = reinterpret_cast<unsigned char*>(dbr_acc + ((E + 3) & ~3));
  // pass 1: the warps' dlogits [kWarps][E]
  float* dlw_s = reinterpret_cast<float*>(work);
  // pass 2 (the same bytes): per-warp [dscale | dbias] of the tile as pairs
  // [kWarps][2][tile / 2], dwr of the tile [tile][E], the chunk's dlogits
  // [chunk][E], the chunk's yb [chunk][tile]
  float2* wsc = reinterpret_cast<float2*>(work);
  float* dwr_acc = reinterpret_cast<float*>(wsc + (size_t)kWarps * tile);
  float* dl_s = dwr_acc + (size_t)tile * E;
  __nv_bfloat162* yb_s = reinterpret_cast<__nv_bfloat162*>(dl_s + (size_t)chunk * E);

  const int g = blockIdx.x, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int e = threadIdx.x; e < E; e += kThreads) dbr_acc[e] = 0.f;

  // pass 1 (one warp per row): LN statistics, dlogits, and the means of
  // dy * scale and dy * scale * xhat over the row
  float* dlw = dlw_s + (size_t)warp * ((E + 3) & ~3);  // slot e: lane e % 32's
  for (int t = warp; t < gs; t += kWarps) {
    const size_t row = (size_t)g * gs + t;
    const bool valid = row < (size_t)q.n_valid;
    __syncwarp();  // every lane is done reading the previous row's dlogits
    const __nv_bfloat162* xr = pairs(x + row * D);
    float mu, inv;
    ln_stats(xr, D, mu, inv);
    int e1, p1, e2 = -1, p2 = 0;
    choice_of(pos1 + row * E, E, e1, p1);
    if (q.topk == 2) choice_of(pos2 + row * E, E, e2, p2);
    // the router, softmax and gate chain: the dprobs of the lane's experts
    // (parked in dlw), their dot with the probs, then the dlogits
    const float dg1 = dgates[row * 2], dg2 = dgates[row * 2 + 1];
    float dq1 = 0.f, dq2 = 0.f;
    if (q.topk == 2) {
      // the probabilities of the two choices (0 for none)
      const float p1v = e1 >= 0 ? probs[row * E + e1] : 0.f;
      const float p2v = e2 >= 0 ? probs[row * E + e2] : 0.f;
      const float s = p1v + p2v + 1e-9f;
      const float inv_s2 = 1.0f / (s * s);
      dq1 = (dg1 * (p2v + 1e-9f) - dg2 * p2v) * inv_s2;
      dq2 = (dg2 * (p1v + 1e-9f) - dg1 * p1v) * inv_s2;
    }
    // the lane's dot share dp_0 pr_0 + dp_1 pr_1 + ..., as the product of
    // the first pair fused onto the product of the second, then each later
    // one fused on
    float d0 = 0.f, r0 = 0.f, dot = 0.f;
    int k = 0;
    for (int e = lane; e < E; e += 32, ++k) {
      const float pr = probs[row * E + e];
      float dp = valid ? dpsum[e] : 0.f;
      const float a = e == e1 ? 1.f : 0.f, b = e == e2 ? 1.f : 0.f;
      if (q.topk == 1)
        dp += dg1 * a;
      else
        dp = dp + dq1 * a + dq2 * b;
      dlw[e] = dp;
      if (k == 0) {
        d0 = dp;
        r0 = pr;
      } else if (k == 1) {
        dot = __fmaf_rn(d0, r0, __fmul_rn(dp, pr));
      } else {
        dot = __fmaf_rn(dp, pr, dot);
      }
    }
    if (k == 1) dot = __fmul_rn(d0, r0);
    dot = warp_sum(dot);
    for (int e = lane; e < E; e += 32) {
      const float dl = probs[row * E + e] * (dlw[e] - dot);
      dlw[e] = dl;
      dl_g[row * E + e] = dl;
    }
    __syncwarp();
    const int s1 = slot_row(e1, p1, q, g), s2 = slot_row(e2, p2, q, g);
    float m1 = 0.f, m2 = 0.f;
    for (int j = lane; j < D / 2; j += 32) {
      const float2 f = __bfloat1622float2(xr[j]);
      const float2 dy = dy_pair(j, s1, s2, dxin, dlw, wrt, E, D);
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

  // pass 2: column tiles; in each, every row of the group in chunks
  const int sw = c_hi - c_lo;
  float* out = part + (size_t)g * (2 * sw + (size_t)sw * E + E);
  const __nv_bfloat162* dres2 = dres ? pairs(dres) : nullptr;
  __nv_bfloat162* dx2 = reinterpret_cast<__nv_bfloat162*>(dx);
  const int ht = tile / 2;
  for (int c0 = c_lo; c0 < c_hi; c0 += tile) {
    const int w = min(tile, c_hi - c0), hw = w / 2;
    for (int i = threadIdx.x; i < kWarps * tile; i += kThreads) wsc[i] = make_float2(0.f, 0.f);
    for (int i = threadIdx.x; i < w * E; i += kThreads) dwr_acc[i] = 0.f;
    float2* ws = wsc + (size_t)warp * tile;  // [dscale pairs | dbias pairs]
    for (int t0 = 0; t0 < gs; t0 += chunk) {
      const int nrows = min(chunk, gs - t0);
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
          yb_s[r * ht + h] = __floats2bfloat162_rn(
              __fmaf_rn(xa, scale[c], bias[c]), __fmaf_rn(xb, scale[c + 1], bias[c + 1]));
          const float2 dy = dy_pair(j, s1, s2, dxin, dl_s + r * E, wrt, E, D);
          float da = inv * (dy.x * scale[c] - m1 - xa * m2);
          float db = inv * (dy.y * scale[c + 1] - m1 - xb * m2);
          if (dres2 != nullptr) {
            const float2 rr = __bfloat1622float2(dres2[row * (D / 2) + j]);
            da += rr.x;
            db += rr.y;
          }
          dx2[row * (D / 2) + j] = __floats2bfloat162_rn(da, db);
          float2 a = ws[h], b = ws[ht + h];
          a.x += dy.x * xa;
          a.y += dy.y * xb;
          b.x += dy.x;
          b.y += dy.y;
          ws[h] = a;
          ws[ht + h] = b;
        }
      }
      __syncthreads();
      // this chunk's share of the tile's dwr = fp32(yb)^T dlogits, and of dbr, rows in order
      for (int i = threadIdx.x; i < w * E; i += kThreads) {
        const int d = i / E, e = i % E;
        const bf16* yb = reinterpret_cast<const bf16*>(yb_s);
        float a = dwr_acc[i];
        for (int r = 0; r < nrows; ++r) a += __bfloat162float(yb[r * tile + d]) * dl_s[r * E + e];
        dwr_acc[i] = a;
      }
      if (c0 == c_lo)
        for (int e = threadIdx.x; e < E; e += kThreads) {
          float a = dbr_acc[e];
          for (int r = 0; r < nrows; ++r) a += dl_s[r * E + e];
          dbr_acc[e] = a;
        }
    }
    __syncthreads();
    // the tile's partials: dscale, dbias (the warps in order) and dwr
    const int o = c0 - c_lo;
    for (int h = threadIdx.x; h < hw; h += kThreads) {
      float2 s = wsc[h], b = wsc[ht + h];
      for (int v = 1; v < kWarps; ++v) {
        const float2 os = wsc[(size_t)v * tile + h], ob = wsc[(size_t)v * tile + ht + h];
        s.x += os.x;
        s.y += os.y;
        b.x += ob.x;
        b.y += ob.y;
      }
      out[o + 2 * h] = s.x;
      out[o + 2 * h + 1] = s.y;
      out[sw + o + 2 * h] = b.x;
      out[sw + o + 2 * h + 1] = b.y;
    }
    for (int i = threadIdx.x; i < w * E; i += kThreads)
      out[2 * sw + (size_t)o * E + i] = dwr_acc[i];
    __syncthreads();  // the next tile zeroes wsc and dwr_acc
  }
  for (int e = threadIdx.x; e < E; e += kThreads)
    out[2 * sw + (size_t)sw * E + e] = dbr_acc[e];
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
  extern __shared__ int fill[];  // [E]
  const int g = blockIdx.x, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int E = q.E, D = q.D;
  for (int e = threadIdx.x; e < E; e += kThreads) fill[e] = 0;
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

// ---------------------------------------------------------------- shared memory

// The card's opt-in shared memory per block (the H100's 227 KB).
int smem_limit() {
  static int limit = -1;
  if (limit < 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
            cudaSuccess)
      limit = 227 * 1024;
  }
  return limit;
}

size_t rows_bytes(const Geometry& q) { return (size_t)q.gs * 6 * sizeof(float); }

// K11f: the per-row arrays, psum and the row slab [kWarps][E] each, fill [E]
size_t dispatch_fwd_smem(const Geometry& q) {
  return rows_bytes(q) + (size_t)(2 * kWarps + 1) * q.E * sizeof(float);
}

// K11b: the per-row arrays and dbr [E], then the larger of pass 1 (the
// dlogit slabs) and pass 2 at (tile, chunk)
size_t dispatch_bwd_smem(const Geometry& q) {
  const size_t e4 = (size_t)((q.E + 3) & ~3) * sizeof(float);
  const size_t pass1 = kWarps * e4;
  const size_t pass2 = ((size_t)kWarps * 2 * q.tile + (size_t)q.tile * q.E +
                        (size_t)q.chunk * q.E) * sizeof(float) +
                       (size_t)q.chunk * q.tile * sizeof(bf16);
  return rows_bytes(q) + e4 + (pass1 > pass2 ? pass1 : pass2);
}

// Pick the backward's tile and chunk: the widest tile, then the longest
// chunk, that fit; false if none does.
bool plan_bwd(Geometry& q) {
  for (int tile = kTile; tile >= 2; tile /= 2)
    for (int chunk = kChunk; chunk >= kWarps; chunk /= 2) {
      q.tile = tile;
      q.chunk = chunk;
      if (dispatch_bwd_smem(q) <= (size_t)smem_limit()) return true;
    }
  return false;
}

}  // namespace
}  // namespace ddm

using ddm::bf16;
using ddm::Geometry;

// x (G*gs, D) bf16 -> xin (E, G*Cp, D) bf16, gates (G*gs, 2), pos1, pos2,
// probs (G*gs, E) fp32, and cnt_psum (2, E) = (first-choice counts, prob
// sums) of the first n_valid rows, through part (G, 2, E). wrt is the
// router's weight transposed, (E, D) fp32. A shape whose per-row and
// per-expert state does not fit in shared memory returns
// cudaErrorInvalidValue before any launch.
extern "C" int ddm_moe_dispatch_fwd(const void* x, const void* scale, const void* bias,
                                    const void* wrt, const void* br, void* xin, void* gates,
                                    void* pos1, void* pos2, void* probs, void* part,
                                    void* cnt_psum, int G, int gs, int n_valid, int D, int E,
                                    int cap, int cpad, int topk, void* stream) {
  using namespace ddm;
  const Geometry q{G, gs, n_valid, D, E, cap, cpad, topk, 0, 0};
  const size_t smem = dispatch_fwd_smem(q);
  if (smem > (size_t)smem_limit()) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(dispatch_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dispatch_fwd_kernel<<<G, kThreads, smem, (cudaStream_t)stream>>>(
      (const bf16*)x, (const float*)scale, (const float*)bias, (const float*)wrt,
      (const float*)br, (bf16*)xin, (float*)gates, (float*)pos1, (float*)pos2, (float*)probs,
      (float*)part, q);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)reduce_rows((const float*)part, (float*)cnt_psum, G, 2 * E, (cudaStream_t)stream);
}

// The dispatch backward: dx (G*gs, D) bf16 (plus dres when given) and
// sums = [dscale (D) | dbias (D) | dwr (D, E) | dbr (E)]; dl (G*gs, E) fp32
// is scratch (the rows' dlogits). Columns go in slabs of `slab` (D for one
// launch), each through part (G, 2 slab + slab E + E) and, where there is
// more than one slab, through tmp (2 slab + slab E + E) into sums.
extern "C" int ddm_moe_dispatch_bwd(const void* x, const void* scale, const void* bias,
                                    const void* wrt, const void* pos1, const void* pos2,
                                    const void* probs, const void* dxin, const void* dgates,
                                    const void* dpsum, const void* dres, void* dx, void* dl,
                                    void* part, void* tmp, void* sums, int G, int gs,
                                    int n_valid, int D, int E, int cap, int cpad, int topk,
                                    int slab, void* stream) {
  using namespace ddm;
  Geometry q{G, gs, n_valid, D, E, cap, cpad, topk, 0, 0};
  if (!plan_bwd(q) || slab < 2 || slab % 2) return (int)cudaErrorInvalidValue;
  const size_t smem = dispatch_bwd_smem(q);
  cudaError_t err = cudaFuncSetAttribute(dispatch_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  float* out = (float*)sums;
  for (int c_lo = 0; c_lo < D; c_lo += slab) {
    const int c_hi = c_lo + slab < D ? c_lo + slab : D, sw = c_hi - c_lo;
    const int width = 2 * sw + sw * E + E;
    dispatch_bwd_kernel<<<G, kThreads, smem, s>>>(
        (const bf16*)x, (const float*)scale, (const float*)bias, (const float*)wrt,
        (const float*)pos1, (const float*)pos2, (const float*)probs, (const bf16*)dxin,
        (const float*)dgates, (const float*)dpsum, (const bf16*)dres, (bf16*)dx, (float*)dl,
        (float*)part, q, c_lo, c_hi);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    if (sw == D) return (int)reduce_rows((const float*)part, out, G, width, s);
    // one slab's sums, then each of its four pieces to its place
    const float* t = (const float*)tmp;
    err = reduce_rows((const float*)part, (float*)tmp, G, width, s);
    const size_t f = sizeof(float);
    if (err == cudaSuccess)
      err = cudaMemcpyAsync(out + c_lo, t, sw * f, cudaMemcpyDeviceToDevice, s);
    if (err == cudaSuccess)
      err = cudaMemcpyAsync(out + D + c_lo, t + sw, sw * f, cudaMemcpyDeviceToDevice, s);
    if (err == cudaSuccess)
      err = cudaMemcpyAsync(out + 2 * D + (size_t)c_lo * E, t + 2 * sw, (size_t)sw * E * f,
                            cudaMemcpyDeviceToDevice, s);
    if (err == cudaSuccess)
      err = cudaMemcpyAsync(out + 2 * D + (size_t)D * E, t + 2 * sw + (size_t)sw * E, E * f,
                            cudaMemcpyDeviceToDevice, s);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

// Expert outputs (E, G*Cp, D) bf16 -> token rows (G*gs, D) bf16, plus the
// bf16 residual res (G*gs, D) when given.
extern "C" int ddm_moe_combine_fwd(const void* eout, const void* gates, const void* pos1,
                                   const void* pos2, const void* res, void* tok, int G, int gs,
                                   int D, int E, int cap, int cpad, int topk, void* stream) {
  using namespace ddm;
  const Geometry q{G, gs, G * gs, D, E, cap, cpad, topk, 0, 0};
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
  const Geometry q{G, gs, G * gs, D, E, cap, cpad, topk, 0, 0};
  const size_t smem = (size_t)E * sizeof(int);
  if (smem > (size_t)smem_limit()) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(combine_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  combine_bwd_kernel<<<G, kThreads, smem, (cudaStream_t)stream>>>(
      (const bf16*)eout, (const float*)gates, (const float*)pos1, (const float*)pos2,
      (const bf16*)dpart, (bf16*)deout, (float*)dgates, q);
  return (int)cudaGetLastError();
}
