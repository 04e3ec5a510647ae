// The registers designs of the two attention backwards (sm_90a): the core's
// (csrc/attention.cu: K2b's, K4's and K7b's, padded head widths 16-128) and
// K8b's (csrc/flash.cu, Dh 32, 64, 128, and Dh 4, 8, 16 at padded width 16,
// copied in 8-byte pieces). One dq side and one dk/dv side serve both;
// they differ only in where each query row's softmax terms come from. Past
// those widths (padded 144-896, K8b's Dh 256-896) the wide
// backwards at the end of this file split each tile's columns over warps.
//
// The earlier designs keep S, P, dP and dS in shared memory as WMMA tiles,
// form P and dS in scalar passes over them and load every operand
// synchronously behind a barrier. Here every product is mma.sync m16n8k16
// on fragments (mma_frag.cuh): a warp keeps its 16 x 64 tiles of S, dP, P
// and dS and its dq, dk, dv (and att) accumulators in registers, packs P
// and dS to bf16 A fragments without leaving them, and 64-row tiles pass
// through a two-stage cp.async ring read by ldmatrix. No atomics: each
// output element is written by one warp of one block, in one loop order, so
// a second call is bit-identical.
//
// - The dq side, one block per WARPS x 16 query rows of one (image, head):
//   Q and dO rows copied once, K and V tiles of 64 keys through the ring.
//   The core (SWEEP) takes two sweeps over the key tiles. The first takes
//   each row's max m, sum l = sum e and u = sum e dP with e = exp(s scale -
//   m), l and u rescaled as m grows (the forward's two sweeps, with dP
//   added), so that dsum = u / l is rowsum(P dP) over the fp32 P and the
//   fp32 dP up to the order of the sums; it writes (m, l, dsum) for the dk/dv
//   side. K8b has lse and takes dsum = rowsum(do o) from the forward's bf16
//   o (the caller's `rows`), so one sweep. The (second) sweep recomputes S,
//   forms P = exp(s scale - m) / l (K8b: exp(s scale - lse)), att +=
//   bf16(P) V where asked, dP = dO V^T, dS = bf16(P (dP - dsum) scale) and
//   dq += dS K.
// - The dk/dv side, one block per WARPS x 16 key rows: K and V copied once,
//   Q, dO and each query's terms through the ring, query tiles in order. A
//   warp computes S^T = K Q^T and dP^T = V dO^T (keys x queries), so P^T
//   and dS^T are A fragments as they stand: dv += bf16(P)^T dO, dk += dS^T
//   Q, each rounded once.
//
// Ragged and padded shapes: the ring zero-fills rows past N and columns past
// Dh; keys past N are masked to -inf on the dq side; a query row past N has
// zero dO, so dP = dsum = dS = 0 there, and the dk/dv side gives it P = 0
// (its terms are (0, 0, 0)); stores are masked. exp is the card's ex2 with
// log2 e folded into the scale (mma_frag.cuh). A warp holds its A operands
// as fragments where its registers allow (Q and dO on the dq side up to a
// padded width of 64, K and V on the dk/dv side, whose dk and dv take twice
// the accumulators, up to 32); elsewhere it reads them by ldmatrix at each
// depth step. The callers pick the ring tile (64 rows, fewer at wide heads)
// so that each instance a path runs is spill-free on the H100 (ptxas's -v
// report).
#pragma once

#include "mma_frag.cuh"

namespace ddm {
namespace {

constexpr int kBwdTile = 64;  // the widest ring tile: keys (dq side) or queries (dk/dv side)

// Scores of keys at or past N (the last tile of a ragged N) to -inf: s[j]
// holds keys k0 + 8j + 2t and + 1 of rows g and g + 8.
template <int NJ>
__device__ __forceinline__ void mask_keys(float (&s)[NJ][4], int k0, int N, int t) {
  if (k0 + 8 * NJ <= N) return;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (k0 + 8 * j + 2 * t + (e & 1) >= N) s[j][e] = -INFINITY;
}

// The largest raw score of rows g (c[0], c[1]) and g + 8 (c[2], c[3]) of
// one row tile over the key tile: times the scale (> 0) it is the largest
// scaled score, exactly.
template <int NJ>
__device__ __forceinline__ void row_max(const float (&s)[NJ][4], float (&mx)[2]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
  }
}

// A warp's 16 rows of a shared tile (row stride LD) as the A operand of
// products over depth DP: held as fragments (HOLD) or read by ldmatrix at
// each 16-deep step.
template <int DP, int LD, bool HOLD>
struct ARows {
  uint32_t a[HOLD ? DP / 16 : 1][4];
  const bf16* p;

  __device__ __forceinline__ void init(const bf16* rows, int lane) {
    p = rows + (lane % 16) * LD + (lane / 16) * 8;
    if constexpr (HOLD) {
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) ldmatrix_x4<false>(a[kk], p + kk * 16);
    }
  }

  __device__ __forceinline__ void get(int kk, uint32_t (&r)[4]) const {
    if constexpr (HOLD) {
#pragma unroll
      for (int i = 0; i < 4; ++i) r[i] = a[kk][i];
    } else {
      ldmatrix_x4<false>(r, p + kk * 16);
    }
  }
};

// s[j] = the warp's 16 A rows times rows [8j, 8j + 8) of an NR-row tile Bs
// (row stride LD) transposed, over the depth DP in increasing order (the
// order of mma_frag.cuh's qk_tile).
template <int DP, int LD, int NR, class A>
__device__ __forceinline__ void abt(float (&s)[NR / 8][4], const A& a, const bf16* Bs,
                                    int lane) {
#pragma unroll
  for (int j = 0; j < NR / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
  const int row = (lane % 8) + (lane / 16) * 8, col = ((lane / 8) % 2) * 8;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    uint32_t af[4];
    a.get(kk, af);
#pragma unroll
    for (int n = 0; n < NR / 16; ++n) {
      uint32_t b[4];
      ldmatrix_x4<false>(b, Bs + (n * 16 + row) * LD + kk * 16 + col);
      mma_16816(s[2 * n], af, b[0], b[1]);
      mma_16816(s[2 * n + 1], af, b[2], b[3]);
    }
  }
}

// o[j] += A B over KR rows of B: A the KR / 16 16-column A fragments pa, B
// the first NC columns of a KR-row tile Bs (row stride LD), o[j] columns
// [8j, 8j + 8) (the order of mma_frag.cuh's pv_tile).
template <int NC, int LD, int KR>
__device__ __forceinline__ void ab(float (&o)[NC / 8][4], const uint32_t (&pa)[KR / 16][4],
                                   const bf16* Bs, int lane) {
  const int row = (lane % 8) + ((lane / 8) % 2) * 8, col = (lane / 16) * 8;
#pragma unroll
  for (int kk = 0; kk < KR / 16; ++kk) {
#pragma unroll
    for (int d = 0; d < NC / 16; ++d) {
      uint32_t b[4];
      ldmatrix_x4<true>(b, Bs + (kk * 16 + row) * LD + d * 16 + col);
      mma_16816(o[2 * d], pa[kk], b[0], b[1]);
      mma_16816(o[2 * d + 1], pa[kk], b[2], b[3]);
    }
  }
}

template <int NC>
__device__ __forceinline__ void zero_acc(float (&o)[NC / 8][4]) {
#pragma unroll
  for (int j = 0; j < NC / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
}

// The A fragments of a 16 x 8NJ tile's 16-column steps, each value rounded
// to bf16 once.
template <int NJ>
__device__ __forceinline__ void pack_tile(uint32_t (&pa)[NJ / 2][4], const float (&s)[NJ][4]) {
#pragma unroll
  for (int kk = 0; kk < NJ / 2; ++kk) pack_a(pa[kk], s[2 * kk], s[2 * kk + 1]);
}

// Rows g and g + 8 of a warp's fp32 accumulators o (NC columns from the
// row pointer dst) rounded to bf16 as 4-byte pairs into rows of stride ld;
// rows at or past `rows` and columns at or past `cols` (even) are not
// written.
template <int NC>
__device__ __forceinline__ void store_acc(bf16* __restrict__ dst, size_t ld,
                                          const float (&o)[NC / 8][4], int r, int rows, int cols,
                                          int lane) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < NC / 8; ++j) {
    if (j * 8 >= cols) break;
    const int c = j * 8 + 2 * t;
    if (c >= cols) continue;
    if (r + g < rows)
      *reinterpret_cast<uint32_t*>(dst + (size_t)(r + g) * ld + c) = pack_bf16(o[j][0], o[j][1]);
    if (r + g + 8 < rows)
      *reinterpret_cast<uint32_t*>(dst + (size_t)(r + g + 8) * ld + c) =
          pack_bf16(o[j][2], o[j][3]);
  }
}

// A query row's softmax terms on the dq side: p = 2^(s scale2 - a) b, and
// dsum; [0] row g, [1] row g + 8.
struct RowTerms {
  float a[2], b[2], dsum[2];
};

// The dq side's shared memory: Q's and dO's rows, two stages of K and V
// tiles of TW keys.
template <int DP, int WARPS, int TW>
constexpr size_t bwd_dq_smem() {
  return (size_t)(2 * 16 * WARPS + 4 * TW) * (DP + kPadH) * sizeof(bf16);
}

// The dq side (see the header): rows [r0, r0 + 16 WARPS) of one head, key
// tiles of TW (64, or 32 where the accumulators leave no registers for 64);
// q, k and v at the head's row 0 (row stride ld), dO likewise (ldo), dq and
// att at their row 0 (ldq, lda), copied in PIECE-byte pieces
// (load_tile_async). SWEEP: the core's two sweeps, (m, l,
// dsum) of each row < N to stats (the head's row 0, 3 floats a row); else
// rows(r, lane, dOs, sld, terms) gives the terms of the warp's rows from r
// (its dO rows in shared memory at dOs, row stride sld), whose factor b is
// 1 (K8b's lse), so p is the exponential alone.
template <int DP, int WARPS, int TW, bool SWEEP, bool ATT, class Rows, int PIECE = 16>
__device__ __forceinline__ void bwd_dq_body(unsigned char* smem, const bf16* __restrict__ q,
                                            const bf16* __restrict__ k,
                                            const bf16* __restrict__ v, int ld,
                                            const bf16* __restrict__ dO, int ldo,
                                            bf16* __restrict__ dq, int ldq, bf16* __restrict__ att,
                                            int lda, float* __restrict__ stats, int N, int Dh,
                                            float scale, int r0, Rows rows) {
  constexpr int kThr = 32 * WARPS, kRows = 16 * WARPS, kLd = DP + kPadH, kT = TW * kLd;
  constexpr int NJ = TW / 8;
  constexpr bool kHold = DP <= 64;
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + kRows * kLd;
  bf16* Ks = dOs + kRows * kLd;  // two stages
  bf16* Vs = Ks + 2 * kT;        // two stages
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, t = lane % 4;
  const int nt = (N + TW - 1) / TW, jobs = SWEEP ? 2 * nt : nt;
  const int rw = r0 + warp * 16;  // the warp's first row
  const float scale2 = scale * kLog2e;
  // job j takes key tile j % nt: the first sweep's, then the second's; its
  // copy runs while job j - 1 computes, into the stage job j - 2 read
  auto issue = [&](int j) {
    const int i = j < nt ? j : j - nt, st = j & 1;
    load_tile_async<TW, DP, kThr, PIECE>(Ks + st * kT, k, ld, i * TW, N, Dh);
    load_tile_async<TW, DP, kThr, PIECE>(Vs + st * kT, v, ld, i * TW, N, Dh);
    cp_async_commit();
  };
  load_tile_async<kRows, DP, kThr, PIECE>(Qs, q, ld, r0, N, Dh);
  load_tile_async<kRows, DP, kThr, PIECE>(dOs, dO, ldo, r0, N, Dh);
  issue(0);

  ARows<DP, kLd, kHold> qa, da;
  RowTerms w;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, u[2] = {0.f, 0.f};
  float dqa[DP / 8][4], at[ATT ? DP / 8 : 1][4];
  zero_acc<DP>(dqa);
  if constexpr (ATT) zero_acc<DP>(at);
  for (int j = 0; j < jobs; ++j) {
    cp_async_wait<0>();
    __syncthreads();
    if (j + 1 < jobs) issue(j + 1);
    if (j == 0) {
      qa.init(Qs + warp * 16 * kLd, lane);
      da.init(dOs + warp * 16 * kLd, lane);
      if constexpr (!SWEEP) rows(rw, lane, dOs + warp * 16 * kLd, kLd, w);
    }
    const int i = j < nt ? j : j - nt, st = j & 1;
    const bf16* Kt = Ks + st * kT;
    const bf16* Vt = Vs + st * kT;
    float s[NJ][4], dp[NJ][4];
    abt<DP, kLd, TW>(s, qa, Kt, lane);
    mask_keys(s, i * TW, N, t);
    if (SWEEP && j < nt) {
      abt<DP, kLd, TW>(dp, da, Vt, lane);
      float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f}, su[2] = {0.f, 0.f};
      row_max(s, mx);
      const float m_new[2] = {fmaxf(m[0], quad_max(mx[0]) * scale),
                              fmaxf(m[1], quad_max(mx[1]) * scale)};
      const float m2[2] = {m_new[0] * kLog2e, m_new[1] * kLog2e};
#pragma unroll
      for (int c = 0; c < NJ; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = exp2_approx(s[c][e] * scale2 - m2[e / 2]);
          sum[e / 2] += x;
          su[e / 2] += x * dp[c][e];
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float corr = exp2_approx((m[r] - m_new[r]) * kLog2e);
        l[r] = l[r] * corr + quad_sum(sum[r]);
        u[r] = u[r] * corr + quad_sum(su[r]);
        m[r] = m_new[r];
      }
      if (j == nt - 1) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          w.a[r] = m[r] * kLog2e;
          w.b[r] = 1.f / l[r];
          w.dsum[r] = u[r] / l[r];
          const int row = rw + lane / 4 + 8 * r;
          if (t == 0 && row < N) {
            stats[3 * row] = m[r];
            stats[3 * row + 1] = l[r];
            stats[3 * row + 2] = w.dsum[r];
          }
        }
      }
      continue;
    }
    // P, in place of S
#pragma unroll
    for (int c = 0; c < NJ; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[c][e] = exp2_approx(s[c][e] * scale2 - w.a[e / 2]);
        if constexpr (SWEEP) s[c][e] *= w.b[e / 2];
      }
    uint32_t pa[NJ / 2][4];
    if constexpr (ATT) {
      pack_tile(pa, s);
      ab<DP, kLd, TW>(at, pa, Vt, lane);
    }
    abt<DP, kLd, TW>(dp, da, Vt, lane);
#pragma unroll
    for (int c = 0; c < NJ; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[c][e] = s[c][e] * (dp[c][e] - w.dsum[e / 2]) * scale;
    pack_tile(pa, s);
    ab<DP, kLd, TW>(dqa, pa, Kt, lane);
  }
  store_acc<DP>(dq, ldq, dqa, rw, N, Dh, lane);
  if constexpr (ATT) store_acc<DP>(att, lda, at, rw, N, Dh, lane);
}

// The dk/dv side's shared memory: K's and V's rows, two stages of Q and dO
// tiles of TW queries and of their terms (a, b, dsum a query).
template <int DP, int WARPS, int TW>
constexpr size_t bwd_dkv_smem() {
  return (size_t)(2 * 16 * WARPS + 4 * TW) * (DP + kPadH) * sizeof(bf16) +
         (size_t)2 * 3 * TW * sizeof(float);
}

// The dk/dv side (see the header): keys [c0, c0 + 16 WARPS) of one head,
// query tiles of TW; q, k, v and dO as bwd_dq_body's, dk and dv at the
// head's row 0 (row stride ldg); cols(c, a, b, dsum) gives query c's terms
// ((0, 0, 0) past N). UNIT_B: every b is 1 (K8b's lse), so p is the
// exponential alone.
template <int DP, int WARPS, int TW, class Cols, int PIECE = 16, bool UNIT_B = false>
__device__ __forceinline__ void bwd_dkv_body(unsigned char* smem, const bf16* __restrict__ q,
                                             const bf16* __restrict__ k,
                                             const bf16* __restrict__ v, int ld,
                                             const bf16* __restrict__ dO, int ldo,
                                             bf16* __restrict__ dk, bf16* __restrict__ dv,
                                             int ldg, int N, int Dh, float scale, int c0,
                                             Cols cols) {
  constexpr int kThr = 32 * WARPS, kRows = 16 * WARPS, kLd = DP + kPadH, kT = TW * kLd;
  constexpr int NJ = TW / 8, kTerms = 3 * TW;
  constexpr bool kHold = DP <= 32;
  static_assert(kThr >= TW, "a thread per query loads the query terms");
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + kRows * kLd;
  bf16* Qs = Vs + kRows * kLd;  // two stages
  bf16* dOs = Qs + 2 * kT;      // two stages
  float* terms = reinterpret_cast<float*>(dOs + 2 * kT);  // two stages
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, t = lane % 4;
  const int nt = (N + TW - 1) / TW;
  const float scale2 = scale * kLog2e;
  // query tile j's copy runs while tile j - 1 computes, into the stage tile
  // j - 2 read; its terms are read into registers then and stored after
  // tile j - 1's products, before the barrier that hands the stage over
  float ta = 0.f, tb = 0.f, td = 0.f;
  auto issue = [&](int j) {
    const int st = j & 1;
    load_tile_async<TW, DP, kThr, PIECE>(Qs + st * kT, q, ld, j * TW, N, Dh);
    load_tile_async<TW, DP, kThr, PIECE>(dOs + st * kT, dO, ldo, j * TW, N, Dh);
    cp_async_commit();
    if (threadIdx.x < TW) cols(j * TW + threadIdx.x, ta, tb, td);
  };
  auto keep_terms = [&](int j) {
    if (threadIdx.x < TW) {
      float* d = terms + (j & 1) * kTerms + threadIdx.x;
      d[0] = ta;
      d[TW] = tb;
      d[2 * TW] = td;
    }
  };
  load_tile_async<kRows, DP, kThr, PIECE>(Ks, k, ld, c0, N, Dh);
  load_tile_async<kRows, DP, kThr, PIECE>(Vs, v, ld, c0, N, Dh);
  issue(0);
  keep_terms(0);

  ARows<DP, kLd, kHold> ka, va;
  float dka[DP / 8][4], dva[DP / 8][4];
  zero_acc<DP>(dka);
  zero_acc<DP>(dva);
  for (int j = 0; j < nt; ++j) {
    cp_async_wait<0>();
    __syncthreads();
    if (j + 1 < nt) issue(j + 1);
    if (j == 0) {
      ka.init(Ks + warp * 16 * kLd, lane);
      va.init(Vs + warp * 16 * kLd, lane);
    }
    const int st = j & 1;
    const bf16* Qt = Qs + st * kT;
    const bf16* dOt = dOs + st * kT;
    const float* ca = terms + st * kTerms;
    float s[NJ][4], dp[NJ][4];
    abt<DP, kLd, TW>(s, ka, Qt, lane);  // S^T: keys x queries
#pragma unroll
    for (int c = 0; c < NJ; ++c) {
      const float2 a = *reinterpret_cast<const float2*>(ca + 8 * c + 2 * t);
      s[c][0] = exp2_approx(s[c][0] * scale2 - a.x);
      s[c][1] = exp2_approx(s[c][1] * scale2 - a.y);
      s[c][2] = exp2_approx(s[c][2] * scale2 - a.x);
      s[c][3] = exp2_approx(s[c][3] * scale2 - a.y);
      if constexpr (!UNIT_B) {
        const float2 b = *reinterpret_cast<const float2*>(ca + TW + 8 * c + 2 * t);
        s[c][0] *= b.x;
        s[c][1] *= b.y;
        s[c][2] *= b.x;
        s[c][3] *= b.y;
      }
    }
    uint32_t pa[NJ / 2][4];
    pack_tile(pa, s);
    ab<DP, kLd, TW>(dva, pa, dOt, lane);  // dv += bf16(P)^T dO
    abt<DP, kLd, TW>(dp, va, dOt, lane);  // dP^T
#pragma unroll
    for (int c = 0; c < NJ; ++c) {
      const float2 d = *reinterpret_cast<const float2*>(ca + 2 * TW + 8 * c + 2 * t);
      s[c][0] = s[c][0] * (dp[c][0] - d.x) * scale;
      s[c][1] = s[c][1] * (dp[c][1] - d.y) * scale;
      s[c][2] = s[c][2] * (dp[c][2] - d.x) * scale;
      s[c][3] = s[c][3] * (dp[c][3] - d.y) * scale;
    }
    pack_tile(pa, s);
    ab<DP, kLd, TW>(dka, pa, Qt, lane);  // dk += dS^T Q
    if (j + 1 < nt) keep_terms(j + 1);
  }
  const int kw = c0 + warp * 16;
  store_acc<DP>(dk, ldg, dka, kw, N, Dh, lane);
  store_acc<DP>(dv, ldg, dva, kw, N, Dh, lane);
}

}  // namespace

// ---- the wide backwards: K8b at Dh 256-896, the core past a padded head of 128 ----
//
// Past 128 columns a warp cannot hold a 16-row tile's dq, or its dk and dv,
// for the whole head (64 fp32 a lane per 128 columns of each), so the sides
// above take the forwards' column split (mma_frag.cuh, "the wide
// forwards"): a block is RT row tiles of 16 rows times G column groups of
// warps; group g accumulates columns [128 c + g 128 / G, 128 c + (g + 1) 128
// / G) of every 128-column chunk c, and each 16 x 64 score tile is split over
// the groups by its 64 columns (keys on the dq side, queries on the dk/dv
// side), every score one warp's in-order sum over the head. The operands
// that are not resident pass through the ring of 64-row x 128-column
// cp.async stages, one barrier a stage, each stage a depth chunk of a score
// tile or a column chunk of a gradient. A warp's bf16 slice of P or dS goes
// to its row tile's warps through shared memory, handed over by the next
// stage's barrier, and each warp reads the tile's 16 x 64 A fragments from
// there. The dq sides differ (K8b's in csrc/flash.cu: lse and dsum known;
// the core's in csrc/attention.cu: each row's softmax over the whole row
// first); the dk/dv side below is one kernel for both, built in
// csrc/attention.cu.
//
// The dk/dv side: one block per 16 RT key rows of one (image, head); K and V
// rows copied once; per 64-query tile three rounds of NC stages: Q (S^T = K
// Q^T, each warp its 64 / G queries; P^T = 2^(s scale log2 e - a) b from the
// queries' terms), dO (dP^T = V dO^T and dv += bf16(P^T) dO, the same stage
// serving both), Q again (dk += dS^T Q, dS^T = bf16(P^T (dP^T - dsum)
// scale)). dk and dv take 128 NC / G fp32 a lane, so G grows with the head
// (WideDkv).

// The dk/dv side's operands: q, k, v (rows of stride ld) and dO (ldo) at
// row 0 of image 0, head 0 of (B, N, H*Dh) rows; dk and dv likewise (ldg).
// Each query's terms: K8b's lse and dsum ((B, H, N) each), or the core's
// stats ((B, H, N, 3): m, l, dsum) where lse is null.
struct WideDkvArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  int ld;
  const bf16* dO;
  int ldo;
  bf16* dk;
  bf16* dv;
  int ldg;
  const float* lse;
  const float* dsum;
  const float* stats;
  int B, N, H, Dh;
  float scale;
};

// Launch the dk/dv side at the padded head (144-896 columns); the instance
// for NC 128-column chunks (2-7) for its attributes. csrc/attention.cu.
cudaError_t launch_bwd_dkv_wide(const WideDkvArgs& a, cudaStream_t stream);
const void* bwd_dkv_wide_kernel(int chunks);

namespace {

// The dk/dv side's layout at NC chunks: G groups, RT row tiles of 16 keys,
// 8 warps (all of a thread's 255 registers), four ring stages. dk and dv
// take 128 NC / G fp32 a lane: 128 at NC 2 (two groups, 64 keys a block),
// 96-160 at NC 3-5 (four, 32 keys), 96 and 112 at NC 6-7 (eight groups, 16
// keys: 32 key rows of dk and dv at 768 columns would take 196 KB of the
// SM's 256 KB register file). Measured on the H100 at K8b's (128, 1024, 3,
// 256): this side took 5.91 ms on two groups of 8 warps against 7.05 as two
// blocks of 4 warps (32 keys each), 8.45 on four groups of 8 (32 keys) and
// 5.45 on four groups of 16, which spills 28 B a thread at 128 registers.
template <int NC>
struct WideDkv {
  static constexpr int G = NC == 2 ? 2 : NC <= 5 ? 4 : 8;
  static constexpr int RT = 8 / G, kKeys = 16 * RT, kStages = 4;
  static size_t smem(int DP) {  // K, V, the ring, P^T and dS^T, two stages of terms
    return (size_t)2 * kKeys * (DP + kPadH) * sizeof(bf16) +
           (size_t)kStages * kWideStage * sizeof(bf16) +
           (size_t)2 * kKeys * (kWideKeys + kPadH) * sizeof(bf16) +
           (size_t)2 * 3 * kWideKeys * sizeof(float);
  }
};

template <int NC>
__global__ void __launch_bounds__(256, 1) attention_bwd_dkv_wide_kernel(WideDkvArgs a) {
  using L = WideDkv<NC>;
  constexpr int G = L::G, kRows = L::kKeys, kS = L::kStages, kThr = 256;
  constexpr int KS = kWideKeys / G, NJ = KS / 8, CW = kWideCols / G, NO = CW / 8;
  constexpr int kPld = kWideKeys + kPadH, kT = 3 * kWideKeys;
  extern __shared__ __align__(128) unsigned char smem[];
  const int N = a.N, Dh = a.Dh, DP = (Dh + 15) / 16 * 16, kld = DP + kPadH;
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + kRows * kld;
  bf16* ring = Vs + kRows * kld;
  bf16* Pts = ring + kS * kWideStage;  // bf16 P^T of each row tile, 16 x 64
  bf16* dSts = Pts + kRows * kPld;     // ... and dS^T
  float* terms = reinterpret_cast<float*>(dSts + kRows * kPld);  // two stages of (a, b, dsum)
  const int b = blockIdx.z, h = blockIdx.y, c0 = blockIdx.x * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int rt = warp / G, grp = warp % G;
  const int nt = (N + kWideKeys - 1) / kWideKeys, jobs = 3 * NC * nt;
  const size_t row0 = (size_t)b * N, stat = ((size_t)b * a.H + h) * N;
  const bf16* q = a.q + row0 * a.ld + h * Dh;
  const bf16* k = a.k + row0 * a.ld + h * Dh;
  const bf16* v = a.v + row0 * a.ld + h * Dh;
  const bf16* dO = a.dO + row0 * a.ldo + h * Dh;
  const float scale = a.scale, scale2 = scale * kLog2e;
  // job j: query tile j / (3 NC), its Q chunks, dO chunks, Q chunks again;
  // issued kS - 1 jobs ahead into the stage job j - kS read
  auto issue = [&](int j) {
    if (j < jobs) {
      const int i = j / (3 * NC), c = j % (3 * NC);
      const bool o = c >= NC && c < 2 * NC;
      load_chunk_async<kThr>(ring + (j % kS) * kWideStage, o ? dO : q, o ? a.ldo : a.ld,
                             i * kWideKeys, N, (c % NC) * kWideCols, DP, Dh);
    }
    cp_async_commit();
  };
  int job = 0;
  auto next = [&]() {
    cp_async_wait<kS - 2>();
    __syncthreads();
    issue(job + kS - 1);
    return ring + (job++ % kS) * kWideStage;
  };
  // query c's terms: (lse log2 e, 1, dsum) or (m log2 e, 1 / l, dsum); zeros past N
  auto terms_of = [&](int c, float& ta, float& tb, float& td) {
    ta = tb = td = 0.f;
    if (c >= N) return;
    if (a.lse) {
      ta = a.lse[stat + c] * kLog2e;
      tb = 1.f;
      td = a.dsum[stat + c];
    } else {
      const float* s = a.stats + 3 * (stat + c);
      ta = s[0] * kLog2e;
      tb = 1.f / s[1];
      td = s[2];
    }
  };
  load_rows_async<kRows, kThr>(Ks, kld, k, a.ld, c0, N, DP, Dh);
  load_rows_async<kRows, kThr>(Vs, kld, v, a.ld, c0, N, DP, Dh);
#pragma unroll
  for (int j = 0; j < kS - 1; ++j) issue(j);
  float ta, tb, td;  // a thread < 64: its query's terms of the next tile
  if (threadIdx.x < kWideKeys) terms_of(threadIdx.x, ta, tb, td);
  float dk[NC][NO][4], dv[NC][NO][4];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int j = 0; j < NO; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[c][j][e] = dv[c][j][e] = 0.f;
  const bf16* kw = Ks + rt * 16 * kld;
  const bf16* vw = Vs + rt * 16 * kld;
  bf16* pw = Pts + rt * 16 * kPld;
  bf16* dsw = dSts + rt * 16 * kPld;
  for (int i = 0; i < nt; ++i) {
    // this tile's terms to the stage tile i - 2 read (every warp is past it),
    // handed over by the next barrier
    float* tm = terms + (i & 1) * kT;
    if (threadIdx.x < kWideKeys) {
      tm[threadIdx.x] = ta;
      tm[kWideKeys + threadIdx.x] = tb;
      tm[2 * kWideKeys + threadIdx.x] = td;
      if (i + 1 < nt) terms_of((i + 1) * kWideKeys + threadIdx.x, ta, tb, td);
    }
    float s[NJ][4], dp[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c)  // S^T = K Q^T over the depth chunks
      qk_chunk<NJ>(s, kw + c * kWideCols, kld, next() + grp * KS * kWideLd,
                   min(kWideCols, DP - c * kWideCols), lane);
    // P^T, queries by column, to the row tile's warps as bf16
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = grp * KS + 8 * j + 2 * t;
      const float2 qa = *reinterpret_cast<const float2*>(tm + col);
      const float2 qb = *reinterpret_cast<const float2*>(tm + kWideKeys + col);
      s[j][0] = exp2_approx(s[j][0] * scale2 - qa.x) * qb.x;
      s[j][1] = exp2_approx(s[j][1] * scale2 - qa.y) * qb.y;
      s[j][2] = exp2_approx(s[j][2] * scale2 - qa.x) * qb.x;
      s[j][3] = exp2_approx(s[j][3] * scale2 - qa.y) * qb.y;
      *reinterpret_cast<uint32_t*>(pw + g * kPld + col) = pack_bf16(s[j][0], s[j][1]);
      *reinterpret_cast<uint32_t*>(pw + (g + 8) * kPld + col) = pack_bf16(s[j][2], s[j][3]);
    }
    uint32_t pa[4][4];
#pragma unroll
    for (int c = 0; c < NC; ++c) {  // dP^T = V dO^T (depth chunk c), dv += P^T dO (columns)
      const bf16* st = next();  // at c = 0 its barrier also hands P^T over
      if (c == 0) load_a_frags<kWideKeys>(pa, pw, lane);
      qk_chunk<NJ>(dp, vw + c * kWideCols, kld, st + grp * KS * kWideLd,
                   min(kWideCols, DP - c * kWideCols), lane);
      const int w = min(CW, DP - c * kWideCols - grp * CW);
      if (w > 0) pv_chunk<NO>(dv[c], pa, st + grp * CW, w, lane);
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = grp * KS + 8 * j + 2 * t;
      const float2 qd = *reinterpret_cast<const float2*>(tm + 2 * kWideKeys + col);
      *reinterpret_cast<uint32_t*>(dsw + g * kPld + col) =
          pack_bf16(s[j][0] * (dp[j][0] - qd.x) * scale, s[j][1] * (dp[j][1] - qd.y) * scale);
      *reinterpret_cast<uint32_t*>(dsw + (g + 8) * kPld + col) =
          pack_bf16(s[j][2] * (dp[j][2] - qd.x) * scale, s[j][3] * (dp[j][3] - qd.y) * scale);
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) {  // dk += dS^T Q
      const bf16* st = next();      // at c = 0 its barrier also hands dS^T over
      if (c == 0) load_a_frags<kWideKeys>(pa, dsw, lane);
      const int w = min(CW, DP - c * kWideCols - grp * CW);
      if (w > 0) pv_chunk<NO>(dk[c], pa, st + grp * CW, w, lane);
    }
  }
  const int r = c0 + rt * 16;
  store_wide<NC, NO>(a.dk + row0 * a.ldg + h * Dh, a.ldg, dk, 1.f, 1.f, r, N, grp * CW, Dh,
                     lane);
  store_wide<NC, NO>(a.dv + row0 * a.ldg + h * Dh, a.ldg, dv, 1.f, 1.f, r, N, grp * CW, Dh,
                     lane);
}

}  // namespace
}  // namespace ddm
