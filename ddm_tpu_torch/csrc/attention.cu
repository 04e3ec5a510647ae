// Multi-head attention cores of the DiT attention half-block, 16 <= N <= 512
// tokens (N a multiple of 16), head widths Dh a multiple of 8: every (N, Dh)
// the JAX gates send to K2f, K2b, K4 and K7 (Dh up to 3712 at N = 16).
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
// buffer). The backward's earlier designs (the registers design below is
// the plan's pick wherever the padded head is at most 128 columns wide):
// where one (image, head)'s fp32 P and dP tiles fit a block (N <= 112 at
// Dh = 64) one block
// per (image, head) keeps Q, K, V, dO, P and dP in shared memory (81 KB at
// N = Dh = 64) and computes the scores once. Past that, two passes with no
// atomics and a fixed order: pass 1, over query tiles, computes P, att, dP,
// the row terms rowsum(P dP) and dq, and saves each row's (max, sum,
// rowsum(P dP)) in fp32; pass 2, over key tiles, walks the query tiles in
// order, recomputes P from the saved max and sum, and accumulates dv and dk
// in fp32 in shared memory, rounding once.
//
// Resident and streamed: the forward core and both passes read a head in
// column chunks of C. Where a whole head fits (C = the padded Dh, the
// resident design, compiled as its own instance) each operand is loaded
// once. Past 227 KB (DiT-S --heads 1 at 64 px: N 256, Dh 384, 246,528 B
// resident) the streamed design passes the head through kChunk = 64 columns
// at a time, and only the fp32 score rows (QT x N, 64 KB at most) and the
// bf16 P rows stay whole: each 16 x 16 score tile (Q K^T, dO V^T) goes on
// from its fp32 value stored after the last depth slice, which is exactly
// the value a fragment kept across the slices would hold, and each output
// (P V, dS K) is one column chunk of independent tiles, summed over the
// keys as before. Pass 2 takes a grid axis of output column chunks of C2
// (dk and dv of one key tile, fp32 in shared memory): each of its blocks
// recomputes S and dP over the whole head in kChunk slices, so the
// recomputation grows with Dh / C2, which is as large as shared memory
// allows (the whole head up to Dh ~880). Each pass takes the resident tiles
// where they fit and the streamed ones elsewhere (core_plan / cols_plan).
// No online softmax: the softmax is the same code on the same whole row.
// Every product runs its 16 x 16 tiles over the same depth slices in the
// same order in every design, and the recomputed P is the same expression
// of the same scores, so where two designs take a shape their outputs
// agree bit for bit.
//
// Head widths: the WMMA fragments are 16 deep and 16 wide, and the JAX gates
// take any Dh % 8 = 0 (DiT-XL's 16 heads of 72, DiT-S at --heads 16: 24).
// Each head's tile in shared memory is padded to the next multiple of 16
// (72 -> 80, 24 -> 32) with zero columns: zeros added to q and k leave Q K^T
// as it is, and the padded columns of P V, dS K and the other products are
// never written back. A head's columns start at h Dh elements, a multiple
// of 16 bytes, so the 16-byte loads hold; a head row is Dh / 8 of them (9 at
// Dh 72), and a chunk starts on a multiple of 16 columns, so no chunk splits
// one. Where Dh % 16 = 0 nothing is padded and the products are the ones
// before the padding existed.
//
// The registers design (the forward core's third, the plan's own pick at
// padded(Dh) <= 896; attention_core_wide_kernel past 128, described there):
// at padded(Dh) <= 128 the resident core keeps S, P and O in shared
// memory as WMMA tiles, reads them back in scalar passes and loads every
// operand synchronously, so no copy overlaps a product; it is ~10x SDPA.
// Here one block of 4 warps takes 64 query rows of one (image, head), each
// warp 16 rows: Q is copied once and held as mma.sync m16n8k16 A fragments,
// K and V pass through a two-stage cp.async ring of 64-key tiles (B
// fragments by ldmatrix, .trans for V), and S, P and O stay in registers
// (mma_frag.cuh). The softmax is still exact over the whole row: where N <=
// 128 a warp holds all its scores (64 fp32 a lane); past that a first sweep
// over the key tiles takes each row's max m and sum l (l rescaled as m
// grows, the four lanes of a row reduced by shuffles), and a second sweep
// recomputes S and forms P = bf16(exp(s scale - m) / l) straight into A
// fragments for P V. Keys past a ragged N are masked to -inf, and padded
// columns are zero-filled as above. The rounding plan is the one above; the
// sums run in another order than the resident core's (fragment order, four
// lanes a row, O summed over 16-key steps) and exp is the card's ex2 with
// log2 e folded into the scale (mma_frag.cuh), so its bits are not the
// resident core's and the card checks it against the plain version.
//
// The backward's registers design (the plan's pick at padded(Dh) <= 896;
// past 128 the wide design, described at attention_core_bwd_dq_wide_kernel):
// the one-block core and the two passes keep P, dP and dS in shared memory
// as fp32 WMMA tiles, run scalar softmax and dS passes over them behind
// about ten barriers and load every operand synchronously; ~8x SDPA's
// forward and backward. Here (attention_bwd_regs.cuh, shared with K8b)
// every product is mma.sync on register fragments. Past N 64 two kernels:
// the dq side, 64 query rows a block, sweeps the key tiles twice, the first
// for each row's max, sum and u = sum e dP (dsum = u / l is rowsum(P dP) of
// the fp32 P and dP, the rounding plan above up to the order of the sums),
// the second for P, att, dS and dq, and saves (m, l, dsum) to stats; the
// dk/dv side, 64 key rows a block, recomputes S^T and dP^T (keys x queries)
// over the query tiles in order and accumulates dv and dk in registers. At
// N <= 64 one block per (image, head) does all of it (the fused design): S
// and dP once, bf16 P and dS through shared memory to the warps that own
// dk's and dv's key rows. No atomics; each output written once, so a
// second call is bit-identical. Its sums run in another order than the
// earlier designs', so checks of their bits force them by name.
#include "attention_bwd_regs.cuh"
#include "attention_tiles.cuh"
#include "mma_frag.cuh"

namespace ddm {
namespace {

// The forward core's shared memory at QT query rows and column chunks of C.
size_t core_smem(int N, int C, int QT) {
  const int CLD = C + kPadH, SLD = (N > C ? N : C) + kPadF;
  return (size_t)(QT + N) * CLD * sizeof(bf16) + (size_t)QT * SLD * sizeof(float) +
         (size_t)QT * (N + kPadH) * sizeof(bf16);
}

// K2f's and K7f's core: block (b H + h, t) writes rows [t QT, (t + 1) QT)
// of one (image, head). Q and K pass through in column chunks of C (the
// depth slices of S = Q K^T in order), then V (O = P V a column chunk at a
// time); the resident instance (!STREAM: C = padded(Dh)) reads each once.
template <bool STREAM>
__global__ void __launch_bounds__(kThreads)
attention_core_kernel(Heads in, bf16* __restrict__ out, int N, int H, int Dh, float scale,
                      int QT, int C) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int D = H * Dh, DP = padded(Dh);
  if (!STREAM) C = DP;
  const int n = STREAM ? (DP + C - 1) / C : 1;  // column chunks
  const int CLD = C + kPadH, SLD = max(N, C) + kPadF, PLD = N + kPadH;
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* KV = Qs + QT * CLD;
  float* S = reinterpret_cast<float*>(KV + N * CLD);  // scores, then an output chunk
  bf16* P = reinterpret_cast<bf16*>(S + QT * SLD);

  const int b = blockIdx.x / H, h = blockIdx.x % H, r0 = blockIdx.y * QT;
  const bf16* q = in.row(in.q, b, N, r0, h, Dh);
  const bf16* k = in.row(in.k, b, N, 0, h, Dh);
  const bf16* v = in.row(in.v, b, N, 0, h, Dh);
  for (int i = 0; i < n; ++i) {
    const int c0 = i * C, w = min(C, DP - c0);
    load_cols(Qs, CLD, q, in.ld, QT, c0, w, Dh);
    load_cols(KV, CLD, k, in.ld, N, c0, w, Dh);
    __syncthreads();
    mma_tiles_from<false, true>(i > 0, Qs, CLD, KV, CLD, S, SLD, QT, N, w);  // S += Q K^T
    __syncthreads();
  }
  load_cols(KV, CLD, v, in.ld, N, 0, min(C, DP), Dh);  // V over K
  softmax_rows(S, SLD, P, PLD, QT, N, scale, false, nullptr);
  __syncthreads();
  bf16* o = out + ((size_t)b * N + r0) * D + h * Dh;
  for (int i = 0; i < n; ++i) {
    const int c0 = i * C, w = min(C, DP - c0);
    if (i > 0) {
      load_cols(KV, CLD, v, in.ld, N, c0, w, Dh);
      __syncthreads();
    }
    mma_tiles<false, false, false>(P, PLD, KV, CLD, S, SLD, QT, w, N);  // O = P V
    __syncthreads();
    store_head(o + c0, D, S, SLD, QT, min(w, Dh - c0));
  }
}

// The registers design's tiles: keys a ring stage and the widest padded
// head it takes; a block's query rows are 16 a warp.
constexpr int kRegKeys = 64;
constexpr int kRegMaxWidth = 128;

// Q's rows, then two stages of K and two of V.
size_t regs_smem(int DP, int rows) {
  return (size_t)(rows + 4 * kRegKeys) * (DP + kPadH) * sizeof(bf16);
}

// e = exp(s scale - m) in place, rows g and g + 8, as 2^(s scale2 - m
// log2 e) with scale2 = scale log2 e (mma_frag.cuh); adds the lane's part of
// each row's sum of e to sum.
__device__ __forceinline__ void exp_rows(float (&s)[8][4], float scale2, const float (&m)[2],
                                         float (&sum)[2]) {
  const float m2[2] = {m[0] * kLog2e, m[1] * kLog2e};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = exp2_approx(s[j][e] * scale2 - m2[e / 2]);
      sum[e / 2] += s[j][e];
    }
}

// p = e / l rounded to bf16 once (e times the row's 1 / l), packed into the
// A fragments of the key tile's four 16-key steps.
__device__ __forceinline__ void probs_a(uint32_t (&pa)[4][4], float (&e)[8][4],
                                        const float (&inv_l)[2]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) e[j][c] *= inv_l[c / 2];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) pack_a(pa[kk], e[2 * kk], e[2 * kk + 1]);
}

// K2f's and K7f's core, the registers design: block (b H + h, t) of WARPS
// warps, each with 16 query rows, writes rows [R t, R (t + 1)) of one
// (image, head), R = 16 WARPS. The block walks a list of jobs, each one
// stage of the ring: jobs 0 .. nt - 1 take K tile j (S), jobs nt .. 2 nt - 1
// the V tile of key tile j - nt (P V). HOLD > 0 (N <= 64 HOLD): each warp
// keeps its rows' scores of every key tile, and the V jobs form P from them;
// HOLD = 0: the K jobs take each row's max and sum, and the V jobs load K
// again and recompute S. Job j + 1's copy runs while job j computes, into
// the stage job j - 1 read: every warp has passed job j's barrier, so is
// done with it. Fragments carry a leading row-tile axis of 1 (mma_frag.cuh).
template <int DP, int HOLD, int WARPS>
__global__ void __launch_bounds__(32 * WARPS)
attention_core_regs_kernel(Heads in, bf16* __restrict__ out, int N, int H, int Dh, float scale) {
  constexpr int kThr = 32 * WARPS, kRows = 16 * WARPS;
  constexpr int kLd = DP + kPadH, kTile = kRegKeys * kLd;
  constexpr int kSlots = HOLD > 0 ? HOLD : 1;  // held score tiles
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + kRows * kLd;  // two stages
  bf16* Vs = Ks + 2 * kTile;    // two stages
  const int b = blockIdx.x / H, h = blockIdx.x % H, r0 = blockIdx.y * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, t = lane % 4;
  const int nt = (N + kRegKeys - 1) / kRegKeys;  // key tiles
  const float scale2 = scale * kLog2e;
  const bf16* q = in.row(in.q, b, N, 0, h, Dh);
  const bf16* k = in.row(in.k, b, N, 0, h, Dh);
  const bf16* v = in.row(in.v, b, N, 0, h, Dh);
  auto issue = [&](int j) {
    const int i = j < nt ? j : j - nt, st = j & 1;
    if (j < nt || HOLD == 0)
      load_tile_async<kRegKeys, DP, kThr>(Ks + st * kTile, k, in.ld, i * kRegKeys, N, Dh);
    if (j >= nt)
      load_tile_async<kRegKeys, DP, kThr>(Vs + st * kTile, v, in.ld, i * kRegKeys, N, Dh);
    cp_async_commit();
  };
  // wait for job j's tiles (and, at job 0, Q's, held from then on); start
  // job j + 1's copy
  uint32_t qa[1][DP / 16][4];
  auto next = [&](int j) {
    cp_async_wait<0>();
    __syncthreads();
    if (j + 1 < 2 * nt) issue(j + 1);
    if (j == 0) load_a_frags<DP>(qa[0], Qs + warp * 16 * kLd, lane);
  };
  float o[1][DP / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) o[0][j][0] = o[0][j][1] = o[0][j][2] = o[0][j][3] = 0.f;
  // rows g and g + 8
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, inv_l[2];
  uint32_t pa[1][4][4];

  load_tile_async<kRows, DP, kThr>(Qs, q, in.ld, r0, N, Dh);
  issue(0);
  if constexpr (HOLD > 0) {
    float s[kSlots][1][8][4];
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      if (i < nt) {
        next(i);
        qk_tile<DP, 1>(s[i], qa, Ks + (i & 1) * kTile, lane);
        mask_keys(s[i][0], i * kRegKeys, N, t);
        row_max(s[i][0], m);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          s[i][0][j][0] = s[i][0][j][1] = s[i][0][j][2] = s[i][0][j][3] = -INFINITY;
      }
    }
    // the row's max, then its sum of exp(s scale - max), over every key
    m[0] = quad_max(m[0]) * scale;
    m[1] = quad_max(m[1]) * scale;
#pragma unroll
    for (int i = 0; i < kSlots; ++i) exp_rows(s[i][0], scale2, m, l);
    inv_l[0] = 1.f / quad_sum(l[0]);
    inv_l[1] = 1.f / quad_sum(l[1]);
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      if (i < nt) {
        next(nt + i);
        probs_a(pa[0], s[i][0], inv_l);
        pv_tile<DP, 1>(o, pa, Vs + ((nt + i) & 1) * kTile, lane);
      }
    }
  } else {
    for (int j = 0; j < 2 * nt; ++j) {
      next(j);
      const int i = j < nt ? j : j - nt, st = j & 1;
      float s[1][8][4], sum[2] = {0.f, 0.f};
      qk_tile<DP, 1>(s, qa, Ks + st * kTile, lane);
      mask_keys(s[0], i * kRegKeys, N, t);
      if (j < nt) {
        float mx[2] = {-INFINITY, -INFINITY};
        row_max(s[0], mx);
        const float m_new[2] = {fmaxf(m[0], quad_max(mx[0]) * scale),
                                fmaxf(m[1], quad_max(mx[1]) * scale)};
        exp_rows(s[0], scale2, m_new, sum);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          l[r] = l[r] * exp2_approx((m[r] - m_new[r]) * kLog2e) + quad_sum(sum[r]);
          m[r] = m_new[r];
        }
      } else {
        if (j == nt) {
          inv_l[0] = 1.f / l[0];
          inv_l[1] = 1.f / l[1];
        }
        exp_rows(s[0], scale2, m, sum);  // l is known: the sums go unused
        probs_a(pa[0], s[0], inv_l);
        pv_tile<DP, 1>(o, pa, Vs + st * kTile, lane);
      }
    }
  }
  const int D = H * Dh;
  store_rows_bf16<DP>(out + (size_t)b * N * D + h * Dh, D, o[0], 1.f, 1.f, r0 + warp * 16, N, Dh,
                      lane);
}

// The registers design past a padded head of 128 (padded widths 144-896,
// mma_frag.cuh's "wide forwards"): the resident and streamed cores keep QT
// whole fp32 score rows and the bf16 P rows in shared memory, pass Q, K and
// V through one N-row buffer by synchronous copies, run every product as
// WMMA tiles from shared memory and the softmax as a scalar pass. Here one
// block of WARPS warps takes 4 WARPS query rows of one (image, head): RT
// row tiles times 4 column groups (wide_core_warps), Q copied once, K and V
// through the ring of 64-key x 128-column stages. The scores are written
// once, not recomputed: each warp's 16 x 64 / G slice of every key tile
// (masked to -inf past a ragged N) goes to the block's fp32 score rows in
// shared memory (16 x N a row tile, 32 KB at N 512), and the softmax then
// runs over the whole row: the row's max over the slices and the groups
// (through shared memory), e = exp(s scale - max) written in place over
// each warp's own slices with its part of the row's sum, the sum over the
// groups, and in the P V sweep each warp reads its 16 rows of e of every
// key tile as P = bf16(e / l) (e times 1 / l, rounded once) in A
// fragments. The rounding plan is the cores' (fp32 scores, the exact
// max-subtracted softmax over the whole row, P rounded once, P V in fp32
// rounded once); the sums run in fragment order and exp is the card's ex2,
// as in the registers design at 128 and below.
constexpr int kWideCoreStages = 4, kWideCoreGroups = 4;  // ring stages; column groups

// Q's rows (4 WARPS), the ring, the score rows of every key tile, two
// exchanges.
size_t wide_core_smem(int N, int DP, int warps) {
  const int rows = 16 * warps / kWideCoreGroups;
  const int sld = (N + kWideKeys - 1) / kWideKeys * kWideKeys + 8;
  return (size_t)rows * (DP + kPadH) * sizeof(bf16) +
         (size_t)kWideCoreStages * kWideStage * sizeof(bf16) + (size_t)rows * sld * sizeof(float) +
         (size_t)2 * warps * 16 * sizeof(float);
}

// A block's warps: 16 (64 query rows) up to a padded head of 512, where a
// thread's 128 registers hold its 64 fp32 of O, and where the block's
// shared memory fits; else 8 (32 rows). Measured on the H100, 16 warps
// took 0.607 ms at DiT-L/4 --heads 2's (256, 256, 2, 512) against 0.95 on
// 8, and were 5-7% faster than two column groups of 8 warps (64 rows, 128
// columns of O a warp) at padded 208, 256 and 384.
int wide_core_warps(int N, int DP) {
  return DP <= 512 && wide_core_smem(N, DP, 16) <= kMaxSmem ? 16 : 8;
}

// NC: the padded head's 128-column chunks (the last may be narrower).
template <int NC, int WARPS>
__global__ void __launch_bounds__(32 * WARPS)
attention_core_wide_kernel(Heads in, bf16* __restrict__ out, int N, int H, int Dh,
                           float scale) {
  constexpr int G = kWideCoreGroups, RT = WARPS / G, kRows = 16 * RT, kThr = 32 * WARPS;
  constexpr int KS = kWideKeys / G, NJ = KS / 8, CW = kWideCols / G, NO = CW / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  const int DP = padded(Dh), qld = DP + kPadH;
  const int nt = (N + kWideKeys - 1) / kWideKeys, sld = nt * kWideKeys + 8;
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* ring = Qs + kRows * qld;
  float* S = reinterpret_cast<float*>(ring + kWideCoreStages * kWideStage);  // scores, then e
  float* xm = S + kRows * sld;  // 16 rows a warp: raw maxima
  float* xl = xm + WARPS * 16;  // ... and the parts of the row sums
  const int b = blockIdx.x / H, h = blockIdx.x % H, r0 = blockIdx.y * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int rt = warp / G, grp = warp % G;
  const int kjobs = nt * NC, jobs = 2 * kjobs;
  const float scale2 = scale * kLog2e;
  const bf16* q = in.row(in.q, b, N, 0, h, Dh);
  const bf16* k = in.row(in.k, b, N, 0, h, Dh);
  const bf16* v = in.row(in.v, b, N, 0, h, Dh);
  // jobs 0 .. kjobs - 1: key tile j / NC, K chunk j % NC; then the same of
  // V; job j's copy is issued at job j - (S - 1) into the stage job j - S
  // read, S = kWideCoreStages
  constexpr int kS = kWideCoreStages;
  auto issue = [&](int j) {
    if (j < jobs) {
      const int i = (j % kjobs) / NC, c = j % NC;
      load_chunk_async<kThr>(ring + (j % kS) * kWideStage, j < kjobs ? k : v, in.ld,
                             i * kWideKeys, N, c * kWideCols, DP, Dh);
    }
    cp_async_commit();
  };
  int job = 0;
  auto next = [&]() {  // wait for the next job's stage; start the copy kS - 1 ahead
    cp_async_wait<kS - 2>();
    __syncthreads();
    issue(job + kS - 1);
    return ring + (job++ % kS) * kWideStage;
  };
  load_rows_async<kRows, kThr>(Qs, qld, q, in.ld, r0, N, DP, Dh);
#pragma unroll
  for (int j = 0; j < kS - 1; ++j) issue(j);
  const bf16* qw = Qs + rt * 16 * qld;
  float* Sw = S + rt * 16 * sld;  // the row tile's score rows
  float mx[2] = {-INFINITY, -INFINITY};  // rows g and g + 8
  for (int i = 0; i < nt; ++i) {
    float s[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      qk_chunk<NJ>(s, qw + c * kWideCols, qld, next() + grp * KS * kWideLd,
                   min(kWideCols, DP - c * kWideCols), lane);
    const int k0 = i * kWideKeys + grp * KS;
    mask_keys(s, k0, N, t);
    row_max(s, mx);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      float* dst = Sw + k0 + 8 * j + 2 * t;
      *reinterpret_cast<float2*>(dst + g * sld) = make_float2(s[j][0], s[j][1]);
      *reinterpret_cast<float2*>(dst + (g + 8) * sld) = make_float2(s[j][2], s[j][3]);
    }
  }
  // the row's max over its slices and the groups, times the scale (> 0)
  mx[0] = quad_max(mx[0]);
  mx[1] = quad_max(mx[1]);
  if (t == 0) {
    xm[warp * 16 + g] = mx[0];
    xm[warp * 16 + g + 8] = mx[1];
  }
  __syncthreads();
  group_max<G>(xm + rt * G * 16, g, mx);
  const float m2[2] = {mx[0] * scale * kLog2e, mx[1] * scale * kLog2e};
  // e = exp(s scale - max) over the warp's own slices, in place, and its
  // part of each row's sum
  float l[2] = {0.f, 0.f};
  for (int i = 0; i < nt; ++i) {
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float2* p = reinterpret_cast<float2*>(Sw + (g + 8 * r) * sld + i * kWideKeys +
                                              grp * KS + 8 * j + 2 * t);
        float2 e = *p;
        e.x = exp2_approx(e.x * scale2 - m2[r]);
        e.y = exp2_approx(e.y * scale2 - m2[r]);
        l[r] += e.x + e.y;
        *p = e;
      }
  }
  l[0] = quad_sum(l[0]);
  l[1] = quad_sum(l[1]);
  if (t == 0) {
    xl[warp * 16 + g] = l[0];
    xl[warp * 16 + g + 8] = l[1];
  }
  __syncthreads();  // every e written; the parts of l
  group_sum<G>(xl + rt * G * 16, g, l);
  const float inv_l[2] = {1.f / l[0], 1.f / l[1]};
  float acc[NC][NO][4];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int j = 0; j < NO; ++j) acc[c][j][0] = acc[c][j][1] = acc[c][j][2] = acc[c][j][3] = 0.f;
  for (int i = 0; i < nt; ++i) {
    // P = bf16(e / l) of the warp's 16 rows over the tile's 64 keys
    uint32_t pa[4][4];
    const float* e = Sw + i * kWideKeys + 2 * t;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float2 e0 = *reinterpret_cast<const float2*>(e + g * sld + 16 * kk);
      const float2 e1 = *reinterpret_cast<const float2*>(e + (g + 8) * sld + 16 * kk);
      const float2 e2 = *reinterpret_cast<const float2*>(e + g * sld + 16 * kk + 8);
      const float2 e3 = *reinterpret_cast<const float2*>(e + (g + 8) * sld + 16 * kk + 8);
      pa[kk][0] = pack_bf16(e0.x * inv_l[0], e0.y * inv_l[0]);
      pa[kk][1] = pack_bf16(e1.x * inv_l[1], e1.y * inv_l[1]);
      pa[kk][2] = pack_bf16(e2.x * inv_l[0], e2.y * inv_l[0]);
      pa[kk][3] = pack_bf16(e3.x * inv_l[1], e3.y * inv_l[1]);
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int w = min(CW, DP - c * kWideCols - grp * CW);  // the group's columns here
      const bf16* st = next();
      if (w > 0) pv_chunk<NO>(acc[c], pa, st + grp * CW, w, lane);
    }
  }
  const int D = H * Dh;
  store_wide<NC, NO>(out + (size_t)b * N * D + h * Dh, D, acc, 1.f, 1.f, r0 + rt * 16, N,
                     grp * CW, Dh, lane);
}

// The backward's registers design past a padded head of 128 (attention_bwd_
// regs.cuh, "the wide backwards"; ddm_attention_core_bwd's launcher below):
// the two passes keep P, dP and dS as fp32 WMMA tiles in shared memory
// behind about ten barriers a tile and copy every operand synchronously,
// pass 1 reading V twice and pass 2 K and V again for each query tile. Here
// three kernels: att, where asked, by the wide forward core above (the same
// scores, the same exact softmax and P = bf16(e / l): the forward's bits,
// and the dq side keeps one accumulator); the dq side below; the dk/dv side
// shared with K8b. The dq side: 16 RT query rows a block (32, or 16 where
// their score rows do not fit) on 4 RT warps, four column groups a row tile
// as the forward's. Q and dO are copied once. Phase 1 streams each key
// tile's K chunks (S) and V chunks (dP = dO V^T), each warp 16 of its 64
// keys at the full depth, and writes both fp32 slices once to shared memory
// (16 x N each a row tile; keys past N masked to -inf): no sweep is
// repeated. The row's max over the groups, e = exp(s scale - max) in place
// with the warp's parts of l = sum e and u = sum e dP, summed over the
// groups: dsum = u / l, rowsum(P dP) of the fp32 P and dP up to the order
// of the sums, and (m, l, dsum) to stats for the dk/dv side. Phase 2
// streams each key tile's K chunks once more: every warp forms the row
// tile's dS = bf16(P (dP - dsum) scale) from shared memory (P = e / l in
// fp32) straight into A fragments and adds dS K into its 32 columns of
// every chunk of dq (at most 112 fp32 a lane).
constexpr int kWideBwdGroups = 4;

// Q's and dO's rows, the ring, the fp32 score and dP rows, three exchanges.
size_t wide_bwd_dq_smem(int N, int DP, int rt) {
  const int rows = 16 * rt, sld = (N + kWideKeys - 1) / kWideKeys * kWideKeys + 8;
  return (size_t)2 * rows * (DP + kPadH) * sizeof(bf16) +
         (size_t)kWideCoreStages * kWideStage * sizeof(bf16) +
         (size_t)2 * rows * sld * sizeof(float) +
         (size_t)3 * kWideBwdGroups * rows * sizeof(float);
}

// Row tiles a dq block: two where they fit (every path's shape), else one
// (N 512 at padded 896 takes 194,816 B).
int wide_bwd_dq_rt(int N, int DP) { return wide_bwd_dq_smem(N, DP, 2) <= kMaxSmem ? 2 : 1; }

// NC: the padded head's 128-column chunks; 4 RT warps (blockDim).
template <int NC>
__global__ void __launch_bounds__(256, 1)
attention_core_bwd_dq_wide_kernel(Heads in, const bf16* __restrict__ datt, DHeads out,
                                  float* __restrict__ stats, int N, int H, int Dh, float scale) {
  constexpr int G = kWideBwdGroups, KS = kWideKeys / G, NJ = KS / 8, CW = kWideCols / G;
  constexpr int NO = CW / 8, kS = kWideCoreStages;
  extern __shared__ __align__(128) unsigned char smem[];
  const int warps = blockDim.x / 32, rows = 4 * warps;
  const int DP = padded(Dh), qld = DP + kPadH;
  const int nt = (N + kWideKeys - 1) / kWideKeys, sld = nt * kWideKeys + 8;
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + rows * qld;
  bf16* ring = dOs + rows * qld;
  float* S = reinterpret_cast<float*>(ring + kS * kWideStage);  // scores, then e
  float* dP = S + rows * sld;
  float* xm = dP + rows * sld;  // 16 rows a warp: raw maxima
  float* xl = xm + warps * 16;  // ... the parts of l
  float* xu = xl + warps * 16;  // ... and of u
  const int b = blockIdx.x / H, h = blockIdx.x % H, r0 = blockIdx.y * rows, D = H * Dh;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int rt = warp / G, grp = warp % G;
  const int kjobs = 2 * NC * nt, jobs = kjobs + NC * nt;
  const float scale2 = scale * kLog2e;
  const bf16* q = in.row(in.q, b, N, 0, h, Dh);
  const bf16* k = in.row(in.k, b, N, 0, h, Dh);
  const bf16* v = in.row(in.v, b, N, 0, h, Dh);
  const bf16* dO = datt + (size_t)b * N * D + h * Dh;
  // jobs: key tile i's K chunks then V chunks (phase 1), then each key
  // tile's K chunks (phase 2); issued kS - 1 ahead into the stage job j - kS
  // read
  auto issue = [&](int j) {
    if (j < jobs) {
      const bool p1 = j < kjobs;
      const int i = p1 ? j / (2 * NC) : (j - kjobs) / NC;
      const int c = p1 ? j % (2 * NC) : (j - kjobs) % NC;
      load_chunk_async_any(ring + (j % kS) * kWideStage, c >= NC ? v : k, in.ld, i * kWideKeys,
                           N, (c % NC) * kWideCols, DP, Dh);
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
  load_rows_async_any(Qs, qld, q, in.ld, r0, rows, N, DP, Dh);
  load_rows_async_any(dOs, qld, dO, D, r0, rows, N, DP, Dh);
#pragma unroll
  for (int j = 0; j < kS - 1; ++j) issue(j);
  const bf16* qw = Qs + rt * 16 * qld;
  const bf16* dw = dOs + rt * 16 * qld;
  float* Sw = S + rt * 16 * sld;  // the row tile's score rows
  float* dPw = dP + rt * 16 * sld;
  float mx[2] = {-INFINITY, -INFINITY};  // rows g and g + 8
  for (int i = 0; i < nt; ++i) {
    const int k0 = i * kWideKeys + grp * KS;
    float s[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      qk_chunk<NJ>(s, qw + c * kWideCols, qld, next() + grp * KS * kWideLd,
                   min(kWideCols, DP - c * kWideCols), lane);
    mask_keys(s, k0, N, t);
    row_max(s, mx);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      float* dst = Sw + k0 + 8 * j + 2 * t;
      *reinterpret_cast<float2*>(dst + g * sld) = make_float2(s[j][0], s[j][1]);
      *reinterpret_cast<float2*>(dst + (g + 8) * sld) = make_float2(s[j][2], s[j][3]);
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    }
#pragma unroll
    for (int c = 0; c < NC; ++c)  // dP = dO V^T
      qk_chunk<NJ>(s, dw + c * kWideCols, qld, next() + grp * KS * kWideLd,
                   min(kWideCols, DP - c * kWideCols), lane);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      float* dst = dPw + k0 + 8 * j + 2 * t;
      *reinterpret_cast<float2*>(dst + g * sld) = make_float2(s[j][0], s[j][1]);
      *reinterpret_cast<float2*>(dst + (g + 8) * sld) = make_float2(s[j][2], s[j][3]);
    }
  }
  // the row's max over its slices and the groups, times the scale (> 0)
  mx[0] = quad_max(mx[0]);
  mx[1] = quad_max(mx[1]);
  if (t == 0) {
    xm[warp * 16 + g] = mx[0];
    xm[warp * 16 + g + 8] = mx[1];
  }
  __syncthreads();
  group_max<G>(xm + rt * G * 16, g, mx);
  const float m[2] = {mx[0] * scale, mx[1] * scale};
  const float m2[2] = {m[0] * kLog2e, m[1] * kLog2e};
  // e = exp(s scale - max) over the warp's own slices, in place, and its
  // parts of each row's l and u
  float l[2] = {0.f, 0.f}, u[2] = {0.f, 0.f};
  for (int i = 0; i < nt; ++i) {
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int off = (g + 8 * r) * sld + i * kWideKeys + grp * KS + 8 * j + 2 * t;
        float2* p = reinterpret_cast<float2*>(Sw + off);
        const float2 d = *reinterpret_cast<const float2*>(dPw + off);
        float2 e = *p;
        e.x = exp2_approx(e.x * scale2 - m2[r]);
        e.y = exp2_approx(e.y * scale2 - m2[r]);
        l[r] += e.x + e.y;
        u[r] += e.x * d.x + e.y * d.y;
        *p = e;
      }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = quad_sum(l[r]);
    u[r] = quad_sum(u[r]);
  }
  if (t == 0) {
    xl[warp * 16 + g] = l[0];
    xl[warp * 16 + g + 8] = l[1];
    xu[warp * 16 + g] = u[0];
    xu[warp * 16 + g + 8] = u[1];
  }
  __syncthreads();  // every e written; the parts of l and u
  group_sum<G>(xl + rt * G * 16, g, l);
  group_sum<G>(xu + rt * G * 16, g, u);
  const float inv_l[2] = {1.f / l[0], 1.f / l[1]}, dsum[2] = {u[0] / l[0], u[1] / l[1]};
  const int rw = r0 + rt * 16;
  if (grp == 0 && t == 0) {
    float* st = stats + (size_t)blockIdx.x * N * 3;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = rw + g + 8 * r;
      if (row < N) {
        st[3 * row] = m[r];
        st[3 * row + 1] = l[r];
        st[3 * row + 2] = dsum[r];
      }
    }
  }
  float acc[NC][NO][4];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int j = 0; j < NO; ++j) acc[c][j][0] = acc[c][j][1] = acc[c][j][2] = acc[c][j][3] = 0.f;
  for (int i = 0; i < nt; ++i) {
    // dS = bf16(P (dP - dsum) scale) of the warp's 16 rows over the tile's 64 keys
    uint32_t da[4][4];
    const int off = i * kWideKeys + 2 * t;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int x = 0; x < 4; ++x) {  // a[x]: row g + 8 (x % 2), keys 16 kk + 8 (x / 2) + 2t
        const int r = x % 2, at = (g + 8 * r) * sld + off + 16 * kk + 8 * (x / 2);
        const float2 e = *reinterpret_cast<const float2*>(Sw + at);
        const float2 d = *reinterpret_cast<const float2*>(dPw + at);
        da[kk][x] = pack_bf16(e.x * inv_l[r] * (d.x - dsum[r]) * scale,
                              e.y * inv_l[r] * (d.y - dsum[r]) * scale);
      }
#pragma unroll
    for (int c = 0; c < NC; ++c) {  // dq += dS K
      const int w = min(CW, DP - c * kWideCols - grp * CW);  // the group's columns here
      const bf16* st = next();
      if (w > 0) pv_chunk<NO>(acc[c], da, st + grp * CW, w, lane);
    }
  }
  store_wide<NC, NO>(out.row(out.q, b, N, 0, h, Dh), out.ld, acc, 1.f, 1.f, rw, N, grp * CW, Dh,
                     lane);
}

size_t core_bwd_smem(int N, int Dh) {
  Dh = padded(Dh);
  const int SLD = (N > Dh ? N : Dh) + kPadF;
  return (size_t)4 * N * (Dh + kPadH) * sizeof(bf16) + (size_t)2 * N * SLD * sizeof(float) +
         (size_t)N * (N + kPadH) * sizeof(bf16);
}

// X3, the ablations of this kernel (tools/kbench_ablate.py
// `_bwd_kernel_ablate`): compile-time flags, each removing one phase and
// keeping the rest as it is; the all-off instance (SKIP = 0) is the kernel
// K2b, K4 and K7b launch, the same code. A time-attribution tool: an
// instance with a flag set computes something else on purpose.
constexpr int kSkipSoftmax = 1;    // P = S scale, rounded: no max, exp or sum
constexpr int kSkipDs = 2;         // dS = bf16(dP scale): no rowsum(P dP)
constexpr int kSkipCoreMM = 4;     // S, P and att only; dq = dk = dv = datt
constexpr int kSkipRecompute = 8;  // no att = P V product: att = q

// kSkipSoftmax's pass: P = S scale in place (fp32, kept) and bf16(P) to Pb.
__device__ void scale_rows(float* S, int sld, bf16* Pb, int pld, int rows, int N, float scale) {
  for (int i = threadIdx.x; i < rows * N; i += kThreads) {
    const int r = i / N, c = i % N;
    const float p = S[r * sld + c] * scale;
    S[r * sld + c] = p;
    Pb[r * pld + c] = __float2bfloat16(p);
  }
}

// kSkipDs's pass: dS = bf16(dP scale) into Pb.
__device__ void scale_round_rows(const float* dP, int sld, bf16* Pb, int pld, int rows, int N,
                                 float scale) {
  for (int i = threadIdx.x; i < rows * N; i += kThreads) {
    const int r = i / N, c = i % N;
    Pb[r * pld + c] = __float2bfloat16(dP[r * sld + c] * scale);
  }
}

// A (rows x Dh) bf16 head from rows of stride sld to rows of stride dld, 16
// bytes at a time (Dh % 8 == 0, rows 16-byte aligned).
__device__ __forceinline__ void copy_head(bf16* __restrict__ dst, int dld,
                                          const bf16* __restrict__ src, int sld, int rows,
                                          int Dh) {
  const int vec = Dh / 8;
  for (int i = threadIdx.x; i < rows * vec; i += kThreads) {
    const int r = i / vec, c = (i % vec) * 8;
    *reinterpret_cast<uint4*>(dst + (size_t)r * dld + c) =
        *reinterpret_cast<const uint4*>(src + (size_t)r * sld + c);
  }
}

// The one-block backward: block b H + h holds all N rows of one (image,
// head) and writes dq, dk, dv, and att where att is not null. SKIP: X3's
// flags above (0 for every caller but X3).
template <int SKIP>
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
  if constexpr (!(SKIP & kSkipCoreMM))
    load_head(dOs, QLD, datt + (size_t)b * N * D + h * Dh, D, N, Dh);
  __syncthreads();
  mma_tiles<false, true, false>(Qs, QLD, Ks, QLD, P, SLD, N, N, DP);  // S = Q K^T
  __syncthreads();
  if constexpr (SKIP & kSkipSoftmax)
    scale_rows(P, SLD, Pb, PLD, N, N, scale);
  else
    softmax_rows(P, SLD, Pb, PLD, N, N, scale, true, nullptr);
  __syncthreads();
  if constexpr (!(SKIP & kSkipCoreMM)) {
    mma_tiles<true, false, false>(Pb, PLD, dOs, QLD, F, SLD, N, DP, N);  // dv = Pb^T dO
    __syncthreads();
    store_head(out.row(out.v, b, N, 0, h, Dh), out.ld, F, SLD, N, Dh);
    __syncthreads();
  }
  if (att != nullptr) {
    if constexpr (SKIP & kSkipRecompute) {
      copy_head(att + (size_t)b * N * D + h * Dh, D, Qs, QLD, N, Dh);  // att = q
    } else {
      mma_tiles<false, false, false>(Pb, PLD, Vs, QLD, F, SLD, N, DP, N);  // att = Pb V
      __syncthreads();
      store_head(att + (size_t)b * N * D + h * Dh, D, F, SLD, N, Dh);
      __syncthreads();
    }
  }
  if constexpr (SKIP & kSkipCoreMM) {  // dq = dk = dv = the head's datt
    const bf16* d = datt + (size_t)b * N * D + h * Dh;
    copy_head(out.row(out.q, b, N, 0, h, Dh), out.ld, d, D, N, Dh);
    copy_head(out.row(out.k, b, N, 0, h, Dh), out.ld, d, D, N, Dh);
    copy_head(out.row(out.v, b, N, 0, h, Dh), out.ld, d, D, N, Dh);
    return;
  }
  mma_tiles<false, true, false>(dOs, QLD, Vs, QLD, F, SLD, N, N, DP);  // dP = dO V^T
  __syncthreads();
  if constexpr (SKIP & kSkipDs)
    scale_round_rows(F, SLD, Pb, PLD, N, N, scale);
  else
    ds_rows(P, F, SLD, Pb, PLD, N, N, scale, nullptr);
  __syncthreads();
  mma_tiles<false, false, false>(Pb, PLD, Ks, QLD, P, SLD, N, DP, N);  // dq = dS K
  mma_tiles<true, false, false>(Pb, PLD, Qs, QLD, F, SLD, N, DP, N);   // dk = dS^T Q
  __syncthreads();
  store_head(out.row(out.q, b, N, 0, h, Dh), out.ld, P, SLD, N, Dh);
  store_head(out.row(out.k, b, N, 0, h, Dh), out.ld, F, SLD, N, Dh);
}

// Pass 1's shared memory at QT query rows and column chunks of C.
size_t bwd_rows_smem(int N, int C, int QT) {
  const int CLD = C + kPadH, SLD = (N > C ? N : C) + kPadF;
  return (size_t)(2 * QT + N) * CLD * sizeof(bf16) + (size_t)2 * QT * SLD * sizeof(float) +
         (size_t)QT * (N + kPadH) * sizeof(bf16);
}

// Backward pass 1: block (b H + h, t) takes query rows [r0, r0 + QT): P
// (fp32, kept), att (where att is not null), dP, dS, dq; each row's (max,
// sum, rowsum(P dP)) to stats. Column chunks of C of Q and K (S), of V (att,
// then dP with dO's) and of K (dq) pass through one N-row buffer; the
// resident instance (!STREAM: C = padded(Dh)) reads each once.
template <bool STREAM>
__global__ void __launch_bounds__(kThreads)
attention_core_bwd_rows_kernel(Heads in, const bf16* __restrict__ datt, bf16* __restrict__ att,
                               DHeads out, float* __restrict__ stats, int N, int H, int Dh,
                               float scale, int QT, int C) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int D = H * Dh, DP = padded(Dh);
  if (!STREAM) C = DP;
  const int n = STREAM ? (DP + C - 1) / C : 1;  // column chunks
  const int CLD = C + kPadH, SLD = max(N, C) + kPadF, PLD = N + kPadH;
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + QT * CLD;
  bf16* KV = dOs + QT * CLD;
  float* P = reinterpret_cast<float*>(KV + N * CLD);  // fp32 P, later a dq chunk
  float* F = P + QT * SLD;                            // an att chunk, then dP
  bf16* Pb = reinterpret_cast<bf16*>(F + QT * SLD);   // bf16 P, then bf16 dS

  const int b = blockIdx.x / H, h = blockIdx.x % H, r0 = blockIdx.y * QT;
  float* st = stats + ((size_t)blockIdx.x * N + r0) * 3;
  const bf16* q = in.row(in.q, b, N, r0, h, Dh);
  const bf16* k = in.row(in.k, b, N, 0, h, Dh);
  const bf16* v = in.row(in.v, b, N, 0, h, Dh);
  const bf16* dO = datt + ((size_t)b * N + r0) * D + h * Dh;
  load_cols(dOs, CLD, dO, D, QT, 0, min(C, DP), Dh);
  for (int i = 0; i < n; ++i) {
    const int c0 = i * C, w = min(C, DP - c0);
    load_cols(Qs, CLD, q, in.ld, QT, c0, w, Dh);
    load_cols(KV, CLD, k, in.ld, N, c0, w, Dh);
    __syncthreads();
    mma_tiles_from<false, true>(i > 0, Qs, CLD, KV, CLD, P, SLD, QT, N, w);  // S += Q K^T
    __syncthreads();
  }
  load_cols(KV, CLD, v, in.ld, N, 0, min(C, DP), Dh);  // V over K
  softmax_rows(P, SLD, Pb, PLD, QT, N, scale, true, st);
  __syncthreads();
  if (att != nullptr) {
    bf16* a = att + ((size_t)b * N + r0) * D + h * Dh;
    for (int i = 0; i < n; ++i) {
      const int c0 = i * C, w = min(C, DP - c0);
      if (i > 0) {
        load_cols(KV, CLD, v, in.ld, N, c0, w, Dh);
        __syncthreads();
      }
      mma_tiles<false, false, false>(Pb, PLD, KV, CLD, F, SLD, QT, w, N);  // att = Pb V
      __syncthreads();
      store_head(a + c0, D, F, SLD, QT, min(w, Dh - c0));
      __syncthreads();
    }
  }
  for (int i = 0; i < n; ++i) {  // V's last chunk is in KV: its first again where n > 1
    const int c0 = i * C, w = min(C, DP - c0);
    if (i > 0) load_cols(dOs, CLD, dO, D, QT, c0, w, Dh);
    if (i > 0 || (att != nullptr && n > 1)) {
      load_cols(KV, CLD, v, in.ld, N, c0, w, Dh);
      __syncthreads();
    }
    mma_tiles_from<false, true>(i > 0, dOs, CLD, KV, CLD, F, SLD, QT, N, w);  // dP += dO V^T
    __syncthreads();
  }
  load_cols(KV, CLD, k, in.ld, N, 0, min(C, DP), Dh);  // K over V
  ds_rows(P, F, SLD, Pb, PLD, QT, N, scale, st);
  __syncthreads();
  bf16* dq = out.row(out.q, b, N, r0, h, Dh);
  for (int i = 0; i < n; ++i) {
    const int c0 = i * C, w = min(C, DP - c0);
    if (i > 0) {
      load_cols(KV, CLD, k, in.ld, N, c0, w, Dh);
      __syncthreads();
    }
    mma_tiles<false, false, false>(Pb, PLD, KV, CLD, P, SLD, QT, w, N);  // dq = dS K
    __syncthreads();
    store_head(dq + c0, out.ld, P, SLD, QT, min(w, Dh - c0));
  }
}

// Pass 2's shared memory at KT key rows, QT query rows, depth chunks of C
// and output column chunks of C2 (C = C2 = padded(Dh): the resident tiles,
// whose Q and dO serve both).
size_t bwd_cols_smem(int DP, int KT, int QT, int C, int C2) {
  const int CLD = C + kPadH, OLD = C2 + kPadH, TLD = KT + kPadF, ALD = C2 + kPadF;
  const bool whole = C == DP && C2 == DP;
  return (size_t)(2 * KT + 2 * QT) * CLD * sizeof(bf16) +
         (whole ? 0 : (size_t)2 * QT * OLD * sizeof(bf16)) +
         (size_t)(2 * QT * TLD + 2 * KT * ALD + 3 * QT) * sizeof(float) +
         (size_t)QT * (KT + kPadH) * sizeof(bf16);
}

// Backward pass 2: block (b H + h, t, z) takes key rows [c0, c0 + KT) and
// output columns [e0, e0 + C2) and walks the query tiles in order: S = Q
// K^T and dP = dO V^T on the tile over the whole head (depth chunks of C),
// P from pass 1's (max, sum), dv += bf16(P)^T dO, dS from pass 1's
// rowsum(P dP), dk += dS^T Q, with dk and dv in fp32 in shared memory,
// rounded once. The resident instance (!STREAM: C = C2 = padded(Dh)) reads
// the key tile's K and V once and each query tile's Q and dO once, for both.
template <bool STREAM>
__global__ void __launch_bounds__(kThreads)
attention_core_bwd_cols_kernel(Heads in, const bf16* __restrict__ datt,
                               const float* __restrict__ stats, DHeads out, int N, int H, int Dh,
                               float scale, int KT, int QT, int C, int C2) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int D = H * Dh, DP = padded(Dh);
  if (!STREAM) C = C2 = DP;
  const int nd = STREAM ? (DP + C - 1) / C : 1;  // depth chunks
  const int CLD = C + kPadH, OLD = C2 + kPadH, TLD = KT + kPadF, ALD = C2 + kPadF;
  const int TPLD = KT + kPadH;
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + KT * CLD;
  bf16* Qs = Vs + KT * CLD;
  bf16* dOs = Qs + QT * CLD;
  bf16* Qo = STREAM ? dOs + QT * CLD : Qs;  // Q and dO at the output columns
  bf16* dOo = STREAM ? Qo + QT * OLD : dOs;
  float* S = reinterpret_cast<float*>(STREAM ? dOo + QT * OLD : dOs + QT * CLD);  // S, then P
  float* F = S + QT * TLD;                              // dP
  float* dV = F + QT * TLD;
  float* dK = dV + KT * ALD;
  float* st = dK + KT * ALD;                            // QT x (max, sum, rowsum(P dP))
  bf16* Pb = reinterpret_cast<bf16*>(st + 3 * QT);      // bf16 P, then bf16 dS

  const int b = blockIdx.x / H, h = blockIdx.x % H, c0 = blockIdx.y * KT;
  const int e0 = blockIdx.z * C2, w2 = min(C2, DP - e0);
  const float* sb = stats + (size_t)blockIdx.x * N * 3;
  const bf16* k = in.row(in.k, b, N, c0, h, Dh);
  const bf16* v = in.row(in.v, b, N, c0, h, Dh);
  if (!STREAM) {  // the key tile's K and V read once
    load_cols(Ks, CLD, k, in.ld, KT, 0, DP, Dh);
    load_cols(Vs, CLD, v, in.ld, KT, 0, DP, Dh);
  }
  for (int i = threadIdx.x; i < 2 * KT * ALD; i += kThreads) dV[i] = 0.f;  // dV, dK
  for (int q0 = 0; q0 < N; q0 += QT) {
    __syncthreads();
    const bf16* q = in.row(in.q, b, N, q0, h, Dh);
    const bf16* dO = datt + ((size_t)b * N + q0) * D + h * Dh;
    for (int i = threadIdx.x; i < 3 * QT; i += kThreads) st[i] = sb[(size_t)q0 * 3 + i];
    for (int i = 0; i < nd; ++i) {
      const int d0 = i * C, w = min(C, DP - d0);
      if (i > 0) __syncthreads();
      if (STREAM) {
        load_cols(Ks, CLD, k, in.ld, KT, d0, w, Dh);
        load_cols(Vs, CLD, v, in.ld, KT, d0, w, Dh);
      }
      load_cols(Qs, CLD, q, in.ld, QT, d0, w, Dh);
      load_cols(dOs, CLD, dO, D, QT, d0, w, Dh);
      __syncthreads();
      mma_tiles_from<false, true>(i > 0, Qs, CLD, Ks, CLD, S, TLD, QT, KT, w);   // S += Q K^T
      mma_tiles_from<false, true>(i > 0, dOs, CLD, Vs, CLD, F, TLD, QT, KT, w);  // dP += dO V^T
    }
    if (STREAM) {
      load_cols(Qo, OLD, q, in.ld, QT, e0, w2, Dh);
      load_cols(dOo, OLD, dO, D, QT, e0, w2, Dh);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < QT * KT; i += kThreads) {
      const int r = i / KT, c = i % KT;
      const float p = expf(S[r * TLD + c] * scale - st[3 * r]) / st[3 * r + 1];
      S[r * TLD + c] = p;
      Pb[r * TPLD + c] = __float2bfloat16(p);
    }
    __syncthreads();
    mma_tiles<true, false, true>(Pb, TPLD, dOo, OLD, dV, ALD, KT, w2, QT);  // dv += P^T dO
    __syncthreads();
    for (int i = threadIdx.x; i < QT * KT; i += kThreads) {
      const int r = i / KT, c = i % KT;
      Pb[r * TPLD + c] =
          __float2bfloat16(S[r * TLD + c] * (F[r * TLD + c] - st[3 * r + 2]) * scale);
    }
    __syncthreads();
    mma_tiles<true, false, true>(Pb, TPLD, Qo, OLD, dK, ALD, KT, w2, QT);  // dk += dS^T Q
  }
  __syncthreads();
  const int wv = min(w2, Dh - e0);
  store_head(out.row(out.k, b, N, c0, h, Dh) + e0, out.ld, dK, ALD, KT, wv);
  store_head(out.row(out.v, b, N, c0, h, Dh) + e0, out.ld, dV, ALD, KT, wv);
}

// The ring tiles of the backward's registers design at padded width DP: 64
// rows, fewer where a side's accumulators (dq and att, or dk and dv) leave
// too few of a thread's 255 registers for two fp32 score tiles of 64 rows
// (ptxas's -v report on the H100 showed spills there). Its kernels declare
// one block an SM, so that ptxas may take all 255 (left to itself it held
// the padded-80 dk/dv kernel to 168 and spilled).
__host__ __device__ constexpr int core_dq_tile(int DP, bool att) {
  return !att || DP <= 96 ? kBwdTile : DP <= 112 ? 32 : 16;
}

__host__ __device__ constexpr int core_dkv_tile(int DP) {
  return DP <= 64 ? kBwdTile : DP <= 96 ? 32 : 16;
}

// The backward's registers design (attention_bwd_regs.cuh), at padded
// widths up to kRegMaxWidth. The dq side: each row's (m, l, dsum) to stats;
// att = bf16(bf16(P) V) where ATT (K2b, K4), none for K7b.
template <int DP, int WARPS, bool ATT>
__global__ void __launch_bounds__(32 * WARPS, 1)
attention_core_bwd_dq_regs_kernel(Heads in, const bf16* __restrict__ datt, bf16* __restrict__ att,
                                  DHeads out, float* __restrict__ stats, int N, int H, int Dh,
                                  float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int b = blockIdx.x / H, h = blockIdx.x % H, D = H * Dh;
  const size_t head = (size_t)b * N * D + h * Dh;
  bwd_dq_body<DP, WARPS, core_dq_tile(DP, ATT), true, ATT>(
      smem, in.row(in.q, b, N, 0, h, Dh), in.row(in.k, b, N, 0, h, Dh),
      in.row(in.v, b, N, 0, h, Dh), in.ld, datt + head, D, out.row(out.q, b, N, 0, h, Dh), out.ld,
      ATT ? att + head : nullptr, D, stats + (size_t)blockIdx.x * N * 3, N, Dh, scale,
      blockIdx.y * 16 * WARPS, [](int, int, const bf16*, int, RowTerms&) {});
}

// The dk/dv side, P and dS from the dq side's (m, l, dsum).
struct CoreTerms {
  const float* stats;  // the head's row 0
  int N;
  __device__ __forceinline__ void operator()(int c, float& a, float& b, float& dsum) const {
    if (c < N) {
      a = stats[3 * c] * kLog2e;
      b = 1.f / stats[3 * c + 1];
      dsum = stats[3 * c + 2];
    } else {
      a = b = dsum = 0.f;
    }
  }
};

template <int DP, int WARPS>
__global__ void __launch_bounds__(32 * WARPS, 1)
attention_core_bwd_dkv_regs_kernel(Heads in, const bf16* __restrict__ datt,
                                   const float* __restrict__ stats, DHeads out, int N, int H,
                                   int Dh, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int b = blockIdx.x / H, h = blockIdx.x % H, D = H * Dh;
  bwd_dkv_body<DP, WARPS, core_dkv_tile(DP)>(
      smem, in.row(in.q, b, N, 0, h, Dh), in.row(in.k, b, N, 0, h, Dh),
      in.row(in.v, b, N, 0, h, Dh), in.ld, datt + (size_t)b * N * D + h * Dh, D,
      out.row(out.k, b, N, 0, h, Dh), out.row(out.v, b, N, 0, h, Dh), out.ld, N, Dh, scale,
      blockIdx.y * 16 * WARPS, CoreTerms{stats + (size_t)blockIdx.x * N * 3, N});
}

// The registers design in one block per (image, head) at N <= 64 (the
// "registers-fused" design): Q, K, V and dO copied once; warp w computes
// rows [16w, 16w + 16) of S, P (exact: one key tile holds the whole row),
// att, dP, dsum = rowsum(P dP), dS and dq in registers, and puts bf16 P and
// bf16 dS in shared memory; after one barrier it takes key rows [16w,
// 16w + 16) of dv = P^T dO and dk = dS^T Q, reading P^T and dS^T as A
// fragments by ldmatrix .trans. No stats, no recomputed S or dP.
template <int DP>
constexpr size_t fused_bwd_smem() {
  return (size_t)4 * kBwdTile * (DP + kPadH) * sizeof(bf16) +
         (size_t)2 * kBwdTile * (kBwdTile + kPadH) * sizeof(bf16);
}

// rows [r, r + 16) of a 16 x 64 bf16 tile in A fragments pa into a shared
// tile of row stride ld
__device__ __forceinline__ void put_tile(bf16* dst, int ld, const uint32_t (&pa)[4][4], int lane) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t* lo = reinterpret_cast<uint32_t*>(dst + g * ld + 16 * kk + 2 * t);
    uint32_t* hi = reinterpret_cast<uint32_t*>(dst + (g + 8) * ld + 16 * kk + 2 * t);
    lo[0] = pa[kk][0];
    hi[0] = pa[kk][1];
    lo[4] = pa[kk][2];
    hi[4] = pa[kk][3];
  }
}

// The transpose of 64 rows x columns [c, c + 16) of a shared bf16 tile (row
// stride ld) as the A fragments of a 16 x 64 operand.
__device__ __forceinline__ void get_tile_t(uint32_t (&pa)[4][4], const bf16* src, int ld, int c,
                                           int lane) {
  const int row = (lane % 8) + (lane / 16) * 8, col = c + ((lane / 8) % 2) * 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) ldmatrix_x4<true>(pa[kk], src + (16 * kk + row) * ld + col);
}

template <int DP, bool ATT>
__global__ void __launch_bounds__(kThreads, 1)
attention_core_bwd_fused_kernel(Heads in, const bf16* __restrict__ datt, bf16* __restrict__ att,
                                DHeads out, int N, int H, int Dh, float scale) {
  constexpr int kLd = DP + kPadH, kT = kBwdTile * kLd, kPld = kBwdTile + kPadH;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + kT;
  bf16* Vs = Ks + kT;
  bf16* dOs = Vs + kT;
  bf16* Ps = dOs + kT;
  bf16* dSs = Ps + kBwdTile * kPld;
  const int b = blockIdx.x / H, h = blockIdx.x % H, D = H * Dh;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, t = lane % 4;
  const int r = warp * 16;  // the warp's query rows, then its key rows
  const size_t head = (size_t)b * N * D + h * Dh;
  load_tile_async<kBwdTile, DP, kThreads>(Qs, in.row(in.q, b, N, 0, h, Dh), in.ld, 0, N, Dh);
  load_tile_async<kBwdTile, DP, kThreads>(Ks, in.row(in.k, b, N, 0, h, Dh), in.ld, 0, N, Dh);
  load_tile_async<kBwdTile, DP, kThreads>(Vs, in.row(in.v, b, N, 0, h, Dh), in.ld, 0, N, Dh);
  load_tile_async<kBwdTile, DP, kThreads>(dOs, datt + head, D, 0, N, Dh);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  {
    ARows<DP, kLd, false> qa, da;
    qa.init(Qs + r * kLd, lane);
    da.init(dOs + r * kLd, lane);
    float s[8][4], dp[8][4], mx[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    abt<DP, kLd, kBwdTile>(s, qa, Ks, lane);
    mask_keys(s, 0, N, t);
    row_max(s, mx);
    const float m2[2] = {quad_max(mx[0]) * scale * kLog2e, quad_max(mx[1]) * scale * kLog2e};
    const float scale2 = scale * kLog2e;
#pragma unroll
    for (int c = 0; c < 8; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[c][e] = exp2_approx(s[c][e] * scale2 - m2[e / 2]);
        l[e / 2] += s[c][e];
      }
    const float inv_l[2] = {1.f / quad_sum(l[0]), 1.f / quad_sum(l[1])};
#pragma unroll
    for (int c = 0; c < 8; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[c][e] *= inv_l[e / 2];
    uint32_t pa[4][4];
    pack_tile(pa, s);
    put_tile(Ps + r * kPld, kPld, pa, lane);
    if constexpr (ATT) {
      float o[DP / 8][4];
      zero_acc<DP>(o);
      ab<DP, kLd, kBwdTile>(o, pa, Vs, lane);
      store_acc<DP>(att + head, D, o, r, N, Dh, lane);
    }
    abt<DP, kLd, kBwdTile>(dp, da, Vs, lane);
    float su[2] = {0.f, 0.f};
#pragma unroll
    for (int c = 0; c < 8; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) su[e / 2] += s[c][e] * dp[c][e];
    const float dsum[2] = {quad_sum(su[0]), quad_sum(su[1])};
#pragma unroll
    for (int c = 0; c < 8; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[c][e] = s[c][e] * (dp[c][e] - dsum[e / 2]) * scale;
    pack_tile(pa, s);
    put_tile(dSs + r * kPld, kPld, pa, lane);
    float dq[DP / 8][4];
    zero_acc<DP>(dq);
    ab<DP, kLd, kBwdTile>(dq, pa, Ks, lane);
    store_acc<DP>(out.row(out.q, b, N, 0, h, Dh), out.ld, dq, r, N, Dh, lane);
  }
  __syncthreads();
  uint32_t pa[4][4];
  float acc[DP / 8][4];
  get_tile_t(pa, Ps, kPld, r, lane);
  zero_acc<DP>(acc);
  ab<DP, kLd, kBwdTile>(acc, pa, dOs, lane);  // dv = bf16(P)^T dO
  store_acc<DP>(out.row(out.v, b, N, 0, h, Dh), out.ld, acc, r, N, Dh, lane);
  get_tile_t(pa, dSs, kPld, r, lane);
  zero_acc<DP>(acc);
  ab<DP, kLd, kBwdTile>(acc, pa, Qs, lane);  // dk = dS^T Q
  store_acc<DP>(out.row(out.k, b, N, 0, h, Dh), out.ld, acc, r, N, Dh, lane);
}

// The widest of 32 and 16 rows dividing N whose tile fits `limit`; 0 if none.
template <typename Smem>
int pick_rows(int N, size_t limit, Smem smem) {
  for (int t = 32; t >= 16; t /= 2)
    if (N % t == 0 && smem(t) <= limit) return t;
  return 0;
}

// Which (N, Dh) the cores take: every shape the JAX gates send them.
bool takes(int N, int Dh) {
  return N % 16 == 0 && N >= 16 && N <= 512 && Dh % 8 == 0 && Dh > 0;
}

// The forward core's and pass 1's tiles: QT rows and column chunks of C;
// QT = 0 where the design does not fit.
struct RowTiles {
  int QT, C;
};

RowTiles core_tiles(int N, int Dh, bool streamed) {
  const int DP = padded(Dh), C = streamed ? std::min(kChunk, DP) : DP;
  return {pick_rows(N, kMaxSmem, [&](int t) { return core_smem(N, C, t); }), C};
}

// Pass 1 takes two blocks per SM where its tile allows.
RowTiles rows_tiles(int N, int Dh, bool streamed) {
  const int DP = padded(Dh), C = streamed ? std::min(kChunk, DP) : DP;
  auto smem = [&](int t) { return bwd_rows_smem(N, C, t); };
  int QT = pick_rows(N, kMaxSmem / 2, smem);
  if (QT == 0) QT = pick_rows(N, kMaxSmem, smem);
  return {QT, C};
}

// Pass 2's tiles; KT = 0 where the design does not fit. Resident: the whole
// head, the largest query tile (32, 16) and then key tile (64, 32, 16)
// that fit. Streamed: depth chunks of kChunk and the fewest output column
// chunks C2, then the largest tiles.
struct ColTiles {
  int KT, QT, C, C2;
};

ColTiles cols_tiles(int N, int Dh, bool streamed) {
  const int DP = padded(Dh), C = streamed ? std::min(kChunk, DP) : DP;
  ColTiles best{0, 0, C, DP};
  int fewest = streamed ? DP / kFrag + 1 : 2;
  for (int QT = 32; QT >= 16; QT /= 2) {
    for (int KT = 64; KT >= 16; KT /= 2) {
      if (N % KT || N % QT) continue;
      for (int n = 1; n < fewest; ++n) {
        const int C2 = (DP / kFrag + n - 1) / n * kFrag;
        if (bwd_cols_smem(DP, KT, QT, C, C2) <= kMaxSmem) {
          best = {KT, QT, C, C2};
          fewest = n;
          break;
        }
      }
    }
  }
  return best;
}

// The backward's designs (ddm_attention_core_plan's codes): one block per
// (image, head), two passes on whole heads, two streamed passes, and the
// registers design as its dq and dk/dv sides or in one block per (image,
// head) at N <= 64.
constexpr int kBwdOneBlock = 0, kBwdTwoPass = 1, kBwdStreamed = 2, kBwdRegisters = 3,
              kBwdRegistersFused = 4;

// The backward's plan: -1 picks the registers design where the padded head
// takes it (fused at N <= 64), else the one-block design where it fits,
// else each pass resident where its tiles fit and streamed elsewhere. The
// launcher and ddm_attention_core_plan both read it; a registers plan's
// rows are the dq side's (query rows a block, the padded head) and its cols
// the dk/dv side's (key rows a block, query rows a stage, the padded head
// twice).
struct BwdPlan {
  int design;
  RowTiles rows;
  ColTiles cols;
};

bool one_block_fits(int N, int Dh) {
  return N <= kOneBlockMaxTokens && core_bwd_smem(N, Dh) <= kMaxSmem;
}

// The wide registers design's instances, by 128-column chunks of the padded
// head (2-7: padded widths 144-896).
#define DDM_WIDE_CHUNKS(X) X(2) X(3) X(4) X(5) X(6) X(7)

// The dk/dv side's key rows a block at padded width DP (WideDkv).
int wide_dkv_keys(int DP) {
  switch ((DP + kWideCols - 1) / kWideCols) {
#define DDM_DKV_KEYS(NC) \
    case NC: return WideDkv<NC>::kKeys;
    DDM_WIDE_CHUNKS(DDM_DKV_KEYS)
#undef DDM_DKV_KEYS
    default: return 0;
  }
}

BwdPlan bwd_plan(int N, int Dh, int design) {
  BwdPlan p{design, {0, 0}, {0, 0, 0, 0}};
  const int DP = padded(Dh);
  if (design == kBwdRegisters || design == kBwdRegistersFused ||
      (design < 0 && DP <= kWideMaxWidth)) {
    const bool fused =
        design == kBwdRegistersFused || (design < 0 && N <= kBwdTile && DP <= kRegMaxWidth);
    if (DP > (fused ? kRegMaxWidth : kWideMaxWidth) || (fused && N > kBwdTile)) {
      p.design = -1;
      return p;
    }
    if (DP > kRegMaxWidth)  // the wide design: the dq side's rows, the dk/dv side's keys
      return {kBwdRegisters, {16 * wide_bwd_dq_rt(N, DP), DP},
              {wide_dkv_keys(DP), kWideKeys, DP, DP}};
    return {fused ? kBwdRegistersFused : kBwdRegisters, {kBwdTile, DP},
            {kBwdTile, fused ? kBwdTile : core_dkv_tile(DP), DP, DP}};
  }
  if (design == kBwdOneBlock || (design < 0 && one_block_fits(N, Dh))) {
    p.design = one_block_fits(N, Dh) ? kBwdOneBlock : -1;
    return p;
  }
  p.rows = rows_tiles(N, Dh, design == kBwdStreamed);
  p.cols = cols_tiles(N, Dh, design == kBwdStreamed);
  if (design < 0) {
    if (p.rows.QT == 0) p.rows = rows_tiles(N, Dh, true);
    if (p.cols.KT == 0) p.cols = cols_tiles(N, Dh, true);
    p.design = p.rows.C == DP && p.cols.C2 == DP && p.cols.C == DP ? kBwdTwoPass : kBwdStreamed;
  }
  if (p.rows.QT == 0 || p.cols.KT == 0) p.design = -1;
  return p;
}

// The registers design's warps a block for N tokens (16 query rows each): 4
// where a warp holds its rows' scores (N <= 128); past that the two sweeps,
// on 8 warps where 128-row query tiles divide N (faster than 4 at N 256, Dh
// 64 and 72, on the H100), else 4. Two row tiles a warp (each B fragment
// serving both) measured no faster at N 256.
int regs_warps(int N) { return N > 2 * kRegKeys && N % 128 == 0 ? 8 : 4; }

// The forward's designs (ddm_attention_core_plan's codes).
constexpr int kFwdResident = 0, kFwdStreamed = 1, kFwdRegisters = 2;

struct FwdPlan {
  int design;
  RowTiles tiles;  // QT = 0 where the design does not take the shape
};

// -1 picks the registers design where the padded head takes it (up to
// kWideMaxWidth: the wide kernel past kRegMaxWidth), else resident where
// its tile fits, else streamed.
FwdPlan fwd_plan(int N, int Dh, int design) {
  const int DP = padded(Dh);
  if (design == kFwdRegisters || (design < 0 && DP <= kWideMaxWidth)) {
    const int rows = DP <= kRegMaxWidth   ? 16 * regs_warps(N)
                     : DP <= kWideMaxWidth ? 4 * wide_core_warps(N, DP)
                                           : 0;
    return {kFwdRegisters, {rows, DP}};
  }
  RowTiles t = core_tiles(N, Dh, design == kFwdStreamed);
  if (design < 0 && t.QT == 0) t = core_tiles(N, Dh, true);
  return {design >= 0 ? design : t.C < DP ? kFwdStreamed : kFwdResident, t};
}

// The registers design's instances: one per padded width, count of held
// score tiles (0: the two sweeps) and warps a block.
using RegsKernel = decltype(&attention_core_regs_kernel<16, 0, 4>);

template <int HOLD, int WARPS>
RegsKernel regs_kernel(int DP) {
  switch (DP) {
    case 16: return attention_core_regs_kernel<16, HOLD, WARPS>;
    case 32: return attention_core_regs_kernel<32, HOLD, WARPS>;
    case 48: return attention_core_regs_kernel<48, HOLD, WARPS>;
    case 64: return attention_core_regs_kernel<64, HOLD, WARPS>;
    case 80: return attention_core_regs_kernel<80, HOLD, WARPS>;
    case 96: return attention_core_regs_kernel<96, HOLD, WARPS>;
    case 112: return attention_core_regs_kernel<112, HOLD, WARPS>;
    case 128: return attention_core_regs_kernel<128, HOLD, WARPS>;
    default: return nullptr;
  }
}

// The instance for N tokens.
RegsKernel regs_kernel_for(int N, int DP) {
  if (N <= 2 * kRegKeys) return regs_kernel<2, 4>(DP);
  return regs_warps(N) == 8 ? regs_kernel<0, 8>(DP) : regs_kernel<0, 4>(DP);
}

// The wide registers core's instances: one per count of 128-column chunks
// (2-7: padded widths 144-896) and of warps (8; 16 up to 4 chunks).
using WideKernel = decltype(&attention_core_wide_kernel<2, 8>);

WideKernel wide_kernel(int DP, int warps) {
  switch ((DP + kWideCols - 1) / kWideCols * 100 + warps) {
    case 208: return attention_core_wide_kernel<2, 8>;
    case 308: return attention_core_wide_kernel<3, 8>;
    case 408: return attention_core_wide_kernel<4, 8>;
    case 508: return attention_core_wide_kernel<5, 8>;
    case 608: return attention_core_wide_kernel<6, 8>;
    case 708: return attention_core_wide_kernel<7, 8>;
    case 216: return attention_core_wide_kernel<2, 16>;
    case 316: return attention_core_wide_kernel<3, 16>;
    case 416: return attention_core_wide_kernel<4, 16>;
    default: return nullptr;
  }
}

// The forward core over q, k, v into the (B, N, H*Dh) out.
cudaError_t launch_core(Heads in, bf16* out, int B, int N, int H, int Dh, float scale,
                        int design, cudaStream_t stream) {
  const FwdPlan p = fwd_plan(N, Dh, design);
  const RowTiles t = p.tiles;
  if (!takes(N, Dh) || t.QT == 0) return cudaErrorInvalidValue;
  if (p.design == kFwdRegisters && padded(Dh) > kRegMaxWidth) {
    const int DP = padded(Dh), warps = wide_core_warps(N, DP);
    const size_t smem = wide_core_smem(N, DP, warps);
    const WideKernel kernel = wide_kernel(DP, warps);
    const cudaError_t err = set_smem((const void*)kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<dim3(B * H, (N + t.QT - 1) / t.QT), 32 * warps, smem, stream>>>(in, out, N, H, Dh,
                                                                            scale);
    return cudaGetLastError();
  }
  if (p.design == kFwdRegisters) {
    const int DP = padded(Dh);
    const RegsKernel kernel = regs_kernel_for(N, DP);
    const int rows = t.QT;  // 16 a warp
    const size_t smem = regs_smem(DP, rows);
    const cudaError_t err = set_smem((const void*)kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<dim3(B * H, (N + rows - 1) / rows), 2 * rows, smem, stream>>>(in, out, N, H, Dh,
                                                                           scale);
    return cudaGetLastError();
  }
  return launch(t.C < padded(Dh) ? attention_core_kernel<true> : attention_core_kernel<false>,
                dim3(B * H, N / t.QT), core_smem(N, t.C, t.QT), stream, in, out, N, H, Dh, scale,
                t.QT, t.C);
}

// The one-block backward: dq, dk, dv, and att where it is not null.
cudaError_t launch_bwd_one_block(Heads in, const bf16* datt, bf16* att, DHeads out, int B, int N,
                                 int H, int Dh, float scale, cudaStream_t stream) {
  const size_t smem = core_bwd_smem(N, Dh);
  cudaError_t err = set_smem((const void*)attention_core_bwd_kernel<0>, smem);
  if (err != cudaSuccess) return err;
  attention_core_bwd_kernel<0><<<B * H, kThreads, smem, stream>>>(in, datt, att, out, N, H,
                                                                  Dh, scale);
  return cudaGetLastError();
}

// The two-pass backward: the same outputs; stats holds B x H x N x 3 floats
// of scratch.
cudaError_t launch_bwd_two_pass(Heads in, const bf16* datt, bf16* att, DHeads out, float* stats,
                                int B, int N, int H, int Dh, float scale, const BwdPlan& p,
                                cudaStream_t s) {
  const RowTiles r = p.rows;
  const ColTiles c = p.cols;
  const int DP = padded(Dh);
  const cudaError_t err = launch(
      r.C < DP ? attention_core_bwd_rows_kernel<true> : attention_core_bwd_rows_kernel<false>,
      dim3(B * H, N / r.QT), bwd_rows_smem(N, r.C, r.QT), s, in, datt, att, out, stats, N, H, Dh,
      scale, r.QT, r.C);
  if (err != cudaSuccess) return err;
  const bool whole = c.C == DP && c.C2 == DP;
  return launch(
      whole ? attention_core_bwd_cols_kernel<false> : attention_core_bwd_cols_kernel<true>,
      dim3(B * H, N / c.KT, (DP + c.C2 - 1) / c.C2), bwd_cols_smem(DP, c.KT, c.QT, c.C, c.C2),
      s, in, datt, stats, out, N, H, Dh, scale, c.KT, c.QT, c.C, c.C2);
}

// The backward's registers design at padded width DP: the dq side, then
// the dk/dv side (stats: B x H x N x 3 floats), or the fused block.
template <int DP>
cudaError_t launch_bwd_regs_at(Heads in, const bf16* datt, bf16* att, DHeads out, float* stats,
                               int B, int N, int H, int Dh, float scale, bool fused,
                               cudaStream_t s) {
  const int tiles = (N + kBwdTile - 1) / kBwdTile;
  if (fused)
    return launch(att ? attention_core_bwd_fused_kernel<DP, true>
                      : attention_core_bwd_fused_kernel<DP, false>,
                  dim3(B * H), fused_bwd_smem<DP>(), s, in, datt, att, out, N, H, Dh, scale);
  const cudaError_t err =
      att ? launch(attention_core_bwd_dq_regs_kernel<DP, 4, true>, dim3(B * H, tiles),
                   bwd_dq_smem<DP, 4, core_dq_tile(DP, true)>(), s, in, datt, att, out, stats, N, H,
                   Dh, scale)
          : launch(attention_core_bwd_dq_regs_kernel<DP, 4, false>, dim3(B * H, tiles),
                   bwd_dq_smem<DP, 4, core_dq_tile(DP, false)>(), s, in, datt, att, out, stats, N,
                   H, Dh, scale);
  if (err != cudaSuccess) return err;
  return launch(attention_core_bwd_dkv_regs_kernel<DP, 4>, dim3(B * H, tiles),
                bwd_dkv_smem<DP, 4, core_dkv_tile(DP)>(), s, in, datt, (const float*)stats, out, N,
                H, Dh, scale);
}

#define DDM_REGS_WIDTHS(X) X(16) X(32) X(48) X(64) X(80) X(96) X(112) X(128)

cudaError_t launch_bwd_regs(Heads in, const bf16* datt, bf16* att, DHeads out, float* stats,
                            int B, int N, int H, int Dh, float scale, bool fused,
                            cudaStream_t s) {
  switch (padded(Dh)) {
#define DDM_BWD_REGS(W) \
    case W: return launch_bwd_regs_at<W>(in, datt, att, out, stats, B, N, H, Dh, scale, fused, s);
    DDM_REGS_WIDTHS(DDM_BWD_REGS)
#undef DDM_BWD_REGS
    default: return cudaErrorInvalidValue;
  }
}

// dq, dk and dv into the thirds of a (B, N, 3D) buffer.
DHeads dqkv_heads(void* dqkv, int D) {
  bf16* p = (bf16*)dqkv;
  return {p, p + D, p + 2 * D, 3 * D};
}

using WideDqKernel = decltype(&attention_core_bwd_dq_wide_kernel<2>);

WideDqKernel wide_dq_kernel(int DP) {
  switch ((DP + kWideCols - 1) / kWideCols) {
#define DDM_WIDE_DQ(NC) \
    case NC: return attention_core_bwd_dq_wide_kernel<NC>;
    DDM_WIDE_CHUNKS(DDM_WIDE_DQ)
#undef DDM_WIDE_DQ
    default: return nullptr;
  }
}

// The wide registers backward (padded widths 144-896): att by the wide
// forward core where asked, the dq side (stats: B x H x N x 3 floats), then
// the dk/dv side.
cudaError_t launch_bwd_wide_regs(Heads in, const bf16* datt, bf16* att, DHeads out, float* stats,
                                 int B, int N, int H, int Dh, float scale, cudaStream_t s) {
  const int DP = padded(Dh), rt = wide_bwd_dq_rt(N, DP);
  cudaError_t err;
  if (att) {
    err = launch_core(in, att, B, N, H, Dh, scale, kFwdRegisters, s);
    if (err != cudaSuccess) return err;
  }
  const WideDqKernel kernel = wide_dq_kernel(DP);
  const size_t smem = wide_bwd_dq_smem(N, DP, rt);
  err = set_smem((const void*)kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(B * H, (N + 16 * rt - 1) / (16 * rt)), 128 * rt, smem, s>>>(in, datt, out, stats,
                                                                          N, H, Dh, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_bwd_dkv_wide({in.q, in.k, in.v, in.ld, datt, H * Dh, out.k, out.v, out.ld,
                              nullptr, nullptr, stats, B, N, H, Dh, scale},
                             s);
}

template <int NC>
cudaError_t launch_dkv_wide_at(const WideDkvArgs& a, cudaStream_t s) {
  using L = WideDkv<NC>;
  const size_t smem = L::smem(padded(a.Dh));
  const cudaError_t err = set_smem((const void*)attention_bwd_dkv_wide_kernel<NC>, smem);
  if (err != cudaSuccess) return err;
  attention_bwd_dkv_wide_kernel<NC>
      <<<dim3((a.N + L::kKeys - 1) / L::kKeys, a.H, a.B), 256, smem, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// The dk/dv side of the wide backwards, K8b's and the core's
// (attention_bwd_regs.cuh).
cudaError_t launch_bwd_dkv_wide(const WideDkvArgs& a, cudaStream_t s) {
  switch ((padded(a.Dh) + kWideCols - 1) / kWideCols) {
#define DDM_DKV_WIDE(NC) \
    case NC: return launch_dkv_wide_at<NC>(a, s);
    DDM_WIDE_CHUNKS(DDM_DKV_WIDE)
#undef DDM_DKV_WIDE
    default: return cudaErrorInvalidValue;
  }
}

const void* bwd_dkv_wide_kernel(int chunks) {
  switch (chunks) {
#define DDM_DKV_KERNEL(NC) \
    case NC: return (const void*)attention_bwd_dkv_wide_kernel<NC>;
    DDM_WIDE_CHUNKS(DDM_DKV_KERNEL)
#undef DDM_DKV_KERNEL
    default: return nullptr;
  }
}

}  // namespace ddm

// The plan the launchers take for (N, Dh) and `design` (-1: their own
// pick): forward, plan[0..2] = (design, QT, C), design 0 (resident), 1
// (streamed) or 2 (registers: QT the block's query rows, 64 or 128 up to a
// padded head of 128 and 64 or 32 past it, C the padded head);
// backward, plan[0..6] = (design, pass 1's QT, C, pass 2's KT,
// QT, C, C2), design 0 (one block: no pass tiles), 1 (two passes on whole
// heads), 2 (a pass streamed), 3 (registers, up to a padded head of 896:
// the dq side's rows a block and padded head, the dk/dv side's keys a
// block, queries a stage and padded head twice) or 4 (registers, one block
// per (image, head), up to 128: the same tiles). A forced design is reported as asked (at
// Dh <= kChunk the streamed tiles hold the whole head). Returns
// cudaErrorInvalidValue where no design of that choice takes the shape.
extern "C" int ddm_attention_core_plan(int N, int Dh, int backward, int design, int* plan) {
  using namespace ddm;
  if (!takes(N, Dh)) return (int)cudaErrorInvalidValue;
  if (!backward) {
    const FwdPlan p = fwd_plan(N, Dh, design);
    plan[0] = p.design;
    plan[1] = p.tiles.QT;
    plan[2] = p.tiles.C;
    return p.tiles.QT ? 0 : (int)cudaErrorInvalidValue;
  }
  const BwdPlan p = bwd_plan(N, Dh, design);
  const int v[7] = {p.design, p.rows.QT, p.rows.C, p.cols.KT, p.cols.QT, p.cols.C, p.cols.C2};
  for (int i = 0; i < 7; ++i) plan[i] = v[i];
  return p.design >= 0 ? 0 : (int)cudaErrorInvalidValue;
}

// Registers and local (spill) bytes a thread of each core kernel takes:
// attrs[2 i], attrs[2 i + 1] for the forward core (resident, streamed), the
// one-block backward, pass 1 (resident, streamed), pass 2 (resident,
// streamed), then the forward's registers design at padded widths 16, 32,
// ..., 128, each with two score tiles held (4 warps), in two sweeps on 4
// warps and on 8, then the backward's registers design at the same widths,
// each its dq side with att and without, its dk/dv side, and the fused
// block with att and without; then the forward's wide registers instances
// on 8 warps at padded widths 144-256, 272-384, ..., 784-896, and on 16 at
// 144-256, 272-384 and 400-512; then the backward's wide registers
// instances at 144-256, ..., 784-896: the dq side's, then the dk/dv side's.
extern "C" int ddm_attention_kernel_attrs(int* attrs) {
  using namespace ddm;
  constexpr int kN = 7 + 24 + 40 + 9 + 12;
  const void* kernels[kN] = {(const void*)attention_core_kernel<false>,
                             (const void*)attention_core_kernel<true>,
                             (const void*)attention_core_bwd_kernel<0>,
                             (const void*)attention_core_bwd_rows_kernel<false>,
                             (const void*)attention_core_bwd_rows_kernel<true>,
                             (const void*)attention_core_bwd_cols_kernel<false>,
                             (const void*)attention_core_bwd_cols_kernel<true>};
  for (int w = 0; w < 8; ++w) {
    const int DP = 16 * (w + 1);
    kernels[7 + 3 * w] = (const void*)regs_kernel<2, 4>(DP);
    kernels[8 + 3 * w] = (const void*)regs_kernel<0, 4>(DP);
    kernels[9 + 3 * w] = (const void*)regs_kernel<0, 8>(DP);
  }
  int i = 31;
#define DDM_BWD_REGS_ATTRS(W)                                               \
  kernels[i++] = (const void*)attention_core_bwd_dq_regs_kernel<W, 4, true>;  \
  kernels[i++] = (const void*)attention_core_bwd_dq_regs_kernel<W, 4, false>; \
  kernels[i++] = (const void*)attention_core_bwd_dkv_regs_kernel<W, 4>;       \
  kernels[i++] = (const void*)attention_core_bwd_fused_kernel<W, true>;       \
  kernels[i++] = (const void*)attention_core_bwd_fused_kernel<W, false>;
  DDM_REGS_WIDTHS(DDM_BWD_REGS_ATTRS)
#undef DDM_BWD_REGS_ATTRS
  for (const int warps : {8, 16})
    for (int dp = 256; dp <= (warps == 8 ? 896 : 512); dp += kWideCols)
      kernels[i++] = (const void*)wide_kernel(dp, warps);
  for (int dp = 256; dp <= kWideMaxWidth; dp += kWideCols)
    kernels[i++] = (const void*)wide_dq_kernel(dp);
  for (int nc = 2; nc <= kWideMaxWidth / kWideCols; ++nc) kernels[i++] = bwd_dkv_wide_kernel(nc);
  for (i = 0; i < kN; ++i) {
    cudaFuncAttributes a;
    const cudaError_t err = cudaFuncGetAttributes(&a, kernels[i]);
    if (err != cudaSuccess) return (int)err;
    attrs[2 * i] = a.numRegs;
    attrs[2 * i + 1] = (int)a.localSizeBytes;
  }
  return 0;
}

// The forward core (K2f's, and K7f): the (B, N, H*Dh) output of q, k and v
// given as (B, N, H*Dh) rows of stride ld (K2f passes the thirds of its
// [q | k | v] buffer, ld = 3D); design as ddm_attention_core_plan's.
extern "C" int ddm_attention_core(const void* q, const void* k, const void* v, int ld, void* out,
                                  int B, int N, int H, int Dh, float scale, int design,
                                  void* stream) {
  using namespace ddm;
  const Heads in{(const bf16*)q, (const bf16*)k, (const bf16*)v, ld};
  return (int)launch_core(in, (bf16*)out, B, N, H, Dh, scale, design, (cudaStream_t)stream);
}

// The backward core (K2b's and K4's, and K7b): dq, dk and dv of the core over
// q, k and v (rows of stride ld) for the (B, N, H*Dh) cotangent dout, into the
// thirds of the (B, N, 3D) dqkv rows, and att = bf16(P V) where att is not
// null (K7b writes none). design as ddm_attention_core_plan's; every design
// but the one-block one takes stats, B x H x N x 3 floats of scratch (the
// fused registers block leaves it untouched).
extern "C" int ddm_attention_core_bwd(const void* q, const void* k, const void* v, int ld,
                                      const void* dout, void* att, void* dqkv, void* stats, int B,
                                      int N, int H, int Dh, float scale, int design,
                                      void* stream) {
  using namespace ddm;
  if (!takes(N, Dh)) return (int)cudaErrorInvalidValue;
  const BwdPlan p = bwd_plan(N, Dh, design);
  if (p.design < 0 || (p.design > 0 && stats == nullptr)) return (int)cudaErrorInvalidValue;
  const Heads in{(const bf16*)q, (const bf16*)k, (const bf16*)v, ld};
  const DHeads out = dqkv_heads(dqkv, H * Dh);
  const cudaStream_t s = (cudaStream_t)stream;
  if (p.design == kBwdOneBlock)
    return (int)launch_bwd_one_block(in, (const bf16*)dout, (bf16*)att, out, B, N, H, Dh, scale,
                                     s);
  if (p.design == kBwdRegisters && padded(Dh) > kRegMaxWidth)
    return (int)launch_bwd_wide_regs(in, (const bf16*)dout, (bf16*)att, out, (float*)stats, B, N,
                                     H, Dh, scale, s);
  if (p.design == kBwdRegisters || p.design == kBwdRegistersFused)
    return (int)launch_bwd_regs(in, (const bf16*)dout, (bf16*)att, out, (float*)stats, B, N, H,
                                Dh, scale, p.design == kBwdRegistersFused, s);
  return (int)launch_bwd_two_pass(in, (const bf16*)dout, (bf16*)att, out, (float*)stats, B, N,
                                  H, Dh, scale, p, s);
}

// X3's instances of the one-block backward (tools/kbench_ablate.py): `skip`
// holds the kSkip* flags of one of the tool's variants (0: the kernel K2b
// launches), writing dq, dk and dv into the thirds of the (B, N, 3D) dqkv
// and att, at the (N, Dh) the one-block design takes. Returns
// cudaErrorInvalidValue for other shapes and other flag sets.
extern "C" int ddm_attention_core_bwd_ablate(const void* q, const void* k, const void* v, int ld,
                                             const void* dout, void* att, void* dqkv, int B,
                                             int N, int H, int Dh, float scale, int skip,
                                             void* stream) {
  using namespace ddm;
  if (!takes(N, Dh) || !one_block_fits(N, Dh) || att == nullptr)
    return (int)cudaErrorInvalidValue;
  decltype(&attention_core_bwd_kernel<0>) kernel;
  switch (skip) {
    case 0: kernel = attention_core_bwd_kernel<0>; break;
    case kSkipSoftmax: kernel = attention_core_bwd_kernel<kSkipSoftmax>; break;
    case kSkipDs: kernel = attention_core_bwd_kernel<kSkipDs>; break;
    case kSkipSoftmax | kSkipDs: kernel = attention_core_bwd_kernel<kSkipSoftmax | kSkipDs>; break;
    case kSkipCoreMM: kernel = attention_core_bwd_kernel<kSkipCoreMM>; break;
    case kSkipRecompute: kernel = attention_core_bwd_kernel<kSkipRecompute>; break;
    default: return (int)cudaErrorInvalidValue;
  }
  const Heads in{(const bf16*)q, (const bf16*)k, (const bf16*)v, ld};
  return (int)launch(kernel, dim3(B * H), core_bwd_smem(N, Dh), (cudaStream_t)stream, in,
                     (const bf16*)dout, (bf16*)att, dqkv_heads(dqkv, H * Dh), N, H, Dh, scale);
}
