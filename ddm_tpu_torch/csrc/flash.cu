// Online-softmax attention for long sequences (K8), forward and backward.
//
// Replaces ddm_tpu/ops/flash.py: the forward `_fwd_kernel` and its
// K/V-windowed tier `_fwd_win_kernel`, and the backward `_bwd_kernel` and
// its two-kernel windowed split `_bwd_dq_kernel` / `_bwd_dkv_kernel`. On the
// TPU those five bodies exist because VMEM holds a whole image's K/V at
// N <= 8192 and not beyond; a block here holds tiles at every N, so one
// design covers all of them. The TPU's head-pair lane packing and its
// phantom-head pad fill 128-lane vregs; WMMA tiles are 16 wide, so each
// block takes one head and any head count runs as it is.
//
// Head widths: every Dh the JAX gate admits, 4, 8, 16, 32, 64, 128 and the
// multiples of 128 up to 896 (`_heads_per_group` takes 128 % Dh == 0 or
// Dh % 128 == 0; its VMEM budget admits none past 896). Three families:
//
// - Dh = 32, 64, 128: the template parameter Dh is the width of the q, k, v
//   and o tiles; score tiles are 64 x 64 at every Dh, and a warp holds its
//   output fragments of a 64 x Dh product in registers. At Dh = 64 every
//   product, sum and rounding runs in the order it ran before Dh was a
//   parameter, and Dh 32 and 128 keep their bits too.
// - Dh = 4, 8, 16 (kNarrow): one instance of each kernel whose tiles are 16
//   columns wide, the depth of one WMMA or mma.sync step. The loads
//   zero-fill columns dh..15 (zero columns add exact zeros to every
//   product), the stores write dh columns, and the scale is the caller's
//   (dh^-0.5). The loads move 8 bytes (4 columns) at a time: a Dh-4 head
//   starts on an 8-byte boundary only. The registers designs (the
//   launchers' picks) are instanced there at width 16 too, with 8-byte
//   cp.async pieces (copy_piece).
// - Dh = 256 ... 896 (wide): a 64 x Dh tile of q, k or v alone is 33-115 KB
//   and one warp's register fragments of a 16 x Dh output would not fit. The
//   wide kernels walk Dh in 128-column chunks (kChunk): S = Q K^T and dP =
//   dO V^T sum their fp32 partial fragments over the chunks in order (the
//   same products in the same order as one depth-Dh loop), and P V, dS K,
//   P^T dO and dS^T Q update one 128-column slice of an fp32 accumulator at
//   a time. In the tiles design (where forced) the accumulators O, dQ, dK
//   and dV live in shared memory (fp32), and the bf16 operands are staged a
//   chunk at a time, so shared memory grows only with the accumulators: a
//   block takes R rows, the largest of 64, 32, 16 whose bytes fit the
//   card's 227 KB (WideRows below). The registers designs, the launchers'
//   picks there (flash_fwd_wide_regs_kernel, flash_bwd_dq_wide_regs_kernel
//   and the shared dk/dv side of attention_bwd_regs.cuh), split O's, dQ's,
//   or dK's and dV's columns over the warps of a row tile instead and keep
//   them in registers.
//
// Shared memory per block (bytes; Smem and WideSmem below; R the wide
// kernels' rows a block):
//
//   Dh      forward            dq                 dk/dv
//   4-16    41,472             56,832             66,048      (16-wide tiles)
//   4-16    18,432             18,432             19,968      (registers)
//   32      51,712             65,024             74,240
//   64      72,192             81,408             90,624
//   128     113,152            130,560            156,160
//   256     128,512 (R 64)     180,736 (R 64)     147,968 (R 32)
//   384     161,280 (R 64)     213,504 (R 64)     180,736 (R 32)
//   512     194,048 (R 64)     140,544 (R 32)     213,504 (R 32)
//   640     226,816 (R 64)     156,928 (R 32)     142,848 (R 16)
//   768     138,496 (R 32)     173,312 (R 32)     159,232 (R 16)
//   896     154,880 (R 32)     189,696 (R 32)     175,616 (R 16)
//
// K8f's wide registers design (WideRegs): 96,256 B at Dh 256 (64 rows, 8
// warps, a 3-stage ring: two blocks an SM), 131,072 and 147,456 at Dh 384
// and 512 (64 rows, 16 warps), 116,736, 124,928 and 133,120 at Dh 640-896
// (32 rows, 8 warps). K8b's (WideBwd, then WideDkv in
// attention_bwd_regs.cuh): the dq side 112,128 B at Dh 256 (64 rows, 8
// warps, a 2-stage ring: two blocks an SM), 179,712 and 212,480 at 384 and
// 512 (64 rows, 16 warps), 157,440, 173,824 and 190,208 at 640-896 (32
// rows, 8 warps); the dk/dv side 157,184 at Dh 256 (64 keys), 130,560,
// 146,944 and 163,328 at 384-640 (32 keys), 125,440 and 133,632 at 768 and
// 896 (16 keys), 8 warps each.
//
// What bounds it on the H100: at DiT-S/4 and --image-size 128 (N = 1024,
// Dh = 64) one (image, head) is 4 N^2 Dh = 268 MFLOP against 384 KB of
// q/k/v (the same ratio at every Dh: both grow with Dh), far above the
// card's ~295 FLOP/byte, so the kernels are bound by the tensor cores and
// by how well these simple tiles feed them: WMMA 16x16x16 on tiles copied
// synchronously into shared memory, no wgmma, TMA or copy pipeline yet.
// At Dh <= 16 the N^2 exponentials per (image, head) do not shrink with Dh,
// so the special-function units (~1/256 of the bf16 matmul rate) set the
// least time, not the tensor cores: a 16-row x 8-key score fragment is one
// m16n8k16 of Q K^T and half of one of P V, 1/4 (Dh 16) to 1/16 (Dh 4) of
// the tensor work a score costs at Dh 64, while its ex2 (16 a clock an SM)
// stays. The registers designs there run at 64-key and 64-query tiles, two
// row tiles a warp in the forward: on the H100, 128-key tiles, 3-4 stage
// rings and four row tiles a warp were no faster (more registers a thread,
// fewer warps an SM to hide the ex2 latency).
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
// o = bf16(O / l) and lse = m + log(l). flash_fwd_wide_kernel does the same
// on R-query tiles with Q, K and V staged by chunks.
//
// flash_fwd_regs_kernel, the forward at Dh 4-128 (the "registers" design,
// the launcher's own pick there, as flash_fwd_wide_regs_kernel is at Dh
// 256-896; flash_fwd_kernel, the "tiles" design, stays where forced):
// flash_fwd_kernel stores S and O to shared memory as WMMA tiles, runs the
// softmax and O's rescale as scalar loops, and copies every tile
// synchronously behind four barriers a key tile, so a block of 113 KB at Dh
// 128 runs alone on its SM. Here the
// same block (4 warps of 16 query rows) holds Q as mma.sync A fragments, S
// and P, O (64 fp32 a lane at Dh 128) and each row's running m and l in
// registers (mma_frag.cuh); K and V pass through a two-stage cp.async ring
// of 64-key tiles, read by ldmatrix (.trans for V), with one barrier a tile
// where a stage is handed over and none between S, the softmax and P V.
// The numerics are the ones above element for element (-1e30 start, p
// rounded to bf16 for P V, l summing the fp32 p, O rescaled before P V is
// added, o = bf16(O / l), lse = m + log(l)); the sums over a row's keys run
// in fragment order, four lanes a row, and exp(s scale - m) is the card's
// ex2 of s (scale log2 e) - m log2 e (mma_frag.cuh), a few fp32 units in the
// last place from expf where bf16(p) keeps 8 bits. At Dh 4-32 a warp takes
// two row tiles of 16 (128 query rows a block), each K and V fragment read
// from shared memory serving both.
//
// Backward, FlashAttention-2's split, with no atomics: each output element
// is written by one block, in a fixed loop order, so a second call is
// bit-identical.
// flash_bwd_dq_kernel, one block per (q tile, head, image): first
// dsum = rowsum(fp32(do) fp32(o)) from the bf16 o (written out for the
// second kernel), then over the k tiles p = exp(s * scale - lse),
// dp = dO V^T, ds = bf16(p (dp - dsum) scale), dq += ds K in register
// fragments (the wide tiles kernel: in shared memory); dq is rounded once.
// flash_bwd_dkv_kernel, one block per (k tile, head, image): over the q
// tiles the same p and ds, dv += bf16(p)^T dO, dk += ds^T Q in register
// fragments (wide tiles: in shared memory); dk and dv are rounded once. The
// registers designs (K8b's pick at every width) do the same on mma.sync
// fragments.
#include "attention_bwd_regs.cuh"
#include "common.cuh"
#include "mma_frag.cuh"

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
constexpr int kNarrow = 16;          // the tile width of heads of 4, 8 and 16 columns

// The shapes that follow from the head width Dh: q/k/v/do tiles are 64 x Dh
// bf16 (row stride kLd), output tiles 64 x Dh fp32 (row stride kOld), and a
// warp holds kFrags of the 4 x (Dh / 16) output fragments of a 64 x Dh
// product: fragment f of warp w is tile t = w + 4 f, at (t / kCols, t % kCols).
template <int Dh>
struct Width {
  static_assert(Dh == kNarrow || (Dh % 32 == 0 && Dh <= 128),
                "the tile kernels are built at widths 16, 32, 64, 128");
  static constexpr int kLd = Dh + kPadH;
  static constexpr int kOld = Dh + kPadF;
  static constexpr int kHalfTiles = kTile * kLd;
  // an fp32 region that holds a 64 x 64 score tile or a 64 x Dh output tile
  static constexpr int kFTiles = kTile * (Dh > kTile ? kOld : kSld);
  static constexpr int kCols = Dh / kFrag;
  static constexpr int kFrags = kTile / kFrag * kCols / kWarps;
};

// Copy 64 rows of one head (Dh bf16 each) from rows of stride ld into a tile.
// At the narrow width the head has dh of the tile's 16 columns: 8-byte
// pieces, the columns past dh zero-filled.
template <int Dh>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* __restrict__ src, int ld,
                                          int dh) {
  if constexpr (Dh == kNarrow) {
    for (int i = threadIdx.x; i < kTile * (Dh / 4); i += kThreads) {
      const int r = i / (Dh / 4), c = (i % (Dh / 4)) * 4;
      uint2 val = make_uint2(0u, 0u);
      if (c < dh) val = *reinterpret_cast<const uint2*>(src + (size_t)r * ld + c);
      *reinterpret_cast<uint2*>(dst + r * Width<Dh>::kLd + c) = val;
    }
  } else {
    for (int i = threadIdx.x; i < kTile * (Dh / 8); i += kThreads) {
      const int r = i / (Dh / 8), c = (i % (Dh / 8)) * 8;
      *reinterpret_cast<uint4*>(dst + r * Width<Dh>::kLd + c) =
          *reinterpret_cast<const uint4*>(src + (size_t)r * ld + c);
    }
  }
}

// The columns of a head the kernels write: dh at the narrow width, else Dh.
template <int Dh>
__device__ __forceinline__ int head_cols(int dh) {
  if constexpr (Dh == kNarrow) return dh;
  return Dh;
}

// The registers designs' cp.async piece (load_tile_async): 8 bytes at the
// narrow width, where a Dh-4 head starts on an 8-byte boundary only, else 16.
__host__ __device__ constexpr int copy_piece(int Dh) { return Dh == kNarrow ? 8 : 16; }

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

// Round a 64 x Dh fp32 tile (row stride kOld) to bf16 rows of stride ld,
// the head's first head_cols columns.
template <int Dh>
__device__ __forceinline__ void store_tile(bf16* __restrict__ dst, int ld, const float* src,
                                           int dh) {
  constexpr int kOld = Width<Dh>::kOld;
  const int pairs = head_cols<Dh>(dh) / 2;
  for (int i = threadIdx.x; i < kTile * pairs; i += kThreads) {
    const int r = i / pairs, c = 2 * (i % pairs);
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
                 float* __restrict__ lse, int N, int H, int dh, float scale) {
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
  const int cols = head_cols<Dh>(dh);  // the head's width: Dh but at the narrow tiles
  const int D = H * cols;
  const size_t row0 = (size_t)b * N;
  load_tile<Dh>(Qs, q + (row0 + q0) * ld + h * cols, ld, dh);
  for (int i = threadIdx.x; i < kTile * W::kOld; i += kThreads) O[i] = 0.f;
  if (threadIdx.x < kTile) {
    row_m[threadIdx.x] = kNegBig;
    row_l[threadIdx.x] = 0.f;
  }

  for (int k0 = 0; k0 < N; k0 += kTile) {
    __syncthreads();  // the last tile's P V is done with Ks, Vs and P
    load_tile<Dh>(Ks, k + (row0 + k0) * ld + h * cols, ld, dh);
    load_tile<Dh>(Vs, v + (row0 + k0) * ld + h * cols, ld, dh);
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

  bf16* dst = o + (row0 + q0) * D + h * cols;
  for (int i = threadIdx.x; i < kTile * cols / 2; i += kThreads) {
    const int r = i / (cols / 2), c = 2 * (i % (cols / 2));
    const float l = row_l[r];
    *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)r * D + c) =
        __floats2bfloat162_rn(O[r * W::kOld + c] / l, O[r * W::kOld + c + 1] / l);
  }
  if (threadIdx.x < kTile)
    lse[((size_t)b * H + h) * N + q0 + threadIdx.x] =
        row_m[threadIdx.x] + logf(row_l[threadIdx.x]);
}

// Q's 64 MT rows, then two stages of K and two of V, rows of Dh + kPadH.
template <int Dh, int MT>
constexpr size_t regs_fwd_smem() {
  return (size_t)(MT + 4) * kTile * (Dh + kPadH) * sizeof(bf16);
}

// One block per (64 MT-query tile, head, image): 4 warps, each with MT row
// tiles of 16 (each B fragment read from shared memory serves all MT). Dh
// is the tiles' width; the head has dh of its columns (head_cols).
template <int Dh, int MT>
__global__ void __launch_bounds__(kThreads)
flash_fwd_regs_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, int ld, bf16* __restrict__ o,
                      float* __restrict__ lse, int N, int H, int dh, float scale) {
  static_assert(Dh == kNarrow || (Dh % 32 == 0 && Dh <= 128),
                "the registers design is built at widths 16, 32, 64, 128");
  constexpr int kRows = kTile * MT, kLd = Dh + kPadH, kT = kTile * kLd, kPiece = copy_piece(Dh);
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + kRows * kLd;  // two stages
  bf16* Vs = Ks + 2 * kT;       // two stages
  const int q0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int cols = head_cols<Dh>(dh), D = H * cols, nt = N / kTile;
  const size_t row0 = (size_t)b * N;
  const bf16* qh = q + row0 * ld + h * cols;
  const bf16* kh = k + row0 * ld + h * cols;
  const bf16* vh = v + row0 * ld + h * cols;
  const float scale2 = scale * kLog2e;
  uint32_t qa[MT][Dh / 16][4];
  float acc[MT][Dh / 8][4];
  float m[MT][2], l[MT][2];  // rows g and g + 8 of each row tile
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int j = 0; j < Dh / 8; ++j)
      acc[mt][j][0] = acc[mt][j][1] = acc[mt][j][2] = acc[mt][j][3] = 0.f;
    m[mt][0] = m[mt][1] = kNegBig;
    l[mt][0] = l[mt][1] = 0.f;
  }

  // tile j + 1's copy runs while tile j computes, into the stage tile j - 1
  // read: every warp has passed tile j's barrier, so is done with it
  auto issue = [&](int j) {
    const int st = j & 1;
    load_tile_async<kTile, Dh, kThreads, kPiece>(Ks + st * kT, kh, ld, j * kTile, N, cols);
    load_tile_async<kTile, Dh, kThreads, kPiece>(Vs + st * kT, vh, ld, j * kTile, N, cols);
    cp_async_commit();
  };
  load_tile_async<kRows, Dh, kThreads, kPiece>(Qs, qh, ld, q0, N, cols);
  issue(0);
  for (int j = 0; j < nt; ++j) {
    cp_async_wait<0>();
    __syncthreads();
    if (j + 1 < nt) issue(j + 1);
    if (j == 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        load_a_frags<Dh>(qa[mt], Qs + (warp * MT + mt) * 16 * kLd, lane);
    }
    const int st = j & 1;
    float s[MT][8][4];
    qk_tile<Dh, MT>(s, qa, Ks + st * kT, lane);
    uint32_t pa[MT][4][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      // online softmax, rows g (s[.][0], s[.][1]) and g + 8 (s[.][2], s[.][3]);
      // the largest raw score times the scale (> 0) is the largest scaled one
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int c = 0; c < 8; ++c) mx = fmaxf(mx, fmaxf(s[mt][c][2 * r], s[mt][c][2 * r + 1]));
        const float m_new = fmaxf(m[mt][r], quad_max(mx) * scale), m2 = m_new * kLog2e;
        const float corr = exp2_approx(m[mt][r] * kLog2e - m2);
        float sum = 0.f;
#pragma unroll
        for (int c = 0; c < 8; ++c)
#pragma unroll
          for (int e = 2 * r; e < 2 * r + 2; ++e) {
            s[mt][c][e] = exp2_approx(s[mt][c][e] * scale2 - m2);
            sum += s[mt][c][e];
          }
        l[mt][r] = l[mt][r] * corr + quad_sum(sum);
        m[mt][r] = m_new;
#pragma unroll
        for (int c = 0; c < Dh / 8; ++c) {
          acc[mt][c][2 * r] *= corr;
          acc[mt][c][2 * r + 1] *= corr;
        }
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) pack_a(pa[mt][kk], s[mt][2 * kk], s[mt][2 * kk + 1]);
    }
    pv_tile<Dh, MT>(acc, pa, Vs + st * kT, lane);
  }
  const int g = lane / 4;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int r = q0 + (warp * MT + mt) * 16;
    store_rows_bf16<Dh>(o + row0 * D + h * cols, D, acc[mt], l[mt][0], l[mt][1], r, N, cols,
                        lane);
    if (lane % 4 == 0) {
      float* dst = lse + ((size_t)b * H + h) * N + r + g;
      if (r + g < N) dst[0] = m[mt][0] + logf(l[mt][0]);
      if (r + g + 8 < N) dst[8] = m[mt][1] + logf(l[mt][1]);
    }
  }
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
__device__ __forceinline__ float row_dot(const bf16* a, const bf16* o, int lane, int dh = Dh) {
  float s;
  if constexpr (Dh == kNarrow) {
    s = lane < dh ? __bfloat162float(a[lane]) * __bfloat162float(o[lane]) : 0.f;
  } else if constexpr (Dh == 32) {
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
                    float* __restrict__ dsum, bf16* __restrict__ dqkv, int N, int H, int dh,
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
  const int cols = head_cols<Dh>(dh);
  const int D = H * cols;
  const size_t row0 = (size_t)b * N;
  const size_t stat0 = ((size_t)b * H + h) * N + q0;
  load_tile<Dh>(Qs, q + (row0 + q0) * ld + h * cols, ld, dh);
  load_tile<Dh>(dOs, dout + (row0 + q0) * D + h * cols, D, dh);
  if (threadIdx.x < kTile) row_lse[threadIdx.x] = lse[stat0 + threadIdx.x];
  __syncthreads();

  // dsum from the bf16 o the forward wrote (flash.py:398)
  for (int r = warp * kRowsPerWarp; r < (warp + 1) * kRowsPerWarp; ++r) {
    const float s = row_dot<Dh>(dOs + r * W::kLd, o + (row0 + q0 + r) * D + h * cols, lane, dh);
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
    load_tile<Dh>(Ks, k + (row0 + k0) * ld + h * cols, ld, dh);
    load_tile<Dh>(Vs, v + (row0 + k0) * ld + h * cols, ld, dh);
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
  store_tile<Dh>(dqkv + (row0 + q0) * 3 * D + h * cols, 3 * D, S, dh);
}

template <int Dh>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, int ld, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ dsum,
                     bf16* __restrict__ dqkv, int N, int H, int dh, float scale) {
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
  const int cols = head_cols<Dh>(dh);
  const int D = H * cols;
  const size_t row0 = (size_t)b * N;
  const size_t stat0 = ((size_t)b * H + h) * N;
  load_tile<Dh>(Ks, k + (row0 + k0) * ld + h * cols, ld, dh);
  load_tile<Dh>(Vs, v + (row0 + k0) * ld + h * cols, ld, dh);

  FragC dk[W::kFrags], dv[W::kFrags];
#pragma unroll
  for (int f = 0; f < W::kFrags; ++f) {
    wmma::fill_fragment(dk[f], 0.0f);
    wmma::fill_fragment(dv[f], 0.0f);
  }

  for (int q0 = 0; q0 < N; q0 += kTile) {
    __syncthreads();  // the last tile's products are done with Qs, dOs, Pb and DS
    load_tile<Dh>(Qs, q + (row0 + q0) * ld + h * cols, ld, dh);
    load_tile<Dh>(dOs, dout + (row0 + q0) * D + h * cols, D, dh);
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
  bf16* out = dqkv + (row0 + k0) * 3 * D + h * cols;
  store_tile<Dh>(out + D, 3 * D, S, dh);
  store_tile<Dh>(out + 2 * D, 3 * D, dP, dh);
}

// K8b's registers design at Dh 4-128 (attention_bwd_regs.cuh, at width 16
// for Dh 4, 8 and 16): a dq block of 64 query rows and a dk/dv block of 64
// key rows, as the tiles design's, with p = exp(s scale - lse) from the
// forward's lse. The dq side takes 64-key tiles; the dk/dv side 32-query
// tiles at Dh 128, where dk and dv take 128 of a thread's registers.
__host__ __device__ constexpr int flash_dkv_tile(int Dh) { return Dh <= 64 ? kBwdTile : 32; }
//
// The dq side's row terms: lse, and dsum = rowsum(fp32(do) fp32(o)) of the
// warp's 16 rows by row_dot (the tiles design's order, so the same bits),
// written out for the dk/dv side.
template <int Dh>
struct FlashRows {
  const bf16* o;  // the head's row 0, row stride ld
  int ld;
  const float* lse;  // the head's row 0
  float* dsum;
  int dh;  // the head's columns (head_cols)
  __device__ __forceinline__ void operator()(int r, int lane, const bf16* dOs, int sld,
                                             RowTerms& w) const {
    const int g = lane / 4;
#pragma unroll 1
    for (int i = 0; i < 16; ++i) {
      const float d = row_dot<Dh>(dOs + i * sld, o + (size_t)(r + i) * ld, lane, dh);
      if (i == g) w.dsum[0] = d;
      if (i == g + 8) w.dsum[1] = d;
      if (lane == 0) dsum[r + i] = d;
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      w.a[e] = lse[r + g + 8 * e] * kLog2e;
      w.b[e] = 1.f;
    }
  }
};

template <int Dh>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_regs_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, int ld, const bf16* __restrict__ o,
                         const bf16* __restrict__ dout, const float* __restrict__ lse,
                         float* __restrict__ dsum, bf16* __restrict__ dqkv, int N, int H, int dh,
                         float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int h = blockIdx.y, b = blockIdx.z, cols = head_cols<Dh>(dh), D = H * cols;
  const size_t row0 = (size_t)b * N, stat0 = ((size_t)b * H + h) * N;
  bwd_dq_body<Dh, kWarps, kBwdTile, false, false, FlashRows<Dh>, copy_piece(Dh)>(
      smem, q + row0 * ld + h * cols, k + row0 * ld + h * cols, v + row0 * ld + h * cols, ld,
      dout + row0 * D + h * cols, D, dqkv + row0 * 3 * D + h * cols, 3 * D, nullptr, 0, nullptr,
      N, cols, scale, blockIdx.x * kTile,
      FlashRows<Dh>{o + row0 * D + h * cols, D, lse + stat0, dsum + stat0, cols});
}

// The dk/dv side's query terms: (lse log2 e, 1, dsum).
struct FlashCols {
  const float* lse;  // the head's row 0
  const float* dsum;
  __device__ __forceinline__ void operator()(int c, float& a, float& b, float& d) const {
    a = lse[c] * kLog2e;
    b = 1.f;
    d = dsum[c];
  }
};

template <int Dh>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_regs_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, int ld, const bf16* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ dsum,
                          bf16* __restrict__ dqkv, int N, int H, int dh, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int h = blockIdx.y, b = blockIdx.z, cols = head_cols<Dh>(dh), D = H * cols;
  const size_t row0 = (size_t)b * N, stat0 = ((size_t)b * H + h) * N;
  bf16* out = dqkv + row0 * 3 * D + h * cols;
  bwd_dkv_body<Dh, kWarps, flash_dkv_tile(Dh), FlashCols, copy_piece(Dh), true>(
      smem, q + row0 * ld + h * cols, k + row0 * ld + h * cols, v + row0 * ld + h * cols, ld,
      dout + row0 * D + h * cols, D, out + D, out + 2 * D, 3 * D, N, cols, scale,
      blockIdx.x * kTile, FlashCols{lse + stat0, dsum + stat0});
}

// ---- wide heads: Dh = 256 ... 896, walked in 128-column chunks ----

constexpr int kChunk = 128;           // head columns staged at a time
constexpr int kCld = kChunk + kPadH;  // bf16 chunk row stride
constexpr size_t kMaxSmem = 232448;   // the card's shared memory a block can opt into

// Shared memory of the wide kernels at R rows a block (queries in the
// forward and dq kernels, keys in the dk/dv kernel); fp32 accumulators of
// row stride Dh + kPadF.
template <int Dh>
struct WideSmem {
  static constexpr size_t fwd(int R) {  // Qc, a K or V chunk, P; S, O, m, l
    return (size_t)(R * kCld + kTile * kCld + R * kPld) * sizeof(bf16) +
           (size_t)(R * kSld + R * (Dh + kPadF) + 2 * R) * sizeof(float);
  }
  static constexpr size_t dq(int R) {  // Qc, dOc, Kc, Vc, DS; S, dP, dQ, lse, dsum
    return (size_t)(2 * R * kCld + 2 * kTile * kCld + R * kPld) * sizeof(bf16) +
           (size_t)(2 * R * kSld + R * (Dh + kPadF) + 2 * R) * sizeof(float);
  }
  static constexpr size_t dkv(int R) {  // Kc, Vc, Qc, dOc, Pb, DS; S, dP, dK, dV, lse, dsum
    return (size_t)(2 * R * kCld + 2 * kTile * kCld + 2 * kTile * (R + kPadH)) * sizeof(bf16) +
           (size_t)(2 * kTile * (R + kPadF) + 2 * R * (Dh + kPadF) + 2 * kTile) *
               sizeof(float);
  }
};

// The most rows of 64, 32 and 16 whose shared memory (at 64 and 32 rows) fits.
constexpr int wide_rows(size_t at64, size_t at32) {
  return at64 <= kMaxSmem ? 64 : at32 <= kMaxSmem ? 32 : 16;
}

template <int Dh>
struct WideRows {
  static_assert(Dh % kChunk == 0 && Dh > kChunk && Dh <= 896,
                "the wide kernels are built for Dh = 256 ... 896, multiples of 128");
  using M = WideSmem<Dh>;
  static constexpr int kFwd = wide_rows(M::fwd(64), M::fwd(32));
  static constexpr int kDq = wide_rows(M::dq(64), M::dq(32));
  static constexpr int kDkv = wide_rows(M::dkv(64), M::dkv(32));
  static_assert(WideSmem<Dh>::fwd(kFwd) <= kMaxSmem && WideSmem<Dh>::dq(kDq) <= kMaxSmem &&
                    WideSmem<Dh>::dkv(kDkv) <= kMaxSmem,
                "a wide kernel's 16-row tiles exceed the card's shared memory");
};

// Copy ROWS rows of one 128-column chunk (bf16) from rows of stride ld.
template <int ROWS>
__device__ __forceinline__ void load_chunk(bf16* dst, const bf16* __restrict__ src, int ld) {
  for (int i = threadIdx.x; i < ROWS * (kChunk / 8); i += kThreads) {
    const int r = i / (kChunk / 8), c = (i % (kChunk / 8)) * 8;
    *reinterpret_cast<uint4*>(dst + r * kCld + c) =
        *reinterpret_cast<const uint4*>(src + (size_t)r * ld + c);
  }
}

// acc[f] += A B^T over one chunk for the warp's fragments of an M x NR score
// tile (A: M chunk rows, B: NR chunk rows): fragment f is tile
// t = warp + 4 f at (t / (NR / 16), t % (NR / 16)).
template <int M, int NR>
__device__ __forceinline__ void chunk_abt(FragC* acc, const bf16* A, const bf16* B, int warp) {
  constexpr int kColT = NR / kFrag, kF = M / kFrag * kColT / kWarps;
  static_assert(M / kFrag * kColT % kWarps == 0, "score tiles must split over the warps");
#pragma unroll
  for (int f = 0; f < kF; ++f) {
    const int t = warp + kWarps * f, ti = t / kColT, tj = t % kColT;
#pragma unroll
    for (int kk = 0; kk < kChunk; kk += kFrag) {
      FragA a;
      FragBCol b;
      wmma::load_matrix_sync(a, A + ti * kFrag * kCld + kk, kCld);
      wmma::load_matrix_sync(b, B + tj * kFrag * kCld + kk, kCld);
      wmma::mma_sync(acc[f], a, b, acc[f]);
    }
  }
}

// Store the warp's score fragments of an M x NR tile into fp32 rows of stride ld.
template <int M, int NR>
__device__ __forceinline__ void store_scores(float* out, int ld, const FragC* acc, int warp) {
  constexpr int kColT = NR / kFrag, kF = M / kFrag * kColT / kWarps;
#pragma unroll
  for (int f = 0; f < kF; ++f) {
    const int t = warp + kWarps * f;
    wmma::store_matrix_sync(out + (t / kColT) * kFrag * ld + (t % kColT) * kFrag, acc[f], ld,
                            wmma::mem_row_major);
  }
}

// Round R rows of Dh fp32 (row stride Dh + kPadF), each divided by div[r]
// where given, to bf16 rows of stride ld.
template <int Dh, int R>
__device__ __forceinline__ void store_rows(bf16* __restrict__ dst, int ld, const float* src,
                                           const float* div = nullptr) {
  constexpr int kAld = Dh + kPadF;
  for (int i = threadIdx.x; i < R * Dh / 2; i += kThreads) {
    const int r = i / (Dh / 2), c = 2 * (i % (Dh / 2));
    float a = src[r * kAld + c], b = src[r * kAld + c + 1];
    if (div) {
      a /= div[r];
      b /= div[r];
    }
    *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)r * ld + c) = __floats2bfloat162_rn(a, b);
  }
}

template <int Dh>
__global__ void __launch_bounds__(kThreads)
flash_fwd_wide_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, int ld, bf16* __restrict__ o,
                      float* __restrict__ lse, int N, int H, float scale) {
  constexpr int R = WideRows<Dh>::kFwd, kAld = Dh + kPadF;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qc = reinterpret_cast<bf16*>(smem);
  bf16* Cc = Qc + R * kCld;  // a K chunk, then a V chunk
  bf16* P = Cc + kTile * kCld;
  float* S = reinterpret_cast<float*>(P + R * kPld);
  float* O = S + R * kSld;
  float* row_m = O + R * kAld;
  float* row_l = row_m + R;

  const int q0 = blockIdx.x * R, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int D = H * Dh;
  const size_t row0 = (size_t)b * N;
  const bf16* qh = q + (row0 + q0) * ld + h * Dh;
  for (int i = threadIdx.x; i < R * kAld; i += kThreads) O[i] = 0.f;
  if (threadIdx.x < R) {
    row_m[threadIdx.x] = kNegBig;
    row_l[threadIdx.x] = 0.f;
  }

  for (int k0 = 0; k0 < N; k0 += kTile) {
    const size_t kv = (row0 + k0) * ld + h * Dh;
    // S = Q K^T, the fp32 partials summed over the chunks in order
    FragC acc[R / kFrag * (kTile / kFrag) / kWarps];
#pragma unroll
    for (auto& a : acc) wmma::fill_fragment(a, 0.0f);
    for (int c0 = 0; c0 < Dh; c0 += kChunk) {
      __syncthreads();  // the last chunk's products are done with Qc and Cc
      load_chunk<R>(Qc, qh + c0, ld);
      load_chunk<kTile>(Cc, k + kv + c0, ld);
      __syncthreads();
      chunk_abt<R, kTile>(acc, Qc, Cc, warp);
    }
    store_scores<R, kTile>(S, kSld, acc, warp);
    __syncthreads();

    // online softmax: each lane takes columns lane and lane + 32
    for (int r = warp * (R / kWarps); r < (warp + 1) * (R / kWarps); ++r) {
      const float s0 = S[r * kSld + lane] * scale;
      const float s1 = S[r * kSld + lane + 32] * scale;
      const float m_old = row_m[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      const float corr = expf(m_old - m_new);
      const float sum = warp_sum(p0 + p1);
      P[r * kPld + lane] = __float2bfloat16(p0);
      P[r * kPld + lane + 32] = __float2bfloat16(p1);
      for (int c = lane; c < Dh; c += 32) O[r * kAld + c] *= corr;
      if (lane == 0) {
        row_l[r] = row_l[r] * corr + sum;
        row_m[r] = m_new;
      }
      __syncwarp();
    }

    // O += P V, one 128-column slice of O at a time
    for (int c0 = 0; c0 < Dh; c0 += kChunk) {
      __syncthreads();  // P is written; the last slice's products are done with Cc
      load_chunk<kTile>(Cc, v + kv + c0, ld);
      __syncthreads();
#pragma unroll
      for (int f = 0; f < R / kFrag * (kChunk / kFrag) / kWarps; ++f) {
        const int t = warp + kWarps * f, ti = t / (kChunk / kFrag), tj = t % (kChunk / kFrag);
        float* out = O + ti * kFrag * kAld + c0 + tj * kFrag;
        FragC a_o;
        wmma::load_matrix_sync(a_o, out, kAld, wmma::mem_row_major);
#pragma unroll
        for (int kk = 0; kk < kTile; kk += kFrag) {
          FragA a;
          FragBRow bv;
          wmma::load_matrix_sync(a, P + ti * kFrag * kPld + kk, kPld);
          wmma::load_matrix_sync(bv, Cc + kk * kCld + tj * kFrag, kCld);
          wmma::mma_sync(a_o, a, bv, a_o);
        }
        wmma::store_matrix_sync(out, a_o, kAld, wmma::mem_row_major);
      }
    }
  }
  __syncthreads();
  store_rows<Dh, R>(o + (row0 + q0) * D + h * Dh, D, O, row_l);
  if (threadIdx.x < R)
    lse[((size_t)b * H + h) * N + q0 + threadIdx.x] =
        row_m[threadIdx.x] + logf(row_l[threadIdx.x]);
}

// K8f's registers design at Dh 256-896 (the launcher's pick there;
// flash_fwd_wide_kernel, the "tiles" design, stays where forced). The tiles
// design keeps O (R x Dh fp32) and S in shared memory, 128-227 KB a block of
// 4 warps, copies Q's chunks again for every key tile, runs the softmax and
// O's rescale as scalar loops and moves every operand synchronously. Here
// (mma_frag.cuh, "the wide forwards") one block takes 16 RT query rows of
// one (image, head): RT row tiles times G column groups (WideRegs below: G
// = 2 at Dh 256, each warp 64 of every chunk's 128 columns of O, and 4
// past, 32 columns a chunk), so a lane holds at most 112 fp32 of O. Q is
// copied once. A key tile is NC = Dh / 128 K stages, each a depth
// chunk of the warp's 16 x 64 / G slice of scores, then the softmax, then NC
// V stages, each a column chunk of P V. The row's running max is exchanged
// over the G groups through shared memory (one barrier a key tile), each
// warp rescales its own O and keeps its own part of l (the fp32 p of its
// keys, rescaled as m grows), summed over the groups once at the end; bf16 P
// goes to the row tile's warps through shared memory, its hand-over barrier
// the first V stage's. The numerics are flash_fwd_kernel's element for
// element (-1e30 start, p rounded to bf16 for P V, l summing the fp32 p, O
// rescaled before P V is added, o = bf16(O / l), lse = m + log(l)), with
// exp the card's ex2 as flash_fwd_regs_kernel's.
//
// A block's layout at Dh: G column groups of WARPS warps, 16 WARPS / G
// query rows. Measured on the H100 at N 1024: at Dh 256 two groups of 8
// warps (64 rows, 128 registers a thread) with a three-stage ring, so that
// two blocks share an SM (1.80 ms at (128, 1024, 3, 256) against 2.49 for
// four groups of 16 warps); at 384 and 512 four groups of 16 warps (64
// rows, at most 128 registers a thread: 3-5% faster than two of 8 and four
// of 8); past 512, where a lane's 80-112 fp32 of O leave no room for 16
// warps, four groups of 8 (32 rows). Four ring stages but at Dh 256.
template <int Dh>
struct WideRegs {
  static constexpr int G = Dh == 256 ? 2 : 4, WARPS = Dh == 384 || Dh == 512 ? 16 : 8;
  static constexpr int kRows = 16 * WARPS / G, kStages = Dh == 256 ? 3 : 4;
  static constexpr size_t kSmem =  // Q, the ring, P of each row tile, two exchanges
      (size_t)kRows * (Dh + kPadH) * sizeof(bf16) + (size_t)kStages * kWideStage * sizeof(bf16) +
      (size_t)kRows * (kTile + kPadH) * sizeof(bf16) + (size_t)2 * WARPS * 16 * sizeof(float);
};

template <int Dh>
__global__ void __launch_bounds__(32 * WideRegs<Dh>::WARPS)
flash_fwd_wide_regs_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, int ld, bf16* __restrict__ o,
                           float* __restrict__ lse, int N, int H, float scale) {
  using L = WideRegs<Dh>;
  constexpr int G = L::G, WARPS = L::WARPS, RT = WARPS / G, kRows = L::kRows;
  constexpr int NC = Dh / kWideCols, kThr = 32 * WARPS;
  constexpr int KS = kTile / G, NJ = KS / 8, CW = kWideCols / G, NO = CW / 8;
  constexpr int kQld = Dh + kPadH, kPld = kTile + kPadH, kStages = L::kStages;
  static_assert(Dh % kWideCols == 0 && NC >= 2 && Dh <= kWideMaxWidth,
                "the wide registers design is built at Dh 256 ... 896, multiples of 128");
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* ring = Qs + kRows * kQld;
  bf16* Ps = ring + kStages * kWideStage;  // RT tiles of 16 x 64 bf16 P
  float* xm = reinterpret_cast<float*>(Ps + kRows * kPld);  // 16 rows a warp: raw maxima
  float* xl = xm + WARPS * 16;                              // ... and the parts of l
  const int q0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int rt = warp / G, grp = warp % G;
  const int D = H * Dh, nt = N / kTile, jobs = 2 * NC * nt;
  const size_t row0 = (size_t)b * N;
  const bf16* qh = q + row0 * ld + h * Dh;
  const bf16* kh = k + row0 * ld + h * Dh;
  const bf16* vh = v + row0 * ld + h * Dh;
  const float scale2 = scale * kLog2e;
  // job j: key tile j / (2 NC), its K chunks then its V chunks; its copy is
  // issued at job j - (kStages - 1) into the stage job j - kStages read
  // (every warp has passed job j - kStages + 1's barrier, so is done with it)
  auto issue = [&](int j) {
    if (j < jobs) {
      const int i = j / (2 * NC), c = j % (2 * NC);
      load_chunk_async<kThr>(ring + (j % kStages) * kWideStage, c < NC ? kh : vh, ld, i * kTile, N,
                       (c % NC) * kWideCols, Dh, Dh);
    }
    cp_async_commit();
  };
  int job = 0;
  auto next = [&]() {  // wait for the next job's stage; start the copy kStages - 1 ahead
    cp_async_wait<kStages - 2>();
    __syncthreads();
    issue(job + kStages - 1);
    return ring + (job++ % kStages) * kWideStage;
  };
  load_rows_async<kRows, kThr>(Qs, kQld, qh, ld, q0, N, Dh, Dh);
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) issue(j);
  float acc[NC][NO][4];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int j = 0; j < NO; ++j) acc[c][j][0] = acc[c][j][1] = acc[c][j][2] = acc[c][j][3] = 0.f;
  float m[2] = {kNegBig, kNegBig}, l[2] = {0.f, 0.f};  // rows g and g + 8
  const bf16* qw = Qs + rt * 16 * kQld;
  bf16* pw = Ps + rt * 16 * kPld;
  for (int i = 0; i < nt; ++i) {
    float s[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      qk_chunk<NJ>(s, qw + c * kWideCols, kQld, next() + grp * KS * kWideLd, kWideCols, lane);
    // the row's largest raw score over the G slices (times the scale > 0,
    // the largest scaled one)
    float mx[2] = {-INFINITY, -INFINITY};
    row_max(s, mx);
    mx[0] = quad_max(mx[0]);
    mx[1] = quad_max(mx[1]);
    if (t == 0) {
      xm[warp * 16 + g] = mx[0];
      xm[warp * 16 + g + 8] = mx[1];
    }
    __syncthreads();
    group_max<G>(xm + rt * G * 16, g, mx);
    float m2[2], corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], mx[r] * scale);
      m2[r] = m_new * kLog2e;
      corr[r] = exp2_approx(m[r] * kLog2e - m2[r]);
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2_approx(s[j][e] * scale2 - m2[e / 2]);
        sum[e / 2] += s[j][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + quad_sum(sum[r]);
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        acc[c][j][0] *= corr[0];
        acc[c][j][1] *= corr[0];
        acc[c][j][2] *= corr[1];
        acc[c][j][3] *= corr[1];
      }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = grp * KS + 8 * j + 2 * t;
      *reinterpret_cast<uint32_t*>(pw + g * kPld + col) = pack_bf16(s[j][0], s[j][1]);
      *reinterpret_cast<uint32_t*>(pw + (g + 8) * kPld + col) = pack_bf16(s[j][2], s[j][3]);
    }
    uint32_t pa[4][4];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const bf16* st = next();  // at c = 0 its barrier also hands P over
      if (c == 0) load_a_frags<kTile>(pa, pw, lane);
      pv_chunk<NO>(acc[c], pa, st + grp * CW, CW, lane);
    }
  }
  if (t == 0) {
    xl[warp * 16 + g] = l[0];
    xl[warp * 16 + g + 8] = l[1];
  }
  __syncthreads();
  group_sum<G>(xl + rt * G * 16, g, l);
  const int r = q0 + rt * 16;
  store_wide<NC, NO>(o + row0 * D + h * Dh, D, acc, l[0], l[1], r, N, grp * CW, Dh, lane);
  if (grp == 0 && t == 0) {
    float* dst = lse + ((size_t)b * H + h) * N + r + g;
    dst[0] = m[0] + logf(l[0]);
    dst[8] = m[1] + logf(l[1]);
  }
}

// K8b's registers design at Dh 256-896 (the launcher's pick there;
// flash_bwd_dq_wide_kernel and flash_bwd_dkv_wide_kernel below, the "tiles"
// design, stay where forced). The tiles design keeps dQ, or dK and dV, as R
// x Dh fp32 in shared memory (R = 32 or 16), loads and stores each
// 128-column slice of it by WMMA for every key (or query) tile, stores S and
// dP to shared memory for a scalar pass, copies Q, dO (and K) again for
// every tile behind two barriers a chunk, and spills. Here the wide
// backwards of attention_bwd_regs.cuh: this dq side and the dk/dv side
// shared with the attention core (csrc/attention.cu). The dq side: 16 RT
// query rows of one (image, head) on RT row tiles times G column groups
// (WideBwd), Q and dO copied once; dsum = rowsum(fp32(do) fp32(o)) by
// row_dot (the tiles design's bits) and lse read once. A key tile is three
// rounds of NC = Dh / 128 ring stages: K (S, the warp's 64 / G keys at the
// full depth; p = exp(s scale - lse) in place), V (dP = dO V^T; dS =
// bf16(p (dP - dsum) scale) to shared memory), K again (each warp adds dS K
// into its 128 / G columns of every chunk of dq, as mma.sync accumulators).
// No score crosses warps: p and dS need no exchange, as K8b has lse and
// dsum. exp is the card's ex2 with log2 e folded into the scale (the
// registers design at Dh 32-128 does the same).
//
// The layout at Dh, as K8f's WideRegs: two groups of 8 warps (64 rows) at
// Dh 256 with a two-stage ring, 112,128 B, so that two blocks share an SM
// (64 fp32 of dq a lane within 128 registers); four groups of 16 warps (64
// rows) at 384 and 512; four of 8 (32 rows, 80-112 fp32 a lane) past 512.
// Measured on the H100 at (128, 1024, 3, 256), the two blocks took 2.98 ms
// against 4.07-4.18 for one block of two groups of 8 warps (three stages),
// four groups of 16, or two blocks of four groups of 8 (32 rows).
template <int Dh>
struct WideBwd {
  static constexpr int G = Dh == 256 ? 2 : 4, WARPS = Dh == 384 || Dh == 512 ? 16 : 8;  // dq
  static constexpr int kRows = 16 * WARPS / G, kStages = Dh == 256 ? 2 : 4;
  static constexpr int kBlocks = Dh == 256 ? 2 : 1;  // blocks an SM
  static constexpr size_t kSmem =  // Q, dO, the ring, dS of each row tile, lse and dsum
      (size_t)2 * kRows * (Dh + kPadH) * sizeof(bf16) +
      (size_t)kStages * kWideStage * sizeof(bf16) + (size_t)kRows * (kTile + kPadH) * sizeof(bf16) +
      (size_t)2 * kRows * sizeof(float);
};

template <int Dh>
__global__ void __launch_bounds__(32 * WideBwd<Dh>::WARPS, WideBwd<Dh>::kBlocks)
flash_bwd_dq_wide_regs_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                              const bf16* __restrict__ v, int ld, const bf16* __restrict__ o,
                              const bf16* __restrict__ dout, const float* __restrict__ lse,
                              float* __restrict__ dsum, bf16* __restrict__ dqkv, int N, int H,
                              float scale) {
  using L = WideBwd<Dh>;
  constexpr int G = L::G, WARPS = L::WARPS, kRows = L::kRows, kS = L::kStages;
  constexpr int NC = Dh / kWideCols, kThr = 32 * WARPS;
  constexpr int KS = kTile / G, NJ = KS / 8, CW = kWideCols / G, NO = CW / 8;
  constexpr int kQld = Dh + kPadH, kPld = kTile + kPadH;
  static_assert(Dh % kWideCols == 0 && NC >= 2 && Dh <= kWideMaxWidth,
                "the wide registers design is built at Dh 256 ... 896, multiples of 128");
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + kRows * kQld;
  bf16* ring = dOs + kRows * kQld;
  bf16* dSs = ring + kS * kWideStage;  // RT tiles of 16 x 64 bf16 dS
  float* row_a = reinterpret_cast<float*>(dSs + kRows * kPld);  // lse log2 e
  float* row_d = row_a + kRows;                                  // dsum
  const int q0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int rt = warp / G, grp = warp % G;
  const int D = H * Dh, nt = N / kTile, jobs = 3 * NC * nt;
  const size_t row0 = (size_t)b * N, stat0 = ((size_t)b * H + h) * N;
  const bf16* qh = q + row0 * ld + h * Dh;
  const bf16* kh = k + row0 * ld + h * Dh;
  const bf16* vh = v + row0 * ld + h * Dh;
  const bf16* doh = dout + row0 * D + h * Dh;
  const float scale2 = scale * kLog2e;
  // job j: key tile j / (3 NC), its K chunks, V chunks, K chunks again;
  // issued kS - 1 jobs ahead into the stage job j - kS read
  auto issue = [&](int j) {
    if (j < jobs) {
      const int i = j / (3 * NC), c = j % (3 * NC);
      load_chunk_async<kThr>(ring + (j % kS) * kWideStage, c >= NC && c < 2 * NC ? vh : kh, ld,
                             i * kTile, N, (c % NC) * kWideCols, Dh, Dh);
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
  load_rows_async<kRows, kThr>(Qs, kQld, qh, ld, q0, N, Dh, Dh);
  load_rows_async<kRows, kThr>(dOs, kQld, doh, D, q0, N, Dh, Dh);
#pragma unroll
  for (int j = 0; j < kS - 1; ++j) issue(j);
  // dsum from the bf16 o the forward wrote (flash.py:398), one row a warp
  // at a time; lse; both handed over by the first stage's barrier
  for (int r = warp; r < kRows; r += WARPS) {
    const float s = row_dot<Dh>(doh + (size_t)(q0 + r) * D, o + (row0 + q0 + r) * D + h * Dh,
                                lane);
    if (lane == 0) {
      row_d[r] = s;
      dsum[stat0 + q0 + r] = s;
    }
  }
  if (threadIdx.x < kRows) row_a[threadIdx.x] = lse[stat0 + q0 + threadIdx.x] * kLog2e;
  float acc[NC][NO][4];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int j = 0; j < NO; ++j) acc[c][j][0] = acc[c][j][1] = acc[c][j][2] = acc[c][j][3] = 0.f;
  const bf16* qw = Qs + rt * 16 * kQld;
  const bf16* dw = dOs + rt * 16 * kQld;
  bf16* dsw = dSs + rt * 16 * kPld;
  const float* ra = row_a + rt * 16 + g;  // rows g and g + 8 at [0] and [8]
  const float* rd = row_d + rt * 16 + g;
  for (int i = 0; i < nt; ++i) {
    float s[NJ][4], dp[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      qk_chunk<NJ>(s, qw + c * kWideCols, kQld, next() + grp * KS * kWideLd, kWideCols, lane);
    const float a[2] = {ra[0], ra[8]};  // read again each tile: no registers held
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = exp2_approx(s[j][e] * scale2 - a[e / 2]);
#pragma unroll
    for (int c = 0; c < NC; ++c)  // dP = dO V^T
      qk_chunk<NJ>(dp, dw + c * kWideCols, kQld, next() + grp * KS * kWideLd, kWideCols, lane);
    const float d[2] = {rd[0], rd[8]};
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = grp * KS + 8 * j + 2 * t;
      *reinterpret_cast<uint32_t*>(dsw + g * kPld + col) =
          pack_bf16(s[j][0] * (dp[j][0] - d[0]) * scale, s[j][1] * (dp[j][1] - d[0]) * scale);
      *reinterpret_cast<uint32_t*>(dsw + (g + 8) * kPld + col) =
          pack_bf16(s[j][2] * (dp[j][2] - d[1]) * scale, s[j][3] * (dp[j][3] - d[1]) * scale);
    }
    uint32_t da[4][4];
#pragma unroll
    for (int c = 0; c < NC; ++c) {  // dq += dS K
      const bf16* st = next();      // at c = 0 its barrier also hands dS over
      if (c == 0) load_a_frags<kTile>(da, dsw, lane);
      pv_chunk<NO>(acc[c], da, st + grp * CW, CW, lane);
    }
  }
  store_wide<NC, NO>(dqkv + row0 * 3 * D + h * Dh, 3 * D, acc, 1.f, 1.f, q0 + rt * 16, N,
                     grp * CW, Dh, lane);
}

// p = exp(s * scale - lse) and ds = bf16(p (dp - dsum) scale) over an
// M x NC tile of fp32 rows of stride sld, the row terms by row; Pb (bf16 p)
// is written when non-null. Rows of stride pld.
template <int M, int NC>
__device__ __forceinline__ void probs_and_ds_tile(const float* S, const float* dP, int sld,
                                                  const float* row_lse, const float* row_dsum,
                                                  bf16* Pb, bf16* DS, int pld, float scale) {
  for (int i = threadIdx.x; i < M * NC; i += kThreads) {
    const int r = i / NC, c = i % NC;
    const float p = expf(S[r * sld + c] * scale - row_lse[r]);
    if (Pb) Pb[r * pld + c] = __float2bfloat16(p);
    DS[r * pld + c] = __float2bfloat16(p * (dP[r * sld + c] - row_dsum[r]) * scale);
  }
}

template <int Dh>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_wide_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, int ld, const bf16* __restrict__ o,
                         const bf16* __restrict__ dout, const float* __restrict__ lse,
                         float* __restrict__ dsum, bf16* __restrict__ dqkv, int N, int H,
                         float scale) {
  constexpr int R = WideRows<Dh>::kDq, kAld = Dh + kPadF;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qc = reinterpret_cast<bf16*>(smem);
  bf16* dOc = Qc + R * kCld;
  bf16* Kc = dOc + R * kCld;
  bf16* Vc = Kc + kTile * kCld;
  bf16* DS = Vc + kTile * kCld;
  float* S = reinterpret_cast<float*>(DS + R * kPld);
  float* dP = S + R * kSld;
  float* dQ = dP + R * kSld;
  float* row_lse = dQ + R * kAld;
  float* row_dsum = row_lse + R;

  const int q0 = blockIdx.x * R, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int D = H * Dh;
  const size_t row0 = (size_t)b * N;
  const size_t stat0 = ((size_t)b * H + h) * N + q0;
  const bf16* qh = q + (row0 + q0) * ld + h * Dh;
  const bf16* doh = dout + (row0 + q0) * D + h * Dh;
  // dsum from the bf16 o the forward wrote (flash.py:398)
  for (int r = warp * (R / kWarps); r < (warp + 1) * (R / kWarps); ++r) {
    const float s = row_dot<Dh>(doh + (size_t)r * D, o + (row0 + q0 + r) * D + h * Dh, lane);
    if (lane == 0) {
      row_dsum[r] = s;
      dsum[stat0 + r] = s;
    }
  }
  if (threadIdx.x < R) row_lse[threadIdx.x] = lse[stat0 + threadIdx.x];
  for (int i = threadIdx.x; i < R * kAld; i += kThreads) dQ[i] = 0.f;

  for (int k0 = 0; k0 < N; k0 += kTile) {
    const size_t kv = (row0 + k0) * ld + h * Dh;
    FragC s_acc[R / kFrag * (kTile / kFrag) / kWarps], p_acc[R / kFrag * (kTile / kFrag) / kWarps];
#pragma unroll
    for (int f = 0; f < R / kFrag * (kTile / kFrag) / kWarps; ++f) {
      wmma::fill_fragment(s_acc[f], 0.0f);
      wmma::fill_fragment(p_acc[f], 0.0f);
    }
    for (int c0 = 0; c0 < Dh; c0 += kChunk) {
      __syncthreads();  // the last chunk's products are done with the chunks
      load_chunk<R>(Qc, qh + c0, ld);
      load_chunk<R>(dOc, doh + c0, D);
      load_chunk<kTile>(Kc, k + kv + c0, ld);
      load_chunk<kTile>(Vc, v + kv + c0, ld);
      __syncthreads();
      chunk_abt<R, kTile>(s_acc, Qc, Kc, warp);
      chunk_abt<R, kTile>(p_acc, dOc, Vc, warp);
    }
    store_scores<R, kTile>(S, kSld, s_acc, warp);
    store_scores<R, kTile>(dP, kSld, p_acc, warp);
    __syncthreads();
    probs_and_ds_tile<R, kTile>(S, dP, kSld, row_lse, row_dsum, nullptr, DS, kPld, scale);
    // dQ += ds K, one 128-column slice at a time
    for (int c0 = 0; c0 < Dh; c0 += kChunk) {
      __syncthreads();  // DS is written; the last slice's products are done with Kc
      load_chunk<kTile>(Kc, k + kv + c0, ld);
      __syncthreads();
#pragma unroll
      for (int f = 0; f < R / kFrag * (kChunk / kFrag) / kWarps; ++f) {
        const int t = warp + kWarps * f, ti = t / (kChunk / kFrag), tj = t % (kChunk / kFrag);
        float* out = dQ + ti * kFrag * kAld + c0 + tj * kFrag;
        FragC a_q;
        wmma::load_matrix_sync(a_q, out, kAld, wmma::mem_row_major);
#pragma unroll
        for (int kk = 0; kk < kTile; kk += kFrag) {
          FragA a;
          FragBRow bk;
          wmma::load_matrix_sync(a, DS + ti * kFrag * kPld + kk, kPld);
          wmma::load_matrix_sync(bk, Kc + kk * kCld + tj * kFrag, kCld);
          wmma::mma_sync(a_q, a, bk, a_q);
        }
        wmma::store_matrix_sync(out, a_q, kAld, wmma::mem_row_major);
      }
    }
  }
  __syncthreads();
  store_rows<Dh, R>(dqkv + (row0 + q0) * 3 * D + h * Dh, 3 * D, dQ);
}

template <int Dh>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_wide_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, int ld, const bf16* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ dsum,
                          bf16* __restrict__ dqkv, int N, int H, float scale) {
  constexpr int R = WideRows<Dh>::kDkv, kAld = Dh + kPadF;
  constexpr int kRld = R + kPadH, kRsld = R + kPadF;  // rows of the 64 x R p, ds and score tiles
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Kc = reinterpret_cast<bf16*>(smem);
  bf16* Vc = Kc + R * kCld;
  bf16* Qc = Vc + R * kCld;
  bf16* dOc = Qc + kTile * kCld;
  bf16* Pb = dOc + kTile * kCld;
  bf16* DS = Pb + kTile * kRld;
  float* S = reinterpret_cast<float*>(DS + kTile * kRld);
  float* dP = S + kTile * kRsld;
  float* dK = dP + kTile * kRsld;
  float* dV = dK + R * kAld;
  float* row_lse = dV + R * kAld;
  float* row_dsum = row_lse + kTile;

  const int k0 = blockIdx.x * R, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int D = H * Dh;
  const size_t row0 = (size_t)b * N;
  const size_t stat0 = ((size_t)b * H + h) * N;
  const size_t kv = (row0 + k0) * ld + h * Dh;
  for (int i = threadIdx.x; i < R * kAld; i += kThreads) dK[i] = dV[i] = 0.f;

  for (int q0 = 0; q0 < N; q0 += kTile) {
    const bf16* qh = q + (row0 + q0) * ld + h * Dh;
    const bf16* doh = dout + (row0 + q0) * D + h * Dh;
    // S = Q K^T and dP = dO V^T (64 query rows x R keys)
    FragC s_acc[kTile / kFrag * (R / kFrag) / kWarps], p_acc[kTile / kFrag * (R / kFrag) / kWarps];
#pragma unroll
    for (int f = 0; f < kTile / kFrag * (R / kFrag) / kWarps; ++f) {
      wmma::fill_fragment(s_acc[f], 0.0f);
      wmma::fill_fragment(p_acc[f], 0.0f);
    }
    for (int c0 = 0; c0 < Dh; c0 += kChunk) {
      __syncthreads();  // the last chunk's (or tile's) products are done with the chunks
      load_chunk<kTile>(Qc, qh + c0, ld);
      load_chunk<kTile>(dOc, doh + c0, D);
      load_chunk<R>(Kc, k + kv + c0, ld);
      load_chunk<R>(Vc, v + kv + c0, ld);
      if (c0 == 0 && threadIdx.x < kTile) {
        row_lse[threadIdx.x] = lse[stat0 + q0 + threadIdx.x];
        row_dsum[threadIdx.x] = dsum[stat0 + q0 + threadIdx.x];
      }
      __syncthreads();
      chunk_abt<kTile, R>(s_acc, Qc, Kc, warp);
      chunk_abt<kTile, R>(p_acc, dOc, Vc, warp);
    }
    store_scores<kTile, R>(S, kRsld, s_acc, warp);
    store_scores<kTile, R>(dP, kRsld, p_acc, warp);
    __syncthreads();
    probs_and_ds_tile<kTile, R>(S, dP, kRsld, row_lse, row_dsum, Pb, DS, kRld, scale);
    // dV += Pb^T dO and dK += DS^T Q over this tile's 64 query rows, one
    // 128-column slice at a time
    for (int c0 = 0; c0 < Dh; c0 += kChunk) {
      __syncthreads();  // Pb and DS are written; the last slice is done with Qc and dOc
      load_chunk<kTile>(Qc, qh + c0, ld);
      load_chunk<kTile>(dOc, doh + c0, D);
      __syncthreads();
#pragma unroll
      for (int f = 0; f < R / kFrag * (kChunk / kFrag) / kWarps; ++f) {
        const int t = warp + kWarps * f, ti = t / (kChunk / kFrag), tj = t % (kChunk / kFrag);
        const int off = ti * kFrag * kAld + c0 + tj * kFrag;
        FragC a_v, a_k;
        wmma::load_matrix_sync(a_v, dV + off, kAld, wmma::mem_row_major);
        wmma::load_matrix_sync(a_k, dK + off, kAld, wmma::mem_row_major);
#pragma unroll
        for (int kk = 0; kk < kTile; kk += kFrag) {
          FragACol a;
          FragBRow bm;
          wmma::load_matrix_sync(a, Pb + kk * kRld + ti * kFrag, kRld);
          wmma::load_matrix_sync(bm, dOc + kk * kCld + tj * kFrag, kCld);
          wmma::mma_sync(a_v, a, bm, a_v);
          wmma::load_matrix_sync(a, DS + kk * kRld + ti * kFrag, kRld);
          wmma::load_matrix_sync(bm, Qc + kk * kCld + tj * kFrag, kCld);
          wmma::mma_sync(a_k, a, bm, a_k);
        }
        wmma::store_matrix_sync(dV + off, a_v, kAld, wmma::mem_row_major);
        wmma::store_matrix_sync(dK + off, a_k, kAld, wmma::mem_row_major);
      }
    }
  }
  __syncthreads();
  bf16* out = dqkv + (row0 + k0) * 3 * D + h * Dh;
  store_rows<Dh, R>(out + D, 3 * D, dK);
  store_rows<Dh, R>(out + 2 * D, 3 * D, dV);
}

// Shared memory of the tile kernels per block (see the table at the top).
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

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// Two row tiles a warp (128 query rows a block) at Dh 4-32, where they
// measured faster on the H100; one at Dh 64 (no faster with two) and 128
// (two would pass the register file).
template <int Dh>
cudaError_t launch_fwd_regs(const void* q, const void* k, const void* v, int ld, void* o,
                            void* lse, int B, int N, int H, int dh, float scale,
                            cudaStream_t stream) {
  constexpr int MT = Dh <= 32 ? 2 : 1;
  constexpr size_t bytes = regs_fwd_smem<Dh, MT>();
  cudaError_t err = allow_smem(flash_fwd_regs_kernel<Dh, MT>, bytes);
  if (err != cudaSuccess) return err;
  flash_fwd_regs_kernel<Dh, MT><<<dim3((N + kTile * MT - 1) / (kTile * MT), H, B), kThreads,
                                  bytes, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, ld, (bf16*)o, (float*)lse, N, H, dh,
      scale);
  return cudaGetLastError();
}

template <int Dh>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, int ld, void* o, void* lse,
                       int B, int N, int H, int dh, float scale, cudaStream_t stream) {
  cudaError_t err = allow_smem(flash_fwd_kernel<Dh>, Smem<Dh>::kFwd);
  if (err != cudaSuccess) return err;
  const dim3 grid(N / kTile, H, B);
  flash_fwd_kernel<Dh><<<grid, kThreads, Smem<Dh>::kFwd, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, ld, (bf16*)o, (float*)lse, N, H, dh,
      scale);
  return cudaGetLastError();
}

template <int Dh>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, int ld, const void* o,
                       const void* dout, const void* lse, void* dsum, void* dqkv, int B, int N,
                       int H, int dh, float scale, cudaStream_t stream) {
  cudaError_t err = allow_smem(flash_bwd_dq_kernel<Dh>, Smem<Dh>::kDq);
  if (err != cudaSuccess) return err;
  err = allow_smem(flash_bwd_dkv_kernel<Dh>, Smem<Dh>::kDkv);
  if (err != cudaSuccess) return err;
  const dim3 grid(N / kTile, H, B);
  // the dq kernel writes dsum, which the dk/dv kernel reads: same stream, in order
  flash_bwd_dq_kernel<Dh><<<grid, kThreads, Smem<Dh>::kDq, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, ld, (const bf16*)o, (const bf16*)dout,
      (const float*)lse, (float*)dsum, (bf16*)dqkv, N, H, dh, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_kernel<Dh><<<grid, kThreads, Smem<Dh>::kDkv, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, ld, (const bf16*)dout, (const float*)lse,
      (const float*)dsum, (bf16*)dqkv, N, H, dh, scale);
  return cudaGetLastError();
}

// The registers design's two kernels: the dq kernel writes dsum, which the
// dk/dv kernel reads (same stream, in order).
template <int Dh>
cudaError_t launch_bwd_regs(const void* q, const void* k, const void* v, int ld, const void* o,
                            const void* dout, const void* lse, void* dsum, void* dqkv, int B,
                            int N, int H, int dh, float scale, cudaStream_t stream) {
  constexpr size_t dq_bytes = bwd_dq_smem<Dh, kWarps, kBwdTile>(),
                   dkv_bytes = bwd_dkv_smem<Dh, kWarps, flash_dkv_tile(Dh)>();
  cudaError_t err = allow_smem(flash_bwd_dq_regs_kernel<Dh>, dq_bytes);
  if (err != cudaSuccess) return err;
  err = allow_smem(flash_bwd_dkv_regs_kernel<Dh>, dkv_bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(N / kTile, H, B);
  flash_bwd_dq_regs_kernel<Dh><<<grid, kThreads, dq_bytes, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, ld, (const bf16*)o, (const bf16*)dout,
      (const float*)lse, (float*)dsum, (bf16*)dqkv, N, H, dh, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_regs_kernel<Dh><<<grid, kThreads, dkv_bytes, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, ld, (const bf16*)dout, (const float*)lse,
      (const float*)dsum, (bf16*)dqkv, N, H, dh, scale);
  return cudaGetLastError();
}

template <int Dh>
cudaError_t launch_fwd_wide(const void* q, const void* k, const void* v, int ld, void* o,
                            void* lse, int B, int N, int H, float scale, cudaStream_t stream) {
  constexpr int R = WideRows<Dh>::kFwd;
  constexpr size_t bytes = WideSmem<Dh>::fwd(R);
  cudaError_t err = allow_smem(flash_fwd_wide_kernel<Dh>, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(N / R, H, B);
  flash_fwd_wide_kernel<Dh><<<grid, kThreads, bytes, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, ld, (bf16*)o, (float*)lse, N, H, scale);
  return cudaGetLastError();
}

template <int Dh>
cudaError_t launch_fwd_wide_regs(const void* q, const void* k, const void* v, int ld, void* o,
                                 void* lse, int B, int N, int H, float scale,
                                 cudaStream_t stream) {
  using L = WideRegs<Dh>;
  static_assert(L::kSmem <= kMaxSmem, "the wide registers design exceeds the card's shared memory");
  cudaError_t err = allow_smem(flash_fwd_wide_regs_kernel<Dh>, L::kSmem);
  if (err != cudaSuccess) return err;
  flash_fwd_wide_regs_kernel<Dh><<<dim3(N / L::kRows, H, B), 32 * L::WARPS, L::kSmem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, ld, (bf16*)o, (float*)lse, N, H, scale);
  return cudaGetLastError();
}

// The wide registers design's two kernels: the dq side writes dsum, which
// the dk/dv side (csrc/attention.cu) reads (same stream, in order).
template <int Dh>
cudaError_t launch_bwd_wide_regs(const void* q, const void* k, const void* v, int ld,
                                 const void* o, const void* dout, const void* lse, void* dsum,
                                 void* dqkv, int B, int N, int H, float scale,
                                 cudaStream_t stream) {
  using L = WideBwd<Dh>;
  static_assert(L::kSmem <= kMaxSmem, "the wide backward exceeds the card's shared memory");
  cudaError_t err = allow_smem(flash_bwd_dq_wide_regs_kernel<Dh>, L::kSmem);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_wide_regs_kernel<Dh><<<dim3(N / L::kRows, H, B), 32 * L::WARPS, L::kSmem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, ld, (const bf16*)o, (const bf16*)dout,
      (const float*)lse, (float*)dsum, (bf16*)dqkv, N, H, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int D = H * Dh;
  bf16* g = (bf16*)dqkv;
  return launch_bwd_dkv_wide({(const bf16*)q, (const bf16*)k, (const bf16*)v, ld,
                              (const bf16*)dout, D, g + D, g + 2 * D, 3 * D, (const float*)lse,
                              (const float*)dsum, nullptr, B, N, H, Dh, scale},
                             stream);
}

template <int Dh>
cudaError_t launch_bwd_wide(const void* q, const void* k, const void* v, int ld, const void* o,
                            const void* dout, const void* lse, void* dsum, void* dqkv, int B,
                            int N, int H, float scale, cudaStream_t stream) {
  constexpr int Rq = WideRows<Dh>::kDq, Rk = WideRows<Dh>::kDkv;
  constexpr size_t dq_bytes = WideSmem<Dh>::dq(Rq), dkv_bytes = WideSmem<Dh>::dkv(Rk);
  cudaError_t err = allow_smem(flash_bwd_dq_wide_kernel<Dh>, dq_bytes);
  if (err != cudaSuccess) return err;
  err = allow_smem(flash_bwd_dkv_wide_kernel<Dh>, dkv_bytes);
  if (err != cudaSuccess) return err;
  // the dq kernel writes dsum, which the dk/dv kernel reads: same stream, in order
  flash_bwd_dq_wide_kernel<Dh><<<dim3(N / Rq, H, B), kThreads, dq_bytes, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, ld, (const bf16*)o, (const bf16*)dout,
      (const float*)lse, (float*)dsum, (bf16*)dqkv, N, H, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_wide_kernel<Dh><<<dim3(N / Rk, H, B), kThreads, dkv_bytes, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, ld, (const bf16*)dout, (const float*)lse,
      (const float*)dsum, (bf16*)dqkv, N, H, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace ddm

// Every head width the JAX gate admits; cudaErrorInvalidValue for any other.
#define DDM_FLASH_WIDTHS(X) \
  X(256) X(384) X(512) X(640) X(768) X(896)

// The forward's designs: 0 "tiles" (flash_fwd_kernel at Dh 4-128,
// flash_fwd_wide_kernel at Dh 256-896), 1 "registers"
// (flash_fwd_regs_kernel at Dh 4-128, flash_fwd_wide_regs_kernel at Dh
// 256-896); -1 registers, the pick at every width.
constexpr int kFwdTiles = 0, kFwdRegisters = 1;

extern "C" int ddm_flash_fwd(const void* q, const void* k, const void* v, int ld, void* o,
                             void* lse, int B, int N, int H, int Dh, float scale, int design,
                             void* stream) {
  using namespace ddm;
  const cudaStream_t s = (cudaStream_t)stream;
  if (design == kFwdRegisters || design < 0) {
    switch (Dh) {
      case 4:
      case 8:
      case 16: return (int)launch_fwd_regs<kNarrow>(q, k, v, ld, o, lse, B, N, H, Dh, scale, s);
      case 32: return (int)launch_fwd_regs<32>(q, k, v, ld, o, lse, B, N, H, Dh, scale, s);
      case 64: return (int)launch_fwd_regs<64>(q, k, v, ld, o, lse, B, N, H, Dh, scale, s);
      case 128: return (int)launch_fwd_regs<128>(q, k, v, ld, o, lse, B, N, H, Dh, scale, s);
#define DDM_FWD_WIDE_REGS(W) \
      case W: return (int)launch_fwd_wide_regs<W>(q, k, v, ld, o, lse, B, N, H, scale, s);
      DDM_FLASH_WIDTHS(DDM_FWD_WIDE_REGS)
#undef DDM_FWD_WIDE_REGS
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (design != kFwdTiles) return (int)cudaErrorInvalidValue;
  switch (Dh) {
    case 4:
    case 8:
    case 16: return (int)launch_fwd<kNarrow>(q, k, v, ld, o, lse, B, N, H, Dh, scale, s);
    case 32: return (int)launch_fwd<32>(q, k, v, ld, o, lse, B, N, H, Dh, scale, s);
    case 64: return (int)launch_fwd<64>(q, k, v, ld, o, lse, B, N, H, Dh, scale, s);
    case 128: return (int)launch_fwd<128>(q, k, v, ld, o, lse, B, N, H, Dh, scale, s);
#define DDM_FWD_WIDE(W) \
    case W: return (int)launch_fwd_wide<W>(q, k, v, ld, o, lse, B, N, H, scale, s);
    DDM_FLASH_WIDTHS(DDM_FWD_WIDE)
#undef DDM_FWD_WIDE
    default: return (int)cudaErrorInvalidValue;
  }
}

// Registers and local (spill) bytes a thread of each K8 kernel takes:
// attrs[2 i], attrs[2 i + 1] for K8f's registers design at Dh 32 (two row
// tiles a warp), 64, 128, then its tiles design there, then K8b's registers
// design's dq kernels, its dk/dv kernels, the tiles design's dq kernels and
// its dk/dv kernels at Dh 32, 64, 128; then K8f's registers design at Dh
// 256, 384, ..., 896 and its tiles design (the chunked kernel) there; then
// K8b's at Dh 256, ..., 896 in the same order as at Dh 32-128 (its
// registers dk/dv kernel is the attention core's wide dk/dv side); then the
// the instance of each at the narrow widths (Dh 4, 8, 16 on 16-column
// tiles) in the order of Dh 32-128: K8f's registers and tiles designs, K8b's
// registers dq and dk/dv kernels, its tiles dq and dk/dv kernels.
extern "C" int ddm_flash_kernel_attrs(int* attrs) {
  using namespace ddm;
  constexpr int kN = 18 + 12 + 24 + 6;
  const void* kernels[kN] = {(const void*)flash_fwd_regs_kernel<32, 2>,
                             (const void*)flash_fwd_regs_kernel<64, 1>,
                             (const void*)flash_fwd_regs_kernel<128, 1>,
                             (const void*)flash_fwd_kernel<32>,
                             (const void*)flash_fwd_kernel<64>,
                             (const void*)flash_fwd_kernel<128>,
                             (const void*)flash_bwd_dq_regs_kernel<32>,
                             (const void*)flash_bwd_dq_regs_kernel<64>,
                             (const void*)flash_bwd_dq_regs_kernel<128>,
                             (const void*)flash_bwd_dkv_regs_kernel<32>,
                             (const void*)flash_bwd_dkv_regs_kernel<64>,
                             (const void*)flash_bwd_dkv_regs_kernel<128>,
                             (const void*)flash_bwd_dq_kernel<32>,
                             (const void*)flash_bwd_dq_kernel<64>,
                             (const void*)flash_bwd_dq_kernel<128>,
                             (const void*)flash_bwd_dkv_kernel<32>,
                             (const void*)flash_bwd_dkv_kernel<64>,
                             (const void*)flash_bwd_dkv_kernel<128>};
  int i = 18;
#define DDM_WIDE_REGS_ATTRS(W) kernels[i++] = (const void*)flash_fwd_wide_regs_kernel<W>;
  DDM_FLASH_WIDTHS(DDM_WIDE_REGS_ATTRS)
#undef DDM_WIDE_REGS_ATTRS
#define DDM_WIDE_ATTRS(W) kernels[i++] = (const void*)flash_fwd_wide_kernel<W>;
  DDM_FLASH_WIDTHS(DDM_WIDE_ATTRS)
#undef DDM_WIDE_ATTRS
#define DDM_WIDE_BWD_ATTRS(W) kernels[i++] = (const void*)flash_bwd_dq_wide_regs_kernel<W>;
  DDM_FLASH_WIDTHS(DDM_WIDE_BWD_ATTRS)
#undef DDM_WIDE_BWD_ATTRS
#define DDM_WIDE_DKV_ATTRS(W) kernels[i++] = bwd_dkv_wide_kernel(W / kWideCols);
  DDM_FLASH_WIDTHS(DDM_WIDE_DKV_ATTRS)
#undef DDM_WIDE_DKV_ATTRS
#define DDM_WIDE_TILES_ATTRS(W) kernels[i++] = (const void*)flash_bwd_dq_wide_kernel<W>;
  DDM_FLASH_WIDTHS(DDM_WIDE_TILES_ATTRS)
#undef DDM_WIDE_TILES_ATTRS
#define DDM_WIDE_TILES_DKV_ATTRS(W) kernels[i++] = (const void*)flash_bwd_dkv_wide_kernel<W>;
  DDM_FLASH_WIDTHS(DDM_WIDE_TILES_DKV_ATTRS)
#undef DDM_WIDE_TILES_DKV_ATTRS
  kernels[i++] = (const void*)flash_fwd_regs_kernel<kNarrow, 2>;
  kernels[i++] = (const void*)flash_fwd_kernel<kNarrow>;
  kernels[i++] = (const void*)flash_bwd_dq_regs_kernel<kNarrow>;
  kernels[i++] = (const void*)flash_bwd_dkv_regs_kernel<kNarrow>;
  kernels[i++] = (const void*)flash_bwd_dq_kernel<kNarrow>;
  kernels[i++] = (const void*)flash_bwd_dkv_kernel<kNarrow>;
  for (i = 0; i < kN; ++i) {
    cudaFuncAttributes a;
    const cudaError_t err = cudaFuncGetAttributes(&a, kernels[i]);
    if (err != cudaSuccess) return (int)err;
    attrs[2 * i] = a.numRegs;
    attrs[2 * i + 1] = (int)a.localSizeBytes;
  }
  return 0;
}

// K8b's designs, as K8f's, with the same codes: 0 "tiles"
// (flash_bwd_dq_kernel and flash_bwd_dkv_kernel at Dh 4-128, the chunked
// flash_bwd_dq_wide_kernel and flash_bwd_dkv_wide_kernel at Dh 256-896), 1
// "registers" (flash_bwd_dq_regs_kernel and flash_bwd_dkv_regs_kernel at Dh
// 4-128, the wide registers design at Dh 256-896); -1 registers, the pick at
// every width.
constexpr int kBwdTiles = 0, kBwdRegisters = 1;

extern "C" int ddm_flash_bwd(const void* q, const void* k, const void* v, int ld, const void* o,
                             const void* dout, const void* lse, void* dsum, void* dqkv, int B,
                             int N, int H, int Dh, float scale, int design, void* stream) {
  using namespace ddm;
  const cudaStream_t s = (cudaStream_t)stream;
  if (design == kBwdRegisters || design < 0) {
    switch (Dh) {
      case 4:
      case 8:
      case 16:
        return (int)launch_bwd_regs<kNarrow>(q, k, v, ld, o, dout, lse, dsum, dqkv, B, N, H, Dh,
                                             scale, s);
      case 32:
        return (int)launch_bwd_regs<32>(q, k, v, ld, o, dout, lse, dsum, dqkv, B, N, H, Dh, scale,
                                        s);
      case 64:
        return (int)launch_bwd_regs<64>(q, k, v, ld, o, dout, lse, dsum, dqkv, B, N, H, Dh, scale,
                                        s);
      case 128:
        return (int)launch_bwd_regs<128>(q, k, v, ld, o, dout, lse, dsum, dqkv, B, N, H, Dh,
                                         scale, s);
#define DDM_BWD_WIDE_REGS(W)                                                                    \
      case W:                                                                                   \
        return (int)launch_bwd_wide_regs<W>(q, k, v, ld, o, dout, lse, dsum, dqkv, B, N, H, scale, \
                                            s);
      DDM_FLASH_WIDTHS(DDM_BWD_WIDE_REGS)
#undef DDM_BWD_WIDE_REGS
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (design != kBwdTiles) return (int)cudaErrorInvalidValue;
  switch (Dh) {
    case 4:
    case 8:
    case 16:
      return (int)launch_bwd<kNarrow>(q, k, v, ld, o, dout, lse, dsum, dqkv, B, N, H, Dh, scale,
                                      s);
    case 32:
      return (int)launch_bwd<32>(q, k, v, ld, o, dout, lse, dsum, dqkv, B, N, H, Dh, scale, s);
    case 64:
      return (int)launch_bwd<64>(q, k, v, ld, o, dout, lse, dsum, dqkv, B, N, H, Dh, scale, s);
    case 128:
      return (int)launch_bwd<128>(q, k, v, ld, o, dout, lse, dsum, dqkv, B, N, H, Dh, scale, s);
#define DDM_BWD_WIDE(W) \
    case W: return (int)launch_bwd_wide<W>(q, k, v, ld, o, dout, lse, dsum, dqkv, B, N, H, scale, s);
    DDM_FLASH_WIDTHS(DDM_BWD_WIDE)
#undef DDM_BWD_WIDE
    default: return (int)cudaErrorInvalidValue;
  }
}
