// A whole pre-LN DiT block forward in one kernel (X2f):
//   a = x + proj(MHA(qkv(LN1 x))),  out = a + W2 gelu(W1 LN2 a + b1) + b2,
// over (B, N, D) tokens, `a` kept in shared memory between the halves.
//
// Replaces tools/exp_whole_block.py `_whole_fwd_kernel` (line 45), an
// experiment: the JAX package keeps the attention + MLP half-block pair
// because the merged kernel ran 3% slower over an 8-block chain on the TPU,
// and the port likewise runs the pair (K2f then K1f: gemm.cu and
// attention.cu) on every path. This kernel is the experiment's other arm,
// measured by scripts/torch_exp_whole_block.py; nothing in the models calls
// it.
//
// Its output is the pair's, bit for bit: `a` is rounded to bf16 where the
// pair writes it, and every product runs the pair's arithmetic. The LN
// prologues are ln_gemm's (one warp a row, lane-strided sums, two-pass
// variance, eps 1e-6, y = bf16(xhat * scale + bias)); each 16 x 16 output
// tile of every product starts from zero and takes its 16-deep WMMA slices
// in increasing depth, as ln_gemm_kernel, gemm_residual_kernel and the
// attention core do (which warp holds a tile does not change its bits);
// the epilogues are theirs: qkv = bf16(acc + b), att = bf16(P V), a =
// bf16(x + (acc + b)), g = bf16(gelu(acc + b1)) with the exact erf, out =
// bf16(a + (acc + b2)); the core is attention.cu's (fp32 scores, the row
// softmax p = exp(s scale - max) / sum, bf16(p), P V in fp32).
//
// Tiling: one block per 64 rows (64 / N whole images, N <= 64), 8 warps.
//   1. LN1 of the block's rows into a bf16 panel (64 x D);
//   2. head by head: that head's q, k and v columns of the qkv product
//      (tiles of 64 columns over W_qkv's rows [q_h | k_h | v_h]) into
//      shared memory, then the core per image, its output into an att panel;
//      qkv is never held whole;
//   3. the projection with the residual into `a`, which replaces the LN1
//      panel; LN2 of `a` into the att panel's place;
//   4. the MLP over the hidden axis in chunks of 64: each chunk's g tile
//      (64 x 64, bf16) feeds W2's product at once, whose fp32 fragments stay
//      in registers across the chunks (12 a warp at D 384: 96 registers),
//      so the (T, F) hidden activation never leaves the chip;
//   5. out = a + (acc + b2).
// Shared memory at DiT-S/4 (D 384, Dh 64, N 64) is 160 KB, one block an SM.
//
// What bounds it on the H100: at (B 256, N 64, D 384, F 1536) the block is
// 59.5 GFLOP of bf16 products over ~25 MB of x and out and ~4 MB of
// weights, so the tensor cores are the bound (0.060 ms). The pair moves the
// (T, 3D) qkv, the (T, D) att, `a` and the (T, F) hidden activation through
// device memory; this kernel moves none of them, but its 256 blocks of 160
// KB fill the card's 132 SMs in two uneven waves and every weight tile is
// reloaded per block; wgmma and TMA are later work, as for the pair.
#include "common.cuh"

namespace ddm {
namespace {

constexpr int kRows = 64;        // rows of a block
constexpr int kThreads = 256;    // 8 warps: 4 bands of 16 rows x 2 halves of 32 columns
constexpr int kWarps = kThreads / 32;
constexpr int TN = 64;           // output columns of a product's tile
constexpr int BK = 64;           // depth chunk of a weight tile
constexpr int WLD = BK + kPadH;  // weight tile stride (64 rows of W x 64 depth)
constexpr int CLD = TN + kPadF;  // fp32 tile stride
constexpr int HLD = TN + kPadH;  // the bf16 g tile's stride
constexpr size_t kMaxSmem = 232448;
constexpr int kMaxDh = 128;  // the widest head a block holds beside its two panels
constexpr float kLnEps = 1e-6f;
constexpr float kInvSqrt2 = 0.70710678118654752440f;

struct Layout {
  size_t p1, p2, qkv, s, pb, ws, total;
};

// Byte offsets of the shared regions: P1 (LN1 y, then a) and P2 (att, then
// LN2 y), 64 x (D + 8) bf16 each; q, k, v of one head (3 x 64 x (Dh + 8)
// bf16; later the g tile); the fp32 scores and product tiles (64 x max(N,
// Dh, 64) + 4); bf16 P (64 x (N + 8)); one weight tile. Every size is a
// multiple of 128 bytes.
__host__ __device__ constexpr Layout layout(int N, int D, int Dh) {
  Layout l{};
  l.p1 = 0;
  l.p2 = l.p1 + (size_t)kRows * (D + kPadH) * sizeof(bf16);
  l.qkv = l.p2 + (size_t)kRows * (D + kPadH) * sizeof(bf16);
  l.s = l.qkv + (size_t)3 * kRows * (Dh + kPadH) * sizeof(bf16);
  const int sw = (N > Dh ? N : Dh) > TN ? (N > Dh ? N : Dh) : TN;
  l.pb = l.s + (size_t)kRows * (sw + kPadF) * sizeof(float);
  l.ws = l.pb + (size_t)kRows * (N + kPadH) * sizeof(bf16);
  l.total = l.ws + (size_t)TN * WLD * sizeof(bf16);
  return l;
}

// Every region grows with N, D and Dh, so the widest shape `takes` admits
// (N 64, D 384, Dh 128: 200 KB) bounds them all. The next head width, Dh
// 192 at D 384, takes 234 KB at N 16 and does not fit.
static_assert(layout(kRows, 384, kMaxDh).total <= kMaxSmem,
              "X2f's widest layout must fit a block's shared memory");

// One 64 x 64 output tile of A (64 rows, stride lda, depth K in shared
// memory) times the transpose of 64 weight rows row_of(j) (depth K, row
// stride ldw; rows j >= nrows are zero), streamed through Ws in 64-deep
// chunks: warp (wm, wn) accumulates rows [16 wm, +16) x columns [32 wn, +32)
// into acc[0..1], its 16-deep slices in increasing depth from zero.
template <class RowOf>
__device__ __forceinline__ void tile_product(FragC (&acc)[2], const bf16* As, int lda,
                                             const bf16* __restrict__ w, int ldw, RowOf row_of,
                                             int nrows, int K, bf16* Ws) {
  const int warp = threadIdx.x / 32, wm = warp / 2, wn = warp % 2;
  wmma::fill_fragment(acc[0], 0.0f);
  wmma::fill_fragment(acc[1], 0.0f);
  constexpr int kVec = BK / 8;
  for (int k0 = 0; k0 < K; k0 += BK) {
    __syncthreads();
    for (int i = threadIdx.x; i < TN * kVec; i += kThreads) {
      const int r = i / kVec, c = (i % kVec) * 8;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (r < nrows) v = *reinterpret_cast<const uint4*>(w + (size_t)row_of(r) * ldw + k0 + c);
      *reinterpret_cast<uint4*>(Ws + r * WLD + c) = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += kFrag) {
      FragA a;
      wmma::load_matrix_sync(a, As + wm * kFrag * lda + k0 + kk, lda);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        FragBCol bm;
        wmma::load_matrix_sync(bm, Ws + (wn * 32 + j * kFrag) * WLD + kk, WLD);
        wmma::mma_sync(acc[j], a, bm, acc[j]);
      }
    }
  }
}

// A warp's two fragments into the fp32 tile Cs (64 x 64, stride CLD).
__device__ __forceinline__ void store_tile(float* Cs, FragC (&acc)[2]) {
  const int warp = threadIdx.x / 32, wm = warp / 2, wn = warp % 2;
#pragma unroll
  for (int j = 0; j < 2; ++j)
    wmma::store_matrix_sync(Cs + wm * kFrag * CLD + wn * 32 + j * kFrag, acc[j], CLD,
                            wmma::mem_row_major);
}

// ln_gemm's prologue: y = bf16(LN(src row)) for the 64 rows of a panel
// (stride ld, D columns), one warp a row; src and dst may be one panel.
__device__ __forceinline__ void layer_norm_rows(const bf16* src, bf16* dst, int ld, int D,
                                                const float* __restrict__ scale,
                                                const float* __restrict__ bias) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < kRows; r += kWarps) {
    const bf16* row = src + r * ld;
    bf16* out = dst + r * ld;
    float s = 0.f;
    for (int c = lane; c < D; c += 32) s += __bfloat162float(row[c]);
    const float mu = warp_sum(s) / D;
    float q = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float d = __bfloat162float(row[c]) - mu;
      q += d * d;
    }
    const float inv = rsqrtf(warp_sum(q) / D + kLnEps);
    for (int c = lane; c < D; c += 32) {
      const float xhat = (__bfloat162float(row[c]) - mu) * inv;
      out[c] = __float2bfloat16(xhat * scale[c] + bias[c]);
    }
  }
}

// attention.cu's mma_tiles (C = A B^T or A B over depth K, one 16 x 16 tile
// per warp at a time, slices in increasing k, from zero) on 8 warps.
template <bool B_T>
__device__ void core_tiles(const bf16* A, int lda, const bf16* B, int ldb, float* C, int ldc,
                           int M, int Nc, int K) {
  const int warp = threadIdx.x / 32, nt = Nc / kFrag;
  for (int t = warp; t < (M / kFrag) * nt; t += kWarps) {
    const int ti = t / nt, tj = t % nt;
    float* c = C + ti * kFrag * ldc + tj * kFrag;
    FragC acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int kk = 0; kk < K; kk += kFrag) {
      FragA a;
      wmma::load_matrix_sync(a, A + ti * kFrag * lda + kk, lda);
      if constexpr (B_T) {
        FragBCol bm;
        wmma::load_matrix_sync(bm, B + tj * kFrag * ldb + kk, ldb);
        wmma::mma_sync(acc, a, bm, acc);
      } else {
        FragBRow bm;
        wmma::load_matrix_sync(bm, B + kk * ldb + tj * kFrag, ldb);
        wmma::mma_sync(acc, a, bm, acc);
      }
    }
    wmma::store_matrix_sync(c, acc, ldc, wmma::mem_row_major);
  }
}

// attention.cu's softmax_rows without the kept P and the saved statistics.
__device__ void softmax_rows(float* S, int sld, bf16* Pb, int pld, int rows, int N,
                             float scale) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < rows; r += kWarps) {
    float* srow = S + r * sld;
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
    for (int c = lane; c < N; c += 32) Pb[r * pld + c] = __float2bfloat16(srow[c] / sum);
  }
}

template <int ND>  // D / 64
__global__ void __launch_bounds__(kThreads, 1)
whole_block_kernel(const bf16* __restrict__ x, const float* __restrict__ s1,
                   const float* __restrict__ b1, const bf16* __restrict__ wqkv,
                   const float* __restrict__ bqkv, const bf16* __restrict__ wproj,
                   const float* __restrict__ bproj, const float* __restrict__ s2,
                   const float* __restrict__ b2, const bf16* __restrict__ w1,
                   const float* __restrict__ bb1, const bf16* __restrict__ w2,
                   const float* __restrict__ bb2, bf16* __restrict__ out, int B, int N, int H,
                   int F, float scale) {
  constexpr int D = ND * TN;
  extern __shared__ __align__(128) unsigned char smem[];
  const int Dh = D / H, PLD = D + kPadH, QLD = Dh + kPadH, PBLD = N + kPadH;
  const Layout L = layout(N, D, Dh);
  bf16* P1 = reinterpret_cast<bf16*>(smem + L.p1);
  bf16* P2 = reinterpret_cast<bf16*>(smem + L.p2);
  bf16* Qs = reinterpret_cast<bf16*>(smem + L.qkv);
  bf16* Ks = Qs + kRows * QLD;
  bf16* Vs = Ks + kRows * QLD;
  bf16* Hs = Qs;  // the g tile, once the attention half is done
  float* S = reinterpret_cast<float*>(smem + L.s);
  float* Cs = S;  // product tiles between the cores
  bf16* Pb = reinterpret_cast<bf16*>(smem + L.pb);
  bf16* Ws = reinterpret_cast<bf16*>(smem + L.ws);
  const int SLD = (N > Dh ? N : Dh) + kPadF;

  const int G = kRows / N;  // whole images a block holds
  const int img0 = blockIdx.x * G, imgs = min(G, B - img0);
  const int row0 = img0 * N, rows = imgs * N;

  // 1. x's rows into P1 (rows past the block's images zero), LN1 in place
  constexpr int kVecD = D / 8;
  for (int i = threadIdx.x; i < kRows * kVecD; i += kThreads) {
    const int r = i / kVecD, c = (i % kVecD) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r < rows) v = *reinterpret_cast<const uint4*>(x + (size_t)(row0 + r) * D + c);
    *reinterpret_cast<uint4*>(P1 + r * PLD + c) = v;
  }
  __syncthreads();
  layer_norm_rows(P1, P1, PLD, D, s1, b1);

  // 2. head by head: its q, k, v columns, then the core per image into P2
  for (int h = 0; h < H; ++h) {
    for (int t0 = 0; t0 < 3 * Dh; t0 += TN) {
      const auto row_of = [=](int j) { return ((t0 + j) / Dh) * D + h * Dh + (t0 + j) % Dh; };
      FragC acc[2];
      tile_product(acc, P1, PLD, wqkv, D, row_of, min(TN, 3 * Dh - t0), D, Ws);
      store_tile(Cs, acc);
      __syncthreads();
      for (int i = threadIdx.x; i < kRows * TN; i += kThreads) {
        const int r = i / TN, j = t0 + i % TN;
        if (j >= 3 * Dh) continue;
        const int part = j / Dh, c = j % Dh;
        Qs[part * kRows * QLD + r * QLD + c] =
            __float2bfloat16(Cs[r * CLD + i % TN] + bqkv[part * D + h * Dh + c]);
      }
    }
    for (int g = 0; g < imgs; ++g) {
      const int gr = g * N;
      __syncthreads();  // q, k, v written / the previous image's output stored
      core_tiles<true>(Qs + gr * QLD, QLD, Ks + gr * QLD, QLD, S, SLD, N, N, Dh);  // S = Q K^T
      __syncthreads();
      softmax_rows(S, SLD, Pb, PBLD, N, N, scale);
      __syncthreads();
      core_tiles<false>(Pb, PBLD, Vs + gr * QLD, QLD, S, SLD, N, Dh, N);  // O = P V
      __syncthreads();
      for (int i = threadIdx.x; i < N * Dh / 2; i += kThreads) {
        const int r = i / (Dh / 2), c = 2 * (i % (Dh / 2));
        *reinterpret_cast<__nv_bfloat162*>(P2 + (gr + r) * PLD + h * Dh + c) =
            __floats2bfloat162_rn(S[r * SLD + c], S[r * SLD + c + 1]);
      }
    }
    __syncthreads();  // the core's reads of q, k, v and S done
  }

  // 3. a = bf16(x + (att Wproj^T + bproj)) into P1, then LN2 of a into P2
  for (int n0 = 0; n0 < D; n0 += TN) {
    FragC acc[2];
    tile_product(acc, P2, PLD, wproj, D, [=](int j) { return n0 + j; }, TN, D, Ws);
    store_tile(Cs, acc);
    __syncthreads();
    for (int i = threadIdx.x; i < kRows * TN / 2; i += kThreads) {
      const int r = i / (TN / 2), c = 2 * (i % (TN / 2)), col = n0 + c;
      __nv_bfloat162 v = __floats2bfloat162_rn(0.f, 0.f);
      if (r < rows) {
        const __nv_bfloat162 x2 =
            *reinterpret_cast<const __nv_bfloat162*>(x + (size_t)(row0 + r) * D + col);
        v = __floats2bfloat162_rn(__low2float(x2) + (Cs[r * CLD + c] + bproj[col]),
                                  __high2float(x2) + (Cs[r * CLD + c + 1] + bproj[col + 1]));
      }
      *reinterpret_cast<__nv_bfloat162*>(P1 + r * PLD + col) = v;
    }
  }
  __syncthreads();
  layer_norm_rows(P1, P2, PLD, D, s2, b2);

  // 4. the MLP over hidden chunks of 64; W2's fragments stay in registers
  const int warp = threadIdx.x / 32, wm = warp / 2, wn = warp % 2;
  FragC oacc[ND][2];
#pragma unroll
  for (int t = 0; t < ND; ++t) {
    wmma::fill_fragment(oacc[t][0], 0.0f);
    wmma::fill_fragment(oacc[t][1], 0.0f);
  }
  for (int f0 = 0; f0 < F; f0 += TN) {
    FragC acc[2];
    tile_product(acc, P2, PLD, w1, D, [=](int j) { return f0 + j; }, TN, D, Ws);
    store_tile(Cs, acc);
    __syncthreads();
    for (int i = threadIdx.x; i < kRows * TN / 2; i += kThreads) {
      const int r = i / (TN / 2), c = 2 * (i % (TN / 2));
      float v0 = Cs[r * CLD + c] + bb1[f0 + c];
      float v1 = Cs[r * CLD + c + 1] + bb1[f0 + c + 1];
      v0 = 0.5f * v0 * (1.0f + erff(v0 * kInvSqrt2));
      v1 = 0.5f * v1 * (1.0f + erff(v1 * kInvSqrt2));
      *reinterpret_cast<__nv_bfloat162*>(Hs + r * HLD + c) = __floats2bfloat162_rn(v0, v1);
    }
#pragma unroll
    for (int t = 0; t < ND; ++t) {
      __syncthreads();  // g written / the previous W2 tile consumed
      constexpr int kVec = BK / 8;
      for (int i = threadIdx.x; i < TN * kVec; i += kThreads) {
        const int r = i / kVec, c = (i % kVec) * 8;
        *reinterpret_cast<uint4*>(Ws + r * WLD + c) =
            *reinterpret_cast<const uint4*>(w2 + (size_t)(t * TN + r) * F + f0 + c);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; kk += kFrag) {
        FragA a;
        wmma::load_matrix_sync(a, Hs + wm * kFrag * HLD + kk, HLD);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          FragBCol bm;
          wmma::load_matrix_sync(bm, Ws + (wn * 32 + j * kFrag) * WLD + kk, WLD);
          wmma::mma_sync(oacc[t][j], a, bm, oacc[t][j]);
        }
      }
    }
    __syncthreads();  // the g tile and Cs are rewritten by the next chunk
  }

  // 5. out = bf16(a + (acc + b2))
#pragma unroll
  for (int t = 0; t < ND; ++t) {
    __syncthreads();
    store_tile(Cs, oacc[t]);
    __syncthreads();
    for (int i = threadIdx.x; i < rows * TN / 2; i += kThreads) {
      const int r = i / (TN / 2), c = 2 * (i % (TN / 2)), col = t * TN + c;
      const __nv_bfloat162 a2 = *reinterpret_cast<const __nv_bfloat162*>(P1 + r * PLD + col);
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)(row0 + r) * D + col) =
          __floats2bfloat162_rn(__low2float(a2) + (Cs[r * CLD + c] + bb2[col]),
                                __high2float(a2) + (Cs[r * CLD + c + 1] + bb2[col + 1]));
    }
  }
}

// The shapes the kernel takes: whole images of N tokens (N % 16 == 0, N <=
// 64), D in {128, 256, 384} (the register accumulators' instances), head
// widths Dh % 16 == 0 up to kMaxDh (the layout's bound, asserted above),
// F % 64 == 0. ops/whole_block.py `whole_block_takes` states the same terms.
bool takes(int N, int D, int H, int F) {
  if (N < 16 || N > kRows || N % kFrag || H < 1 || D % H || F < TN || F % TN) return false;
  if (D != 128 && D != 256 && D != 384) return false;
  const int Dh = D / H;
  return Dh % kFrag == 0 && Dh <= kMaxDh;
}

template <int ND>
cudaError_t launch(const void* const* p, void* out, int B, int N, int H, int F, float scale,
                   cudaStream_t stream) {
  const size_t smem = layout(N, ND * TN, ND * TN / H).total;
  cudaError_t err = cudaFuncSetAttribute(whole_block_kernel<ND>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int G = kRows / N;
  whole_block_kernel<ND><<<(B + G - 1) / G, kThreads, smem, stream>>>(
      (const bf16*)p[0], (const float*)p[1], (const float*)p[2], (const bf16*)p[3],
      (const float*)p[4], (const bf16*)p[5], (const float*)p[6], (const float*)p[7],
      (const float*)p[8], (const bf16*)p[9], (const float*)p[10], (const bf16*)p[11],
      (const float*)p[12], (bf16*)out, B, N, H, F, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace ddm

// X2f: out (B, N, D) bf16 of x (B, N, D) bf16 through a whole pre-LN block;
// LN parameters and biases fp32, wqkv (3D, D), wproj (D, D), w1 (F, D), w2
// (D, F) bf16 in nn.Linear's layout; scale = Dh^-0.5. Shapes outside
// ddm::takes return cudaErrorInvalidValue.
extern "C" int ddm_whole_block_fwd(const void* x, const void* s1, const void* b1,
                                   const void* wqkv, const void* bqkv, const void* wproj,
                                   const void* bproj, const void* s2, const void* b2,
                                   const void* w1, const void* bb1, const void* w2,
                                   const void* bb2, void* out, int B, int N, int D, int H, int F,
                                   float scale, void* stream) {
  using namespace ddm;
  if (B < 1 || !takes(N, D, H, F)) return (int)cudaErrorInvalidValue;
  const void* p[13] = {x, s1, b1, wqkv, bqkv, wproj, bproj, s2, b2, w1, bb1, w2, bb2};
  const cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 128: return (int)launch<2>(p, out, B, N, H, F, scale, st);
    case 256: return (int)launch<4>(p, out, B, N, H, F, scale, st);
    default: return (int)launch<6>(p, out, B, N, H, F, scale, st);
  }
}
