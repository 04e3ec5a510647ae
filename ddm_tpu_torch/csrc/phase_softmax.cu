// X1, the phase-batched attention cores: the counterparts of
// tools/exp_phase_softmax.py's `_blk_fwd_kernel_phase` (X1f) and
// `_blk_bwd_kernel_phase` (X1b), an experiment. The TPU bodies restructure
// each pack's attention into coarse phases: every head's Q K^T into one
// stacked fp32 scratch, ONE softmax pass over the stack, then every head's
// P V (and, backward, dv, dP, one stacked dS pass, dq and dk), so that its
// scheduler sees one pack's matrix-unit phase independent of another's
// vector phase. The JAX package kept its per-head kernels (K2f, K2b), and so
// does the port: no model path calls these.
//
// Here one block takes one image's query tile over all H heads (X1f), or
// one image's group of G heads (X1b), and runs the tool's phases over the
// group's stack. Each head's products are the production cores' tiles
// (attention_tiles.cuh) over the same depth slices in the same order, and
// the stacked softmax and dS passes are the production row passes over more
// rows, so X1f's output is csrc/attention.cu `attention_core_kernel`'s
// (resident) bit for bit and X1b's att, dq, dk and dv are the one-block
// `attention_core_bwd_kernel`'s. The third TPU body,
// `_blk_bwd_kernel_persist`, is the production `_blk_bwd_kernel` line for
// line: its counterpart is the port's K2b, and no kernel here.
//
// What bounds them on the H100: the same bytes as the production cores (q,
// k, v read once, the outputs written once; ~0.12 ms forward, ~0.24 ms
// backward at DiT-S/4's training shape), but the stack takes shared memory
// that the per-head cores spend on more blocks in flight: X1f at N 64, Dh 64
// holds H x QT x 68 fp32 scores and H x QT x 72 bf16 probabilities (94 KB at
// H 6, QT 32; 174 KB at H 12), two blocks or one an SM where the production
// core runs eight. X1b keeps each head's fp32 P and dP and its bf16 P (44 KB
// a head at N = Dh = 64) for all G heads, and passes the operands through
// two N-row tiles, reloaded (from L2) in each phase: G = 4 heads at most
// (195 KB), so DiT-S/4's six heads run as groups of 1, 2 or 3. The stack is
// the experiment, so the design keeps it and reports its time.
//
// Shapes (phase_takes): whole images of 16 <= N <= 64 tokens (N % 16 ==
// 0), heads of Dh % 8 == 0 up to 64, at most 12 of them: DiT-S/4's and
// DiT-B/4's at N 64. The widest such layouts fit (static_asserts below).
#include "attention_tiles.cuh"

namespace ddm {
namespace {

constexpr int kPhaseMaxTokens = 64, kPhaseMaxHead = 64, kPhaseMaxHeads = 12;

// X1f's shared memory: one head's Q tile and K (then V) tile, and the
// stacked fp32 scores and bf16 probabilities of all H heads.
constexpr size_t phase_core_smem(int N, int Dh, int H, int QT) {
  const int DP = (Dh + kFrag - 1) / kFrag * kFrag, CLD = DP + kPadH;
  const int SLD = (N > DP ? N : DP) + kPadF;
  return (size_t)(QT + N) * CLD * sizeof(bf16) + (size_t)H * QT * SLD * sizeof(float) +
         (size_t)H * QT * (N + kPadH) * sizeof(bf16);
}

// X1b's: two N-row operand tiles, and per head of the group its fp32 P and
// dP and its bf16 P.
constexpr size_t phase_bwd_smem(int N, int Dh, int G) {
  const int DP = (Dh + kFrag - 1) / kFrag * kFrag, QLD = DP + kPadH;
  const int SLD = (N > DP ? N : DP) + kPadF;
  return (size_t)2 * N * QLD * sizeof(bf16) +
         (size_t)G * ((size_t)2 * N * SLD * sizeof(float) + (size_t)N * (N + kPadH) * sizeof(bf16));
}

static_assert(phase_core_smem(kPhaseMaxTokens, kPhaseMaxHead, kPhaseMaxHeads, 32) <= kMaxSmem,
              "X1f's widest stack must fit a block");
static_assert(phase_bwd_smem(kPhaseMaxTokens, kPhaseMaxHead, 1) <= kMaxSmem,
              "X1b's one-head group must fit a block");

bool phase_takes(int N, int Dh, int H) {
  return N % 16 == 0 && N >= 16 && N <= kPhaseMaxTokens && Dh % 8 == 0 && Dh > 0 &&
         Dh <= kPhaseMaxHead && H >= 1 && H <= kPhaseMaxHeads;
}

// X1f: block (b, t) writes rows [t QT, (t + 1) QT) of image b, all heads.
// Phase 1: S_h = Q_h K_h^T for every head into the stack; phase 2: one
// softmax pass over the H QT stacked rows; phase 3: O_h = P_h V_h for every
// head (into S_h's rows, dead after the softmax), rounded and stored.
__global__ void __launch_bounds__(kThreads)
phase_core_kernel(Heads in, bf16* __restrict__ out, int N, int H, int Dh, float scale, int QT) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int D = H * Dh, DP = padded(Dh);
  const int CLD = DP + kPadH, SLD = max(N, DP) + kPadF, PLD = N + kPadH;
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* KV = Qs + QT * CLD;
  float* S = reinterpret_cast<float*>(KV + N * CLD);  // H x (QT, SLD): scores, then outputs
  bf16* P = reinterpret_cast<bf16*>(S + H * QT * SLD);  // H x (QT, PLD)

  const int b = blockIdx.x, r0 = blockIdx.y * QT;
  for (int h = 0; h < H; ++h) {
    load_cols(Qs, CLD, in.row(in.q, b, N, r0, h, Dh), in.ld, QT, 0, DP, Dh);
    load_cols(KV, CLD, in.row(in.k, b, N, 0, h, Dh), in.ld, N, 0, DP, Dh);
    __syncthreads();
    mma_tiles<false, true, false>(Qs, CLD, KV, CLD, S + h * QT * SLD, SLD, QT, N, DP);
    __syncthreads();
  }
  softmax_rows(S, SLD, P, PLD, H * QT, N, scale, false, nullptr);
  __syncthreads();
  bf16* o = out + ((size_t)b * N + r0) * D;
  for (int h = 0; h < H; ++h) {
    load_cols(KV, CLD, in.row(in.v, b, N, 0, h, Dh), in.ld, N, 0, DP, Dh);
    __syncthreads();
    float* O = S + h * QT * SLD;
    mma_tiles<false, false, false>(P + h * QT * PLD, PLD, KV, CLD, O, SLD, QT, DP, N);
    __syncthreads();
    store_head(o + h * Dh, D, O, SLD, QT, Dh);
  }
}

// X1b: block b (H / G) + j takes heads [j G, (j + 1) G) of image b, all N
// rows, in the tool's five phases: S for each head; one stacked softmax
// (P kept in fp32); dv = Pb^T dO, att = Pb V and dP = dO V^T for each head;
// one stacked dS pass; dq = dS K and dk = dS^T Q for each head. Writes att
// and the thirds of dqkv, as the one-block core does.
__global__ void __launch_bounds__(kThreads)
phase_core_bwd_kernel(Heads in, const bf16* __restrict__ datt, bf16* __restrict__ att,
                      DHeads out, int N, int H, int Dh, float scale, int G) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int D = H * Dh, DP = padded(Dh);
  const int QLD = DP + kPadH, SLD = max(N, DP) + kPadF, PLD = N + kPadH;
  bf16* A = reinterpret_cast<bf16*>(smem);               // Q, dO, then K
  bf16* Bt = A + N * QLD;                                // K, V, then Q
  float* P = reinterpret_cast<float*>(Bt + N * QLD);     // G x (N, SLD): fp32 P, later dq
  float* F = P + G * N * SLD;                            // G x (N, SLD): dv, att, dP, then dk
  bf16* Pb = reinterpret_cast<bf16*>(F + G * N * SLD);   // G x (N, PLD): bf16 P, then dS

  const int groups = H / G, b = blockIdx.x / groups, h0 = (blockIdx.x % groups) * G;
  const bf16* dO = datt + (size_t)b * N * D;
  for (int g = 0; g < G; ++g) {  // phase 1: S = Q K^T
    const int h = h0 + g;
    load_head(A, QLD, in.row(in.q, b, N, 0, h, Dh), in.ld, N, Dh);
    load_head(Bt, QLD, in.row(in.k, b, N, 0, h, Dh), in.ld, N, Dh);
    __syncthreads();
    mma_tiles<false, true, false>(A, QLD, Bt, QLD, P + g * N * SLD, SLD, N, N, DP);
    __syncthreads();
  }
  softmax_rows(P, SLD, Pb, PLD, G * N, N, scale, true, nullptr);  // phase 2
  __syncthreads();
  for (int g = 0; g < G; ++g) {  // phase 3: dv, att, dP
    const int h = h0 + g;
    float* Fg = F + g * N * SLD;
    const bf16* Pbg = Pb + g * N * PLD;
    load_head(A, QLD, dO + h * Dh, D, N, Dh);
    load_head(Bt, QLD, in.row(in.v, b, N, 0, h, Dh), in.ld, N, Dh);
    __syncthreads();
    mma_tiles<true, false, false>(Pbg, PLD, A, QLD, Fg, SLD, N, DP, N);  // dv = Pb^T dO
    __syncthreads();
    store_head(out.row(out.v, b, N, 0, h, Dh), out.ld, Fg, SLD, N, Dh);
    __syncthreads();
    mma_tiles<false, false, false>(Pbg, PLD, Bt, QLD, Fg, SLD, N, DP, N);  // att = Pb V
    __syncthreads();
    store_head(att + (size_t)b * N * D + h * Dh, D, Fg, SLD, N, Dh);
    __syncthreads();
    mma_tiles<false, true, false>(A, QLD, Bt, QLD, Fg, SLD, N, N, DP);  // dP = dO V^T
    __syncthreads();
  }
  ds_rows(P, F, SLD, Pb, PLD, G * N, N, scale, nullptr);  // phase 4
  __syncthreads();
  for (int g = 0; g < G; ++g) {  // phase 5: dq, dk
    const int h = h0 + g;
    float* Pg = P + g * N * SLD;
    float* Fg = F + g * N * SLD;
    const bf16* Pbg = Pb + g * N * PLD;
    load_head(A, QLD, in.row(in.k, b, N, 0, h, Dh), in.ld, N, Dh);
    load_head(Bt, QLD, in.row(in.q, b, N, 0, h, Dh), in.ld, N, Dh);
    __syncthreads();
    mma_tiles<false, false, false>(Pbg, PLD, A, QLD, Pg, SLD, N, DP, N);  // dq = dS K
    mma_tiles<true, false, false>(Pbg, PLD, Bt, QLD, Fg, SLD, N, DP, N);  // dk = dS^T Q
    __syncthreads();
    store_head(out.row(out.q, b, N, 0, h, Dh), out.ld, Pg, SLD, N, Dh);
    store_head(out.row(out.k, b, N, 0, h, Dh), out.ld, Fg, SLD, N, Dh);
  }
}

// X1f's query tile: 32 rows where they divide N, else 16.
int phase_rows(int N) { return N % 32 == 0 ? 32 : 16; }

}  // namespace
}  // namespace ddm

// X1's plan at (N, Dh, H): plan[0] = X1f's query tile QT, plan[1] = the
// most heads a backward group holds, plan[2] = X1b's group, the largest such
// G dividing H, plan[3] and plan[4] = X1f's and X1b's (at plan[2])
// shared-memory bytes. Returns cudaErrorInvalidValue where X1 does not take
// the shape.
extern "C" int ddm_attention_phase_plan(int N, int Dh, int H, int* plan) {
  using namespace ddm;
  if (!phase_takes(N, Dh, H)) return (int)cudaErrorInvalidValue;
  int most = 1;
  while (phase_bwd_smem(N, Dh, most + 1) <= kMaxSmem) ++most;
  int G = std::min(most, H);
  while (H % G) --G;
  plan[0] = phase_rows(N);
  plan[1] = most;
  plan[2] = G;
  plan[3] = (int)phase_core_smem(N, Dh, H, plan[0]);
  plan[4] = (int)phase_bwd_smem(N, Dh, G);
  return 0;
}

// X1f: the (B, N, H*Dh) attention output of q, k and v given as (B, N,
// H*Dh) rows of stride ld (the thirds of a [q | k | v] buffer, ld = 3D).
extern "C" int ddm_phase_attention_core(const void* q, const void* k, const void* v, int ld,
                                        void* out, int B, int N, int H, int Dh, float scale,
                                        void* stream) {
  using namespace ddm;
  if (!phase_takes(N, Dh, H)) return (int)cudaErrorInvalidValue;
  const int QT = phase_rows(N);
  const Heads in{(const bf16*)q, (const bf16*)k, (const bf16*)v, ld};
  return (int)launch(phase_core_kernel, dim3(B, N / QT), phase_core_smem(N, Dh, H, QT),
                     (cudaStream_t)stream, in, (bf16*)out, N, H, Dh, scale, QT);
}

// X1b at groups of G heads (G divides H, its stack fits): att = bf16(P V)
// and dq, dk, dv into the thirds of the (B, N, 3D) dqkv, for the cotangent
// dout of the core over q, k and v (rows of stride ld).
extern "C" int ddm_phase_attention_core_bwd(const void* q, const void* k, const void* v, int ld,
                                            const void* dout, void* att, void* dqkv, int B, int N,
                                            int H, int Dh, float scale, int G, void* stream) {
  using namespace ddm;
  if (!phase_takes(N, Dh, H) || G < 1 || H % G || phase_bwd_smem(N, Dh, G) > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  const Heads in{(const bf16*)q, (const bf16*)k, (const bf16*)v, ld};
  bf16* d = (bf16*)dqkv;
  const int D = H * Dh;
  const DHeads out{d, d + D, d + 2 * D, 3 * D};
  return (int)launch(phase_core_bwd_kernel, dim3(B * (H / G)), phase_bwd_smem(N, Dh, G),
                     (cudaStream_t)stream, in, (const bf16*)dout, (bf16*)att, out, N, H, Dh,
                     scale, G);
}
