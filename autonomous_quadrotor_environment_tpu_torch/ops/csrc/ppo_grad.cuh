// Device code shared by the two PPO gradient kernels, `ppo_fused_t.cu`
// (B2, transposed batch) and `ppo_fused.cu` (B3 and B4, row-major batch).
// Both compute, over a minibatch of rows, the clipped-surrogate + value loss
// of the port's `agents.ppo.ppo_loss` under the fixed std and the gradients
// of all 12 ActorCritic leaves (75 -> 128 -> 128 -> 4 tanh actor, -> 1
// critic), with the hand-derived backward and the clip-tie convention
// where(surr1 <= surr2, 1, in_band), in_band strict on both sides. They
// differ only in how a chunk of rows reaches shared memory.
//
// Bound: 277,248 f32 FLOP per row at hidden 128 against 332 bytes of row
// data, so compute bound at every shape the trainer runs: 2.17 ms at the
// bench minibatch (524,288 rows) on the H100's 67 TFLOP/s of f32 CUDA
// cores. Over 99% of the FLOP are in five products of width 128 per head,
// which run here on the tensor cores in 3xTF32, three TF32 products per f32
// product (0.88 ms at the 495 TFLOP/s TF32 peak).
//
// Design, common to both:
//
// * The actor and the critic are independent given the rows, so each CTA
//   serves one head (blockIdx.y); G CTAs per head (about half the SMs) walk
//   the minibatch's chunks of CHUNK = 64 rows with stride G, in order.
// * Weights resident in shared memory: each CTA loads its head's W1 (128 x
//   80, rows padded to 84 floats), one copy of W2 (128 x 128), W3 and the
//   biases once, for its whole walk. The forward and the backward read the
//   one W2 through different fragment mappings.
// * Tensor cores in 3xTF32: each f32 operand x is split into hi = tf32(x)
//   and lo = tf32(x - hi), and a product is lo hi + hi lo + hi hi with f32
//   accumulation (mma.sync m16n8k8), which keeps f32 accuracy; single-pass
//   TF32 would not. Per chunk and head, on 8 warps: the forward X W1^T (K =
//   80, inputs 75-79 zero) and H1 W2^T, each warp a 32 x 32 tile; the data
//   gradient g_h2 W2; the weight gradients g_h2^T H1 and g_h1^T X, K = the
//   chunk's 64 rows. The products through W3 (4 or 1 outputs), the tanh and
//   its derivative and the loss rows stay on the CUDA cores, with accurate
//   tanhf, expf and IEEE division (no fast-math).
// * Gradient accumulators in registers: the running dW2 (128 x 128) and dW1
//   (128 x 80) are MMA accumulator fragments, each warp a 32 x 64 tile of
//   dW2 and a 32 x 40 tile of dW1 (104 floats a thread), for the CTA's whole
//   walk. Each chunk's weight gradient is formed in fresh fragments and
//   then added in, so that the tensor cores' own f32 sums run over one
//   chunk's 64 rows only and the walk's sum is rounded to nearest. dW3 and
//   the bias sums are per-thread sums in shared memory, the loss sums and
//   b3 in the two loss warps' registers. At the end each CTA writes them
//   once to its partial in the workspace (2, G, ACCS), the layout the
//   reductions read.
// * Activations in shared memory, swizzled: X^T (80 x 64), H1 and H2 (64 x
//   128) and W2 hold entry (row, col) at row * width + (col ^ swz(row)), so
//   that the fragment reads along rows and along columns both hit 32
//   distinct banks. H1 is overwritten by g_h1 and H2 by g_h2 in place.
// * Double-buffered inputs: while a chunk computes, the next chunk's obs and
//   aux are copied by cp.async into the second buffer (B2: 16-byte copies of
//   32-env feature rows; B3/B4: 4-byte copies, a row being 300 bytes).
// * A second small kernel sums the G partials of each gradient entry in the
//   order 0..G-1 (no float atomics, so two launches give the same bits) and
//   writes the gradients in the (out, in) layout of `nn.Linear.weight`,
//   biases as (out,); B4's reduction takes the Adam step there.
//
// Shared memory (bytes), one CTA of 256 threads per SM: W1 43,008, W2
// 65,536, W3 2,112, biases 1,040; X^T 2 x 20,480 and aux 2 x 2,048 (two
// buffers); H1 and H2 32,768 each; head outputs 1,024; per-thread sums
// 6,144; source rows 512: 229,968 of the 232,448 a CTA may have.
// Registers: 104 accumulator floats a thread, plus a product's fresh
// fragments (32 or 40) and its operands in hi/lo (20); ptxas (CUDA 12.8)
// gives the B2 kernel 236 and the row-major one 239, with no spills.
//
// Not wgmma: its TF32 form takes B (and A from shared memory) K-major
// only, while the backward reads H1, g_h2 and W2 along the other axis; 3x
// TF32 would need hi and lo copies of every shared operand, which do not
// fit beside the resident weights; and a 64-row chunk is one M tile of a
// serial forward-to-backward chain. So the products run on mma.sync,
// which does not reach the tensor cores' full TF32 rate (only wgmma does).

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "mma_tf32.cuh"

namespace ppo_grad {

constexpr int OBS = 75;
constexpr int K1 = 80;     // OBS padded to a multiple of the MMA depth; inputs 75-79 are zero
constexpr int OBS_P = 76;  // row stride of dW1 in the partial layout
constexpr int H = 128;
constexpr int NA = 4;      // actor outputs; the critic's one output is padded to 4
constexpr int CHUNK = 64;  // rows per chunk
constexpr int THREADS = 256;

// Packed weights of one head (floats), built by the wrapper.
constexpr int P_W1 = 0;                    // [H][K1]  W1 (out, in), inputs 75-79 zero
constexpr int P_W2 = P_W1 + H * K1;        // [H][H]   W2 (out, in)
constexpr int P_W3 = P_W2 + H * H;         // [NA][H]  W3 (out, in), zero rows pad
constexpr int P_B1 = P_W3 + NA * H;
constexpr int P_B2 = P_B1 + H;
constexpr int P_B3 = P_B2 + H;             // [NA], zero pad
constexpr int PACK = P_B3 + NA;

// Gradient accumulators of one head (floats), (out, in) layout: one CTA's
// partial in the workspace.
constexpr int A_W1 = 0;                    // [H][OBS_P]
constexpr int A_W2 = A_W1 + H * OBS_P;     // [H][H]
constexpr int A_W3 = A_W2 + H * H;         // [NA][H]
constexpr int A_B1 = A_W3 + NA * H;
constexpr int A_B2 = A_B1 + H;
constexpr int A_B3 = A_B2 + H;
constexpr int ACC = A_B3 + NA;             // 26,884
constexpr int NMET = 4;                    // actor sum, critic sum, ratio max, pad
constexpr int ACCS = ACC + NMET;

// Shared memory (floats).
constexpr int W1_LD = K1 + 4;              // row strides padded against bank conflicts
constexpr int W3_LD = H + 4;
constexpr int S_W1 = 0;                        // [H][W1_LD]
constexpr int S_W2 = S_W1 + H * W1_LD;         // [H][H] swizzled
constexpr int S_W3 = S_W2 + H * H;             // [NA][W3_LD]
constexpr int S_B1 = S_W3 + NA * W3_LD;        // b1, b2, b3 as in the pack
constexpr int S_B2 = S_B1 + H;
constexpr int S_B3 = S_B2 + H;
constexpr int S_X = S_B3 + NA;                 // [2][K1][CHUNK] swizzled: inputs, transposed
constexpr int S_AUX = S_X + 2 * K1 * CHUNK;    // [2][8][CHUNK]: aux rows 0-6, row 7 live flags
constexpr int S_H1 = S_AUX + 2 * 8 * CHUNK;    // [CHUNK][H] swizzled: h1, then g_h1
constexpr int S_H2 = S_H1 + CHUNK * H;         // [CHUNK][H] swizzled: h2, then g_h2
constexpr int S_GO = S_H2 + CHUNK * H;         // [CHUNK][NA] head outputs, then their gradients
constexpr int S_SUM = S_GO + CHUNK * NA;       // [6][THREADS] per-thread sums: dW3 (4), b2, b1
constexpr int S_ROWS = S_SUM + 6 * THREADS;    // [2][CHUNK] int source rows (row-major loader)
constexpr int SMEM_FLOATS = S_ROWS + 2 * CHUNK;
constexpr int SMEM_BYTES = SMEM_FLOATS * (int)sizeof(float);

// Flat output: the 12 gradient leaves in flax leaf order, (out, in)
// kernels and (out,) biases, then the 3 metrics.
constexpr int O_ACTOR = OBS * H + H + H * H + H + NA * H + NA;  // 26,756
constexpr int O_CRITIC = OBS * H + H + H * H + H + H + 1;       // 26,369
constexpr int O_GRADS = O_ACTOR + O_CRITIC;
constexpr int N_OUT = O_GRADS + 3;

static_assert(ACC % 4 == 0 && PACK % 4 == 0 && ACCS % 4 == 0, "float4 alignment");
static_assert(S_W2 % 4 == 0 && S_W3 % 4 == 0 && S_X % 4 == 0 && S_AUX % 4 == 0 &&
              S_H1 % 4 == 0 && S_H2 % 4 == 0 && S_GO % 4 == 0, "float4 alignment");
static_assert(SMEM_BYTES <= 232448, "more shared memory than a CTA may have");
static_assert(CHUNK == 64 && THREADS == 256 && H == 128 && K1 % 8 == 0 &&
              THREADS == 2 * H && CHUNK * NA == THREADS, "tile mappings assume these");

// The loss's constants: 1/std, the logprob's constant 4 (log std +
// log(2 pi) / 2), the clip band's bounds and 1 / minibatch rows.
struct LossConsts {
  float inv_std, lp_const, lo, hi, inv_n;
};

// What a CTA carries over its walk in registers: its warp's tiles of the
// running dW2 (32 x 64) and dW1 (32 x 40) as MMA accumulator fragments, and
// in the two loss warps (threads < CHUNK) the sums over their rows: the
// head's loss (lane 0), the ratio max (lane 0) and b3's gradient (each lane).
struct Walk {
  float dw2[2][8][4];
  float dw1[2][5][4];
  float actor, critic, rmax, b3[NA];
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void sts4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Forward hidden layer on the (64 rows x 128 units) output, each warp the
// 32 x 32 tile at rows m0 = 32 (warp % 2), units n0 = 32 (warp / 2):
// dst[r][j] = tanh(sum_k A(r, k) B(k, j) + bias[j]), dst swizzled.
template <class VA, class VB>
__device__ __forceinline__ void dense_tanh(const VA& a, const VB& b, int steps,
                                           const float* bias, float* dst) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int m0 = 32 * (warp & 1), n0 = 32 * (warp >> 1);
  float acc[2][4][4];
  zero(acc);
  warp_mma(acc, a, b, steps);
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int j = n0 + 8 * nt + 2 * t;
    const float b0 = bias[j], b1 = bias[j + 1];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = m0 + 16 * mt + g + 8 * hh;
        *reinterpret_cast<float2*>(dst + r * H + (j ^ swz(r))) =
            make_float2(tanhf(acc[mt][nt][2 * hh] + b0), tanhf(acc[mt][nt][2 * hh + 1] + b1));
      }
  }
}

// The head's outputs, one (row, output) per thread, into GO: tanh for the
// actor's mean, linear for the critic.
__device__ __forceinline__ void head_outputs(float* S, int head) {
  const int r = threadIdx.x >> 2, o = threadIdx.x & 3, sw = swz(r);
  const float* h = S + S_H2 + r * H;
  const float* w = S + S_W3 + o * W3_LD;
  float s = 0.f;
#pragma unroll 8
  for (int k = 0; k < H; k += 4) {
    const float4 hv = lds4(h + (k ^ sw)), wv = lds4(w + k);
    s = fmaf(hv.x, wv.x, s);
    s = fmaf(hv.y, wv.y, s);
    s = fmaf(hv.z, wv.z, s);
    s = fmaf(hv.w, wv.w, s);
  }
  s += S[S_B3 + o];
  S[S_GO + r * NA + o] = head == 0 ? tanhf(s) : s;
}

// The loss rows and the gradient at the head's outputs, in place of the
// outputs in GO: two warps, one row a lane. A row whose live flag is 0 is
// padding and adds nothing to the gradients, the sums or the ratio max.
__device__ __forceinline__ void loss_rows(const float* AUX, float* GO, int head,
                                          const LossConsts& c, Walk& w) {
  const int r = threadIdx.x;
  if (r >= CHUNK) return;
  const bool live = AUX[7 * CHUNK + r] != 0.f;
  const float4 out = lds4(GO + r * NA);
  const float mean[NA] = {out.x, out.y, out.z, out.w};
  float go[NA], row;
  if (head == 0) {
    const float old_lp = AUX[4 * CHUNK + r], adv = AUX[6 * CHUNK + r];
    float z[NA], ssq = 0.f;
#pragma unroll
    for (int o = 0; o < NA; ++o) {
      z[o] = (AUX[o * CHUNK + r] - mean[o]) * c.inv_std;
      ssq = fmaf(z[o], z[o], ssq);
    }
    const float lp = -0.5f * ssq - c.lp_const;
    const float ratio = expf(lp - old_lp);
    const bool in_band = ratio > c.lo && ratio < c.hi;
    const float surr1 = ratio * adv;
    const float surr2 = fminf(fmaxf(ratio, c.lo), c.hi) * adv;
    row = live ? -fminf(surr1, surr2) : 0.f;
    const float g_ratio = -c.inv_n * adv * (surr1 <= surr2 ? 1.f : (in_band ? 1.f : 0.f));
    const float g_lp = live ? g_ratio * ratio : 0.f;
#pragma unroll
    for (int o = 0; o < NA; ++o) go[o] = ((g_lp * z[o]) * c.inv_std) * (1.f - mean[o] * mean[o]);
    const float m = warp_max(live ? ratio : 0.f);
    if ((r & 31) == 0) w.rmax = fmaxf(w.rmax, m);
  } else {
    const float verr = live ? mean[0] - AUX[5 * CHUNK + r] : 0.f;
    go[0] = verr * c.inv_n;
    go[1] = go[2] = go[3] = 0.f;
    row = 0.5f * verr * verr;
  }
  sts4(GO + r * NA, make_float4(go[0], go[1], go[2], go[3]));
#pragma unroll
  for (int o = 0; o < NA; ++o) w.b3[o] += go[o];
  const float s = warp_sum(row);
  if ((r & 31) == 0) {
    if (head == 0) w.actor += s; else w.critic += s;
  }
}

// Backward through the output layer, one hidden unit k and half the rows a
// thread: g_h2[r][k] = (sum_o GO[r][o] W3[o][k]) (1 - h2^2) in place of h2;
// its sums of GO[r][o] h2[r][k] (dW3) and of g_h2 (b2) into its own slots.
__device__ __forceinline__ void back_out(float* S) {
  const int k = threadIdx.x & (H - 1), r0 = (threadIdx.x >> 7) * (CHUNK / 2);
  float w3[NA], d3[NA], sb = 0.f;
#pragma unroll
  for (int o = 0; o < NA; ++o) {
    w3[o] = S[S_W3 + o * W3_LD + k];
    d3[o] = 0.f;
  }
  float* H2 = S + S_H2;
  const float* GO = S + S_GO;
#pragma unroll 4
  for (int r = r0; r < r0 + CHUNK / 2; ++r) {
    const float4 go = lds4(GO + r * NA);
    float* p = H2 + r * H + (k ^ swz(r));
    const float h = *p;
    float s = go.x * w3[0];
    s = fmaf(go.y, w3[1], s);
    s = fmaf(go.z, w3[2], s);
    s = fmaf(go.w, w3[3], s);
    const float gh = s * (1.f - h * h);
    *p = gh;
    d3[0] = fmaf(go.x, h, d3[0]);
    d3[1] = fmaf(go.y, h, d3[1]);
    d3[2] = fmaf(go.z, h, d3[2]);
    d3[3] = fmaf(go.w, h, d3[3]);
    sb += gh;
  }
  float* sum = S + S_SUM + threadIdx.x;
#pragma unroll
  for (int o = 0; o < NA; ++o) sum[o * THREADS] += d3[o];
  sum[4 * THREADS] += sb;
}

// dW2[j][i] += sum_r g_h2[r][j] h1[r][i] over the chunk, each warp its 32 x
// 64 tile in two passes of 32 x 32 fresh fragments.
__device__ __forceinline__ void grad_w2(const float* G2, const float* H1, Walk& w) {
  const int warp = threadIdx.x >> 5;
  const int m0 = 32 * (warp >> 1), n0 = 64 * (warp & 1);
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    float part[2][4][4];
    zero(part);
    warp_mma(part, ColsSwz<H>(G2, m0), ColsSwz<H>(H1, n0 + 32 * p), CHUNK / 8);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) w.dw2[mt][4 * p + nt][e] += part[mt][nt][e];
  }
}

// Backward through W2, each warp a 32 x 32 tile: g_h1[r][i] = (sum_j
// g_h2[r][j] W2[j][i]) (1 - h1^2) in place of h1.
__device__ __forceinline__ void back_hidden(const float* G2, const float* W2, float* H1) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int m0 = 32 * (warp & 1), n0 = 32 * (warp >> 1);
  float acc[2][4][4];
  zero(acc);
  warp_mma(acc, RowsSwz<H>(G2, m0), ColsSwz<H>(W2, n0), H / 8);
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = m0 + 16 * mt + g + 8 * hh, i = n0 + 8 * nt + 2 * t;
        float2* p = reinterpret_cast<float2*>(H1 + r * H + (i ^ swz(r)));
        const float2 h = *p;
        *p = make_float2(acc[mt][nt][2 * hh] * (1.f - h.x * h.x),
                         acc[mt][nt][2 * hh + 1] * (1.f - h.y * h.y));
      }
}

// dW1[j][f] += sum_r g_h1[r][j] x[r][f] over the chunk, each warp its 32 x
// 40 tile; then each thread's sum of g_h1 over half the rows of one unit (b1).
__device__ __forceinline__ void grad_w1(float* S, const float* G1, const float* X, Walk& w) {
  const int warp = threadIdx.x >> 5;
  const int m0 = 32 * (warp >> 1), n0 = 40 * (warp & 1);
  float part[2][5][4];
  zero(part);
  warp_mma(part, ColsSwz<H>(G1, m0), RowsSwz<CHUNK>(X, n0), CHUNK / 8);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 5; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) w.dw1[mt][nt][e] += part[mt][nt][e];
  const int k = threadIdx.x & (H - 1), r0 = (threadIdx.x >> 7) * (CHUNK / 2);
  float s = 0.f;
#pragma unroll 8
  for (int r = r0; r < r0 + CHUNK / 2; ++r) s += G1[r * H + (k ^ swz(r))];
  S[S_SUM + 5 * THREADS + threadIdx.x] += s;
}

// A CTA's start: its head's weights (W from the wrapper's pack) into shared
// memory, the zero inputs 75-79 of both input buffers, and zero sums.
__device__ __forceinline__ void init_walk(float* S, const float* __restrict__ W, Walk& w) {
  const int tid = threadIdx.x;
  for (int e = tid; e < H * K1 / 4; e += THREADS) {
    const int j = e / (K1 / 4), f = 4 * (e % (K1 / 4));
    sts4(S + S_W1 + j * W1_LD + f, ld4(W + P_W1 + j * K1 + f));
  }
  for (int e = tid; e < H * H / 4; e += THREADS) {
    const int j = e / (H / 4), i = 4 * (e % (H / 4));
    sts4(S + S_W2 + j * H + (i ^ swz(j)), ld4(W + P_W2 + j * H + i));
  }
  for (int e = tid; e < NA * H / 4; e += THREADS) {
    const int o = e / (H / 4), k = 4 * (e % (H / 4));
    sts4(S + S_W3 + o * W3_LD + k, ld4(W + P_W3 + o * H + k));
  }
  for (int e = tid; e < 2 * H + NA; e += THREADS) S[S_B1 + e] = __ldg(W + P_B1 + e);
  for (int e = tid; e < 2 * (K1 - OBS) * CHUNK; e += THREADS) {
    const int b = e / ((K1 - OBS) * CHUNK), rest = e % ((K1 - OBS) * CHUNK);
    S[S_X + b * K1 * CHUNK + OBS * CHUNK + rest] = 0.f;
  }
  for (int e = tid; e < 6 * THREADS; e += THREADS) S[S_SUM + e] = 0.f;
  zero(w.dw2);
  zero(w.dw1);
  w.actor = w.critic = w.rmax = 0.f;
#pragma unroll
  for (int o = 0; o < NA; ++o) w.b3[o] = 0.f;
}

// One chunk's forward and backward, added into the walk's sums. The caller
// has staged the chunk in input buffer `buf` (X^T and aux, row 7 of aux the
// rows' live flags) and passed a barrier. `next` stages the next chunk in
// the other buffer; it runs once the first layer has read this chunk's X.
template <class Next>
__device__ __forceinline__ void chunk_grad(float* S, int buf, int head, const LossConsts& c,
                                           Walk& w, const Next& next) {
  const float* X = S + S_X + buf * K1 * CHUNK;
  const float* AUX = S + S_AUX + buf * 8 * CHUNK;
  const float* W1 = S + S_W1;
  const float* W2 = S + S_W2;
  float* H1 = S + S_H1;
  float* H2 = S + S_H2;

  // ---- forward
  const int warp = threadIdx.x >> 5, m0 = 32 * (warp & 1), n0 = 32 * (warp >> 1);
  dense_tanh(ColsSwz<CHUNK>(X, m0), RowsPlain<W1_LD>(W1, n0), K1 / 8, S + S_B1, H1);
  __syncthreads();
  next();
  dense_tanh(RowsSwz<H>(H1, m0), RowsSwz<H>(W2, n0), H / 8, S + S_B2, H2);
  __syncthreads();
  head_outputs(S, head);
  __syncthreads();

  // ---- loss rows, then backward
  loss_rows(AUX, S + S_GO, head, c, w);
  __syncthreads();
  back_out(S);                 // H2 <- g_h2
  __syncthreads();
  grad_w2(H2, H1, w);
  __syncthreads();
  back_hidden(H2, W2, H1);     // H1 <- g_h1
  __syncthreads();
  grad_w1(S, H1, X, w);
}

// The walk's sums into the CTA's partial in the workspace (2, G, ACCS).
__device__ __forceinline__ void write_partial(float* S, float* work, int G, int head, Walk& w) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  float* out = work + ((size_t)head * G + blockIdx.x) * ACCS;
  {
    const int m0 = 32 * (warp >> 1), n2 = 64 * (warp & 1), n1 = 40 * (warp & 1);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int j = m0 + 16 * mt + g + 8 * hh;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
          *reinterpret_cast<float2*>(out + A_W2 + j * H + n2 + 8 * nt + 2 * t) =
              make_float2(w.dw2[mt][nt][2 * hh], w.dw2[mt][nt][2 * hh + 1]);
#pragma unroll
        for (int nt = 0; nt < 5; ++nt) {
          const int f = n1 + 8 * nt + 2 * t;
          if (f < OBS_P)
            *reinterpret_cast<float2*>(out + A_W1 + j * OBS_P + f) =
                make_float2(w.dw1[mt][nt][2 * hh], w.dw1[mt][nt][2 * hh + 1]);
        }
      }
  }
  __syncthreads();  // every thread's sums in S_SUM are final; H1 is free
  const float* sum = S + S_SUM;
  for (int e = tid; e < NA * H; e += THREADS) {
    const int o = e / H, k = e % H;
    out[A_W3 + e] = sum[o * THREADS + k] + sum[o * THREADS + H + k];
  }
  if (tid < H) {
    out[A_B2 + tid] = sum[4 * THREADS + tid] + sum[4 * THREADS + H + tid];
    out[A_B1 + tid] = sum[5 * THREADS + tid] + sum[5 * THREADS + H + tid];
  }
  // The loss warps' sums: warp 1's to shared memory, added to warp 0's.
  float* x = S + S_H1;
  float b3[NA];
  if (tid < CHUNK) {
#pragma unroll
    for (int o = 0; o < NA; ++o) b3[o] = warp_sum(w.b3[o]);
    if (tid == 32) {
#pragma unroll
      for (int o = 0; o < NA; ++o) x[o] = b3[o];
      x[NA] = w.actor;
      x[NA + 1] = w.critic;
      x[NA + 2] = w.rmax;
    }
  }
  __syncthreads();
  if (tid == 0) {
#pragma unroll
    for (int o = 0; o < NA; ++o) out[A_B3 + o] = b3[o] + x[o];
    out[ACC + 0] = w.actor + x[NA];
    out[ACC + 1] = w.critic + x[NA + 1];
    out[ACC + 2] = fmaxf(w.rmax, x[NA + 2]);
    out[ACC + 3] = 0.f;
  }
}

// Where output entry e (< O_GRADS) lives: its head, its accumulator index,
// its leaf (0..11, flax leaf order) and its offset in that leaf.
struct Entry {
  int head, src, leaf, off;
};

__device__ __forceinline__ Entry locate(int e) {
  Entry r;
  r.head = e < O_ACTOR ? 0 : 1;
  r.leaf = 6 * r.head;
  int k = e - r.head * O_ACTOR;
  if (k < OBS * H) {
    r.src = A_W1 + (k / OBS) * OBS_P + k % OBS;
  } else if ((k -= OBS * H) < H) {
    r.src = A_B1 + k;
    r.leaf += 1;
  } else if ((k -= H) < H * H) {
    r.src = A_W2 + k;
    r.leaf += 2;
  } else if ((k -= H * H) < H) {
    r.src = A_B2 + k;
    r.leaf += 3;
  } else {
    k -= H;
    const int n_out = r.head == 0 ? NA : 1;
    if (k < n_out * H) {
      r.src = A_W3 + k;
      r.leaf += 4;
    } else {
      k -= n_out * H;
      r.src = A_B3 + k;
      r.leaf += 5;
    }
  }
  r.off = k;
  return r;
}

// The sum of entry src over the G partials of one head, in the order 0..G-1.
__device__ __forceinline__ float sum_partials(const float* __restrict__ work, int G, int head,
                                              int src) {
  float s = 0.f;
  for (int c = 0; c < G; ++c) s += work[((size_t)head * G + c) * ACCS + src];
  return s;
}

// Metric m (0 actor sum, 1 critic sum, 2 ratio max) over the partials.
__device__ __forceinline__ float reduce_metric(const float* __restrict__ work, int G, int m) {
  const int head = m == 1 ? 1 : 0;
  float s = 0.f;
  for (int c = 0; c < G; ++c) {
    const float v = work[((size_t)head * G + c) * ACCS + ACC + m];
    s = m == 2 ? fmaxf(s, v) : s + v;
  }
  return s;
}

// Sum the G partials of every output entry in the order 0..G-1 and write
// the gradients in leaf order, then the metrics.
__global__ void reduce_kernel(const float* __restrict__ work, float* __restrict__ out, int G) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= N_OUT) return;
  if (e >= O_GRADS) {
    out[e] = reduce_metric(work, G, e - O_GRADS);
    return;
  }
  const Entry at = locate(e);
  out[e] = sum_partials(work, G, at.head, at.src);
}

}  // namespace ppo_grad

extern "C" {

// Sizes the wrappers allocate by: floats per head of the weight pack, of
// one CTA's partial, and of the flat output.
int ppo_grad_pack_floats() { return ppo_grad::PACK; }
int ppo_grad_partial_floats() { return ppo_grad::ACCS; }
int ppo_grad_out_floats() { return ppo_grad::N_OUT; }

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
