// Device code shared by the two PPO gradient kernels, `ppo_fused_t.cu`
// (B2, transposed batch) and `ppo_fused.cu` (B3 and B4, row-major batch).
// Both compute, over a minibatch of rows, the clipped-surrogate + value loss
// of the port's `agents.ppo.ppo_loss` under the fixed std and the gradients
// of all 12 ActorCritic leaves (OBS -> H -> H -> 4 tanh actor, -> 1
// critic), with the hand-derived backward and the clip-tie convention
// where(surr1 <= surr2, 1, in_band), in_band strict on both sides. They
// differ only in how a chunk of rows reaches shared memory.
//
// One library per instantiation: the build (`ops/_build.py`) sets the
// hidden width AQE_H (32, 64 or 128; a narrower model runs zero-padded on
// the next width up; a wider one runs on the wide design,
// `ppo_grad_wide.cuh`), the obs width AQE_OBS and the products' precision AQE_BF16. Zero padding is exact: a padded unit has zero weights in and
// out and a zero bias, so its activation is tanh(0) = 0 and its delta 0; it
// adds exact zeros to every sum and its gradient entries are exactly 0. The
// wrappers pad only the weight pack (a copy made for every launch anyway);
// the reductions read the real width's entries out of the padded partials,
// so B4's Adam step runs in place on the model's own leaves, no copies.
//
// Bound at H = 128, OBS = 75: 277,248 f32 FLOP per row against 332 bytes of
// row data, so compute bound at every shape the trainer runs: 2.17 ms at
// the bench minibatch (524,288 rows) on the H100's 67 TFLOP/s of f32 CUDA
// cores. Over 99% of the FLOP are in five products of width H per head,
// which run on the tensor cores: in f32 mode in 3xTF32, three TF32 products
// per f32 product (0.88 ms at the 495 TFLOP/s TF32 peak); in bf16 mode
// (PPOConfig.fused_compute = "bf16") one bf16 product with f32 sums (0.15
// ms at the 989 TFLOP/s dense bf16 peak).
//
// Design, common to both:
//
// * The actor and the critic are independent given the rows, so each CTA
//   serves one head (blockIdx.y); G CTAs per head walk the minibatch's
//   chunks of CHUNK = 64 rows with stride G, in order.
// * Weight-gradient slices (blockIdx.z): a CTA holds its dW2 and dW1 rows
//   in registers for its whole walk, at most ACC_REGS floats a thread. Where
//   H (H + K1) / 256 is more (H = 128 with obs wider than 80), NS = 2 CTAs
//   share each walk, each recomputing every chunk's forward and backward and
//   keeping the rows j of one slice of SL = H / NS units.
// * Weights resident in shared memory where they fit beside the rest (H <=
//   128 at obs <= 80): W1 (H x K1, rows padded to K1 + 4 floats), one copy
//   of W2 (H x H, swizzled); the forward and the backward read the one W2
//   through different fragment mappings. Otherwise (wider obs) the products read W1 and W2 from the weight pack in global memory
//   through L1 and L2. W3 and the biases are always resident.
// * Tensor cores: per chunk and head the forward X W1^T (K = K1, the obs
//   zero-padded to a multiple of 16, or 32 at H = 32) and H1 W2^T, the data
//   gradient g_h2 W2 and the weight gradients g_h2^T H1 and g_h1^T X, K =
//   the chunk's 64 rows. In f32 mode in 3xTF32 (`mma_tf32.cuh`): each
//   operand x split into hi = tf32(x) and lo = tf32(x - hi), lo hi + hi lo
//   + hi hi with f32 sums (mma.sync m16n8k8), which keeps f32 accuracy. In
//   bf16 mode one mma.sync m16n8k16 bf16 product with f32 sums, each
//   operand rounded to bf16 to nearest even as it is read from shared
//   memory, as the JAX kernel's astype(bfloat16) rounds it: shared memory
//   keeps the f32 values, since the tanh derivatives (1 - h^2) and the bias
//   sums read them in f32. The products through W3 (4 or 1 outputs), the
//   tanh and its derivative and the loss rows stay on the CUDA cores, with
//   accurate tanhf, expf and IEEE division (no fast-math); in bf16 mode the
//   operands of the W3 products (h2, W3, the head's output gradients) are
//   rounded to bf16 there too.
// * Gradient accumulators in registers: the running dW2 and dW1 rows of the
//   CTA's slice are MMA accumulator fragments for its whole walk (at H =
//   128: each warp a 32 x 64 tile of dW2 and a 32 x 40 tile of dW1, 104
//   floats a thread). Each chunk's weight gradient is formed in fresh
//   fragments and then added in, so that the tensor cores' own f32 sums run
//   over one chunk's 64 rows only and the walk's sum is rounded to nearest.
//   dW3 and the bias sums are per-thread sums in shared memory, the loss
//   sums and b3 in the two loss warps' registers. At the end each CTA writes
//   them once to its partial in the workspace (2, G, ACCS), the layout the
//   reductions read; slice z writes its rows, slice 0 the rest.
// * Activations in shared memory, swizzled: X^T (K1 x 64), H1 and H2 (64 x
//   H) and W2 hold entry (row, col) at row * width + (col ^ swz(row)), so
//   that the fragment reads along rows and along columns both hit 32
//   distinct banks. H1 is overwritten by g_h1 and H2 by g_h2 in place.
// * Double-buffered inputs: while a chunk computes, the next chunk's source
//   rows are resolved into a table and its obs and aux copied by cp.async
//   into the second buffer (B2: 16-byte copies of 4 envs of a feature row
//   where the alignment allows; B3/B4: 4-byte copies, a row being OBS x 4
//   bytes).
// * Any obs width (WIDE): where X^T's two buffers do not fit beside the
//   rest, or dW1 does not fit in registers with at most 2 slices (obs over
//   288 at H = 128, over 352 at H = 64, over 384 at H = 32), X is not
//   staged: the two products that read it (the first layer
//   and dW1) read each entry from the batch in global memory through the
//   chunk's source-row table (`XByRow`, `XByFeature`), and dW1's rows of the
//   slice are summed in the CTA's own partial in the workspace, one
//   8-column tile a warp at a time, read, added to and written back by the
//   thread that owns the entry (so in a fixed order, as in registers). dW2
//   then fits one CTA (NS = 1). Nothing else changes; the trainer's
//   instantiations are not WIDE.
// * A second small kernel sums the G partials of each gradient entry in the
//   order 0..G-1 (no float atomics, so two launches give the same bits) and
//   writes the gradients of the model's real width in the (out, in) layout
//   of `nn.Linear.weight`, biases as (out,); B4's reduction takes the Adam
//   step there.
//
// Shared memory (bytes) at H = 128, OBS = 75, one CTA of 256 threads per
// SM: W3 2,112, biases 1,040; X^T 2 x 20,480 and aux 2 x 2,048 (two
// buffers); H1 and H2 32,768 each; head outputs 1,024; per-thread sums
// 6,144; source-row tables 1,024; W1 43,008, W2 65,536: 230,480 of the
// 232,448 a CTA may have. Registers: 104 accumulator floats a thread, plus
// a product's fresh fragments (32 or 40) and its operands in hi/lo (20);
// ptxas (CUDA 12.8) gave the B2 kernel 236 and the row-major one 239 at
// this instantiation, with no spills (the build phase of chip_smoke.py
// prints every instantiation's). In bf16 mode a product reads each operand
// once instead of twice (hi and lo), and 16 deep instead of 8.
//
// Not wgmma: its TF32 form takes B (and A from shared memory) K-major
// only, while the backward reads H1, g_h2 and W2 along the other axis; 3x
// TF32 would need hi and lo copies of every shared operand, which do not
// fit beside the resident weights; and a 64-row chunk is one M tile of a
// serial forward-to-backward chain. So the products run on mma.sync,
// which does not reach the tensor cores' full rate (only wgmma does).

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "mma_tf32.cuh"
#include "ppo_common.cuh"

// The instantiation (set by the build; these defaults are the trainer's).
#ifndef AQE_H
#define AQE_H 128
#endif
#ifndef AQE_OBS
#define AQE_OBS 75
#endif
#ifndef AQE_BF16
#define AQE_BF16 0
#endif

namespace ppo_grad {

constexpr int H = AQE_H;
constexpr int OBS = AQE_OBS;
constexpr bool BF16 = AQE_BF16 != 0;
constexpr int CHUNK = 64;  // rows per chunk
constexpr int THREADS = 256;
constexpr int KQ = 16 + 16 * (H == 32);       // K1's quantum: dW1's warp tiling, bf16's depth
constexpr int K1 = (OBS + KQ - 1) / KQ * KQ;  // OBS padded; inputs OBS..K1-1 are zero
constexpr int OBS_P = (OBS + 3) / 4 * 4;      // row stride of dW1 in the partial layout
constexpr int ACC_REGS = 104;                 // accumulator floats a thread, at most
constexpr int SMEM_MAX = 232448;              // a CTA's shared memory on the H100
// Shared memory (floats) of everything but X^T and the resident weights.
constexpr int BASE_FLOATS = NA * (H + 4) + 2 * H + NA + 2 * 8 * CHUNK + 2 * CHUNK * H +
                            CHUNK * NA + 6 * THREADS + 4 * CHUNK;
// The slices that keep dW2 and dW1 in ACC_REGS: 1, or 2 (where 2 do not
// either, the layout is WIDE).
constexpr int NS_REG = 1 + (H * (H + K1) / THREADS > ACC_REGS);
// Obs too wide for that layout (X^T's two buffers in shared memory, dW1 in
// registers): X is read from the batch in global memory instead of being
// staged, and dW1 is summed in the CTA's partial in the workspace.
constexpr bool WIDE = !((BASE_FLOATS + 2 * K1 * CHUNK) * 4 <= SMEM_MAX &&
                        (H / NS_REG) * (H + K1) / THREADS <= ACC_REGS &&
                        (H / NS_REG >= 64 || NS_REG == 1));
// Weight-gradient slices: NS_REG, or 1 where WIDE (dW2 alone in ACC_REGS).
constexpr int NS = !WIDE ? NS_REG : 1;
constexpr int SL = H / NS;                    // dW2 and dW1 rows of one slice

// Packed weights of one head (floats), built by the wrapper.
constexpr int P_W1 = 0;                    // [H][K1]  W1 (out, in), inputs OBS.. zero
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
constexpr int ACC = A_B3 + NA;             // 26,884 at H = 128, OBS = 75
constexpr int ACCS = ACC + NMET;

// Shared memory (floats); the resident weights last, where they fit.
constexpr int W1_LD = K1 + 4;              // row strides padded against bank conflicts
constexpr int W3_LD = H + 4;
constexpr int S_W3 = 0;                        // [NA][W3_LD]
constexpr int S_B1 = S_W3 + NA * W3_LD;        // b1, b2, b3 as in the pack
constexpr int S_B2 = S_B1 + H;
constexpr int S_B3 = S_B2 + H;
constexpr int S_X = S_B3 + NA;                 // [2][K1][CHUNK] swizzled: inputs, transposed
constexpr int S_AUX = S_X + 2 * K1 * CHUNK * !WIDE;  // [2][8][CHUNK]: aux 0-6, row 7 live flags
constexpr int S_H1 = S_AUX + 2 * 8 * CHUNK;    // [CHUNK][H] swizzled: h1, then g_h1
constexpr int S_H2 = S_H1 + CHUNK * H;         // [CHUNK][H] swizzled: h2, then g_h2
constexpr int S_GO = S_H2 + CHUNK * H;         // [CHUNK][NA] head outputs, then their gradients
constexpr int S_SUM = S_GO + CHUNK * NA;       // [6][THREADS] per-thread sums: dW3 (4), b2, b1
constexpr int S_ROWS = S_SUM + 6 * THREADS;    // [2][2][CHUNK] ints: each chunk's source rows
constexpr int S_W1 = S_ROWS + 4 * CHUNK;       // [H][W1_LD] resident W1
constexpr int S_W2 = S_W1 + H * W1_LD;         // [H][H] resident W2, swizzled
constexpr int RESIDENT_W = (S_W2 + H * H) * 4 <= SMEM_MAX;  // 1: W1 and W2 resident
constexpr bool RESIDENT = RESIDENT_W != 0;
constexpr int SMEM_FLOATS = S_W1 + RESIDENT_W * (H * W1_LD + H * H);
constexpr int SMEM_BYTES = SMEM_FLOATS * 4;

// Warp tilings over the 8 warps (WM along the output's rows, WN along its
// columns; a warp's tile TM x TN in passes of at most 32 columns):
// (a) the chunk-by-unit products (both forward layers, the data gradient):
//     64 x H;
constexpr int A_WM = H == 32 ? 4 : 2, A_WN = 8 / A_WM;
constexpr int A_TM = CHUNK / A_WM, A_TN = H / A_WN;
constexpr int A_PN = A_TN < 32 ? A_TN : 32;
constexpr int A_MT = A_TM / 16, A_NT = A_PN / 8, A_PASSES = A_TN / A_PN;
// (b) dW2, the slice's SL rows x H;
constexpr int B_WM = SL >= 64 ? 4 : 2, B_WN = 8 / B_WM;
constexpr int B_TM = SL / B_WM, B_TN = H / B_WN;
constexpr int B_PN = B_TN < 32 ? B_TN : 32;
constexpr int B_MT = B_TM / 16, B_NT = B_PN / 8, B_PASSES = B_TN / B_PN;
// (c) dW1, the slice's SL rows x K1 in one pass (WIDE: in passes of one
//     8-column tile a warp, added to the partial in global memory).
constexpr int C_WM = B_WM, C_WN = B_WN;
constexpr int C_TM = SL / C_WM, C_TN = WIDE ? 8 : K1 / C_WN;
constexpr int C_MT = C_TM / 16, C_NT = C_TN / 8;
// The per-unit passes (back_out, the b1 sums): RS segments of the rows.
constexpr int RS = THREADS / H, RROWS = CHUNK / RS;

// Flat output at the model's real width hr (`ppo_common.cuh`), and this
// instantiation's partial layout.
__host__ __device__ constexpr int out_floats(int hr) {
  return out_actor(OBS, hr) + out_critic(OBS, hr) + 3;
}
__host__ __device__ constexpr Layout layout() { return make_layout(H, OBS); }

static_assert(H == 32 || H == 64 || H == 128, "the instantiated widths");
static_assert(layout().acc == ACC && layout().w2 == A_W2 && layout().b3 == A_B3, "partial layout");
static_assert(ACC % 4 == 0 && PACK % 4 == 0 && ACCS % 4 == 0 && K1 % 16 == 0, "alignment");
static_assert(S_X % 4 == 0 && S_AUX % 4 == 0 && S_H1 % 4 == 0 && S_H2 % 4 == 0 &&
              S_GO % 4 == 0 && S_W1 % 4 == 0 && S_W2 % 4 == 0, "float4 alignment");
static_assert(SMEM_BYTES <= SMEM_MAX, "more shared memory than a CTA may have");
static_assert(SL * (H + (WIDE ? 0 : K1)) / THREADS <= ACC_REGS && (SL >= 64 || NS == 1),
              "more accumulators than ACC_REGS");
static_assert(BASE_FLOATS == S_W1 - (S_AUX - S_X), "BASE_FLOATS is the layout but X^T");
static_assert(A_TM % 16 == 0 && A_PN % 8 == 0 && B_TM % 16 == 0 && B_PN % 8 == 0 &&
              C_TM % 16 == 0 && C_TN % 8 == 0 && K1 % (8 * C_WN) == 0, "warp tilings");
static_assert(CHUNK == 64 && THREADS == 256 && CHUNK * NA == THREADS && THREADS % H == 0,
              "tile mappings assume these");

// What a CTA carries over its walk in registers: its warp's tiles of the
// running dW2 and dW1 rows of its slice as MMA accumulator fragments, and
// in the two loss warps (threads < CHUNK) the sums over their rows: the
// head's loss (lane 0), the ratio max (lane 0) and b3's gradient (each lane).
// Where WIDE, dW1's rows of the slice are summed in the CTA's partial at dw1g
// instead (each thread its own entries, so no other thread reads them).
struct Walk {
  float dw2[B_MT][B_TN / 8][4];
  float dw1[C_MT][C_NT][4];
  float actor, critic, rmax, b3[NA];
  float* dw1g;
};

// The weights' fragment views: in shared memory where resident, else in
// the head's pack in global memory (the same constructor either way).
using W1View = std::conditional_t<RESIDENT, RowsPlain<W1_LD>, RowsPlain<K1>>;
using W2Fwd = std::conditional_t<RESIDENT, RowsSwz<H>, RowsPlain<H>>;
using W2Bwd = std::conditional_t<RESIDENT, ColsSwz<H>, ColsPlain<H>>;

// The batch's obs in global memory, for the WIDE reads: entry (r, f) of
// the chunk's X is p[t * rs + f * fs + e], (t, e) row r's entries (r, CHUNK
// + r) of the chunk's source-row table; 0 for f >= OBS and where t < 0
// (padding, or a bad block id, whose live aux row poisons the loss).
struct XRows {
  const float* p;
  size_t rs;
  int fs;
};

struct XGather {
  XRows src;
  const int* tab;
  __device__ __forceinline__ float x(int r, int f) const {
    const int t = tab[r];
    return t >= 0 && f < OBS ? __ldg(src.p + (size_t)t * src.rs + (size_t)f * src.fs + tab[CHUNK + r])
                             : 0.f;
  }
};

// X as the first layer's operand A, entry (idx, k) = x(row idx, feature k),
// as ColsSwz<CHUNK> reads it from X^T in shared memory.
struct XByRow {
  XGather xg;
  int i0, g, t;
  __device__ __forceinline__ XByRow(const XGather& x, int idx0)
      : xg(x), i0(idx0), g((threadIdx.x & 31) >> 2), t(threadIdx.x & 3) {}
  __device__ __forceinline__ float at(int c, int q, int i) const {
    return xg.x(i0 + 8 * c + g, 8 * i + t + 4 * q);
  }
  __device__ __forceinline__ float2 pair(int ri, int k) const {
    return make_float2(xg.x(i0 + ri, k), xg.x(i0 + ri, k + 1));
  }
};

// X as dW1's operand B, entry (idx, k) = x(row k, feature idx), as
// RowsSwz<CHUNK> reads it from X^T in shared memory.
struct XByFeature {
  XGather xg;
  int i0, g, t;
  __device__ __forceinline__ XByFeature(const XGather& x, int idx0)
      : xg(x), i0(idx0), g((threadIdx.x & 31) >> 2), t(threadIdx.x & 3) {}
  __device__ __forceinline__ float at(int c, int q, int i) const {
    return xg.x(8 * i + t + 4 * q, i0 + 8 * c + g);
  }
  __device__ __forceinline__ float2 pair(int ri, int k) const {
    return make_float2(xg.x(k, i0 + ri), xg.x(k + 1, i0 + ri));
  }
};

// x as a product's operand: rounded to bf16 in bf16 mode.
__device__ __forceinline__ float opnd(float x) { return BF16 ? bf16r(x) : x; }

// acc += A B over `depth` (a multiple of 16) in the instantiation's
// precision: 3xTF32 or bf16.
template <int MT, int NT, class VA, class VB>
__device__ __forceinline__ void tile_mma(float (&acc)[MT][NT][4], const VA& a, const VB& b,
                                         int depth) {
  if constexpr (BF16) {
    warp_mma_bf16(acc, a, b, depth / 16);
  } else {
    warp_mma(acc, a, b, depth / 8);
  }
}

// A (64 rows x H units) layer on tiling (a): dst[r][j] = f(sum_k A(r, k)
// B(k, j)) with A and B the views `va(m0)` and `vb(n0)`, dst swizzled; f is
// tanh(. + bias[j]) for a forward layer, or (. (1 - h^2)) with h the entry
// of dst it overwrites for the data gradient (bias null).
template <class MA, class MB>
__device__ __forceinline__ void rows_by_units(const MA& va, const MB& vb, int depth,
                                              const float* bias, float* dst) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int m0 = A_TM * (warp % A_WM), nw = A_TN * (warp / A_WM);
  const auto a = va(m0);
#pragma unroll
  for (int p = 0; p < A_PASSES; ++p) {
    const int n0 = nw + A_PN * p;
    float acc[A_MT][A_NT][4];
    zero(acc);
    tile_mma(acc, a, vb(n0), depth);
#pragma unroll
    for (int nt = 0; nt < A_NT; ++nt) {
      const int j = n0 + 8 * nt + 2 * t;
      const float b0 = bias ? bias[j] : 0.f, b1 = bias ? bias[j + 1] : 0.f;
#pragma unroll
      for (int mt = 0; mt < A_MT; ++mt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = m0 + 16 * mt + g + 8 * hh;
          float2* d = reinterpret_cast<float2*>(dst + r * H + (j ^ swz(r)));
          const float x0 = acc[mt][nt][2 * hh], x1 = acc[mt][nt][2 * hh + 1];
          if (bias) {
            *d = make_float2(tanhf(x0 + b0), tanhf(x1 + b1));
          } else {
            const float2 h = *d;
            *d = make_float2(x0 * (1.f - h.x * h.x), x1 * (1.f - h.y * h.y));
          }
        }
    }
  }
}

// The head's outputs, one (row, output) per thread, into GO: tanh for the
// actor's mean, linear for the critic (W3 is stored as an operand already).
__device__ __forceinline__ void head_outputs(float* S, int head) {
  const int r = threadIdx.x >> 2, o = threadIdx.x & 3, sw = swz(r);
  const float* h = S + S_H2 + r * H;
  const float* w = S + S_W3 + o * W3_LD;
  float s = 0.f;
#pragma unroll 8
  for (int k = 0; k < H; k += 4) {
    const float4 hv = lds4(h + (k ^ sw)), wv = lds4(w + k);
    s = fmaf(opnd(hv.x), wv.x, s);
    s = fmaf(opnd(hv.y), wv.y, s);
    s = fmaf(opnd(hv.z), wv.z, s);
    s = fmaf(opnd(hv.w), wv.w, s);
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
  float aux[7];
#pragma unroll
  for (int i = 0; i < 7; ++i) aux[i] = AUX[i * CHUNK + r];
  float go[NA], ratio;
  const float row = loss_row(head, live, mean, aux, c, go, ratio);
  if (head == 0) {
    const float m = warp_max(ratio);
    if ((r & 31) == 0) w.rmax = fmaxf(w.rmax, m);
  }
  sts4(GO + r * NA, make_float4(go[0], go[1], go[2], go[3]));
#pragma unroll
  for (int o = 0; o < NA; ++o) w.b3[o] += go[o];
  const float s = warp_sum(row);
  if ((r & 31) == 0) {
    if (head == 0) w.actor += s; else w.critic += s;
  }
}

// Backward through the output layer, one hidden unit k and RROWS rows a
// thread: g_h2[r][k] = (sum_o GO[r][o] W3[o][k]) (1 - h2^2) in place of h2;
// its sums of GO[r][o] h2[r][k] (dW3) and of g_h2 (b2) into its own slots.
__device__ __forceinline__ void back_out(float* S) {
  const int k = threadIdx.x % H, r0 = (threadIdx.x / H) * RROWS;
  float w3[NA], d3[NA], sb = 0.f;
#pragma unroll
  for (int o = 0; o < NA; ++o) {
    w3[o] = S[S_W3 + o * W3_LD + k];
    d3[o] = 0.f;
  }
  float* H2 = S + S_H2;
  const float* GO = S + S_GO;
#pragma unroll 4
  for (int r = r0; r < r0 + RROWS; ++r) {
    const float4 g4 = lds4(GO + r * NA);
    const float go[NA] = {opnd(g4.x), opnd(g4.y), opnd(g4.z), opnd(g4.w)};
    float* p = H2 + r * H + (k ^ swz(r));
    const float h = *p, hq = opnd(h);
    float s = go[0] * w3[0];
    s = fmaf(go[1], w3[1], s);
    s = fmaf(go[2], w3[2], s);
    s = fmaf(go[3], w3[3], s);
    const float gh = s * (1.f - h * h);
    *p = gh;
#pragma unroll
    for (int o = 0; o < NA; ++o) d3[o] = fmaf(go[o], hq, d3[o]);
    sb += gh;
  }
  float* sum = S + S_SUM + threadIdx.x;
#pragma unroll
  for (int o = 0; o < NA; ++o) sum[o * THREADS] += d3[o];
  sum[4 * THREADS] += sb;
}

// dW2[j][i] += sum_r g_h2[r][j] h1[r][i] over the chunk for the slice's
// rows j, each warp its tile in passes of fresh fragments.
__device__ __forceinline__ void grad_w2(const float* G2, const float* H1, Walk& w, int slice) {
  const int warp = threadIdx.x >> 5;
  const int m0 = SL * slice + B_TM * (warp / B_WN), nw = B_TN * (warp % B_WN);
  const ColsSwz<H> a(G2, m0);
#pragma unroll
  for (int p = 0; p < B_PASSES; ++p) {
    float part[B_MT][B_NT][4];
    zero(part);
    tile_mma(part, a, ColsSwz<H>(H1, nw + B_PN * p), CHUNK);
#pragma unroll
    for (int mt = 0; mt < B_MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < B_NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) w.dw2[mt][B_NT * p + nt][e] += part[mt][nt][e];
  }
}

// WIDE: the thread's entries of a warp's 8-column tile (rows m0.., columns
// n..) of dW1 in the partial at p, set to `part` or `part` added to them.
__device__ __forceinline__ void dw1_tile_to(float* p, const float (&part)[C_MT][1][4], int m0,
                                            int n, bool add) {
  const int lane = threadIdx.x & 31, f = n + 2 * (lane & 3);
  if (f >= OBS_P) return;
#pragma unroll
  for (int mt = 0; mt < C_MT; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float2* d = reinterpret_cast<float2*>(p + (m0 + 16 * mt + (lane >> 2) + 8 * hh) * OBS_P + f);
      const float2 v = add ? *d : make_float2(0.f, 0.f);
      *d = make_float2(v.x + part[mt][0][2 * hh], v.y + part[mt][0][2 * hh + 1]);
    }
}

// dW1[j][f] += sum_r g_h1[r][j] x[r][f] over the chunk for the slice's rows
// j, each warp its tile (WIDE: its 8-column tiles in turn, x read through
// `xg`, the sums in the partial); then each thread's sum of g_h1 over its
// rows of one unit (b1).
__device__ __forceinline__ void grad_w1(float* S, const float* G1, const float* X,
                                        const XGather& xg, Walk& w, int slice) {
  const int warp = threadIdx.x >> 5;
  const int m0 = SL * slice + C_TM * (warp / C_WN), n0 = C_TN * (warp % C_WN);
  if constexpr (WIDE) {
    const ColsSwz<H> a(G1, m0);
    for (int n = n0; n < K1; n += 8 * C_WN) {
      float part[C_MT][1][4];
      zero(part);
      tile_mma(part, a, XByFeature(xg, n), CHUNK);
      dw1_tile_to(w.dw1g, part, m0, n, true);
    }
  } else {
    float part[C_MT][C_NT][4];
    zero(part);
    tile_mma(part, ColsSwz<H>(G1, m0), RowsSwz<CHUNK>(X, n0), CHUNK);
#pragma unroll
    for (int mt = 0; mt < C_MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < C_NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) w.dw1[mt][nt][e] += part[mt][nt][e];
  }
  const int k = threadIdx.x % H, r0 = (threadIdx.x / H) * RROWS;
  float s = 0.f;
#pragma unroll 8
  for (int r = r0; r < r0 + RROWS; ++r) s += G1[r * H + (k ^ swz(r))];
  S[S_SUM + 5 * THREADS + threadIdx.x] += s;
}

// A CTA's start: its head's W3 (as an operand) and biases, and where
// resident W1 and W2, from the wrapper's pack W into shared memory; the
// zero inputs OBS..K1-1 of both input buffers, and zero sums (WIDE: its
// entries of dW1 in its partial in the workspace (2, G, ACCS) too).
__device__ __forceinline__ void init_walk(float* S, const float* __restrict__ W, Walk& w,
                                          float* work, int G, int head, int slice) {
  const int tid = threadIdx.x;
  w.dw1g = work + ((size_t)head * G + blockIdx.x) * ACCS + A_W1;
  if constexpr (WIDE) {
    const int warp = tid >> 5, m0 = SL * slice + C_TM * (warp / C_WN);
    float none[C_MT][1][4];
    zero(none);
    for (int n = C_TN * (warp % C_WN); n < K1; n += 8 * C_WN) dw1_tile_to(w.dw1g, none, m0, n, false);
  }
  for (int e = tid; e < NA * H / 4; e += THREADS) {
    const int o = e / (H / 4), k = 4 * (e % (H / 4));
    const float4 v = ld4(W + P_W3 + o * H + k);
    sts4(S + S_W3 + o * W3_LD + k, make_float4(opnd(v.x), opnd(v.y), opnd(v.z), opnd(v.w)));
  }
  for (int e = tid; e < 2 * H + NA; e += THREADS) S[S_B1 + e] = __ldg(W + P_B1 + e);
  if constexpr (RESIDENT) {
    for (int e = tid; e < H * K1 / 4; e += THREADS) {
      const int j = e / (K1 / 4), f = 4 * (e % (K1 / 4));
      sts4(S + S_W1 + j * W1_LD + f, ld4(W + P_W1 + j * K1 + f));
    }
    for (int e = tid; e < H * H / 4; e += THREADS) {
      const int j = e / (H / 4), i = 4 * (e % (H / 4));
      sts4(S + S_W2 + j * H + (i ^ swz(j)), ld4(W + P_W2 + j * H + i));
    }
  }
  for (int e = tid; e < 2 * (K1 - OBS) * CHUNK * !WIDE; e += THREADS) {
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

// One chunk's forward and backward, added into the walk's sums of slice
// `slice`. The caller has resolved the chunk's source rows into table `buf`
// and staged it in input buffer `buf` (X^T, but where WIDE, and aux, row 7
// of aux the rows' live flags) and passed a barrier. `W` is the head's pack
// (read where the weights are not resident); `xr` the batch's obs (read
// where WIDE). `next` stages the next chunk in the other buffer; it runs
// once the first layer has read this chunk's X.
template <class Next>
__device__ __forceinline__ void chunk_grad(float* S, const float* __restrict__ W, int buf,
                                           int head, int slice, const LossConsts& c, Walk& w,
                                           const XRows& xr, const Next& next) {
  const float* X = S + S_X + buf * K1 * CHUNK;
  const XGather xg{xr, reinterpret_cast<const int*>(S + S_ROWS) + buf * 2 * CHUNK};
  const float* AUX = S + S_AUX + buf * 8 * CHUNK;
  const float* W1 = RESIDENT ? S + S_W1 : W + P_W1;
  const float* W2 = RESIDENT ? S + S_W2 : W + P_W2;
  float* H1 = S + S_H1;
  float* H2 = S + S_H2;

  // ---- forward
  if constexpr (WIDE) {
    rows_by_units([&](int m) { return XByRow(xg, m); },
                  [&](int n) { return W1View(W1, n); }, K1, S + S_B1, H1);
  } else {
    rows_by_units([&](int m) { return ColsSwz<CHUNK>(X, m); },
                  [&](int n) { return W1View(W1, n); }, K1, S + S_B1, H1);
  }
  __syncthreads();
  next();
  rows_by_units([&](int m) { return RowsSwz<H>(H1, m); },
                [&](int n) { return W2Fwd(W2, n); }, H, S + S_B2, H2);
  __syncthreads();
  head_outputs(S, head);
  __syncthreads();

  // ---- loss rows, then backward
  loss_rows(AUX, S + S_GO, head, c, w);
  __syncthreads();
  back_out(S);                 // H2 <- g_h2
  __syncthreads();
  grad_w2(H2, H1, w, slice);
  __syncthreads();
  rows_by_units([&](int m) { return RowsSwz<H>(H2, m); },   // H1 <- g_h1
                [&](int n) { return W2Bwd(W2, n); }, H, nullptr, H1);
  __syncthreads();
  grad_w1(S, H1, X, xg, w, slice);
}

// The walk's sums into the CTA's partial in the workspace (2, G, ACCS):
// every slice its rows of dW2 and dW1, slice 0 the rest.
__device__ __forceinline__ void write_partial(float* S, float* work, int G, int head, int slice,
                                              Walk& w) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  float* out = work + ((size_t)head * G + blockIdx.x) * ACCS;
  {
    const int m2 = SL * slice + B_TM * (warp / B_WN), n2 = B_TN * (warp % B_WN);
#pragma unroll
    for (int mt = 0; mt < B_MT; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int j = m2 + 16 * mt + g + 8 * hh;
#pragma unroll
        for (int nt = 0; nt < B_TN / 8; ++nt)
          *reinterpret_cast<float2*>(out + A_W2 + j * H + n2 + 8 * nt + 2 * t) =
              make_float2(w.dw2[mt][nt][2 * hh], w.dw2[mt][nt][2 * hh + 1]);
      }
    const int m1 = SL * slice + C_TM * (warp / C_WN), n1 = C_TN * (warp % C_WN);
#pragma unroll
    for (int mt = 0; mt < C_MT * !WIDE; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int j = m1 + 16 * mt + g + 8 * hh;
#pragma unroll
        for (int nt = 0; nt < C_NT; ++nt) {
          const int f = n1 + 8 * nt + 2 * t;
          if (f < OBS_P)
            *reinterpret_cast<float2*>(out + A_W1 + j * OBS_P + f) =
                make_float2(w.dw1[mt][nt][2 * hh], w.dw1[mt][nt][2 * hh + 1]);
        }
      }
  }
  if (slice != 0) return;  // the same for the whole CTA
  __syncthreads();  // every thread's sums in S_SUM are final; H1 is free
  const float* sum = S + S_SUM;
  for (int e = tid; e < NA * H; e += THREADS) {
    const int o = e / H, k = e % H;
    float s = 0.f;
#pragma unroll
    for (int seg = 0; seg < RS; ++seg) s += sum[o * THREADS + seg * H + k];
    out[A_W3 + e] = s;
  }
  for (int k = tid; k < H; k += THREADS) {
    float s2 = 0.f, s1 = 0.f;
#pragma unroll
    for (int seg = 0; seg < RS; ++seg) {
      s2 += sum[4 * THREADS + seg * H + k];
      s1 += sum[5 * THREADS + seg * H + k];
    }
    out[A_B2 + k] = s2;
    out[A_B1 + k] = s1;
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

// The reduction pass (`ppo_common.cuh:reduce_entry`).
__global__ void reduce_kernel(const float* __restrict__ work, float* __restrict__ out, int G,
                              int hr) {
  reduce_entry(work, out, G, hr, layout());
}

}  // namespace ppo_grad

extern "C" {

// What the wrappers allocate by, for a model of hidden width hr (at most
// H): floats per head of the weight pack; the chunk walkers per head G for
// a minibatch of mb rows on `sms` SMs (at most one per chunk; with the NS
// slice CTAs of each walk, the 2 G NS CTAs about fill the SMs); floats of
// the workspace, the G partials of each head; floats of the flat output.
int ppo_grad_pack_floats(int) { return ppo_grad::PACK; }
int ppo_grad_walkers(int, int sms, int mb) {
  using namespace ppo_grad;
  const int per_sm = sms / (2 * NS), chunks = (mb + CHUNK - 1) / CHUNK;
  const int g = per_sm < chunks ? per_sm : chunks;
  return g > 1 ? g : 1;
}
long long ppo_grad_work_floats(int, int, int G) { return 2LL * G * ppo_grad::ACCS; }
int ppo_grad_out_floats(int hr) { return ppo_grad::out_floats(hr); }

// The instantiation: 0 H, 1 OBS, 2 bf16, 3 K1, 4 slices, 5 weights
// resident, 6 shared memory bytes, 7 WIDE.
int ppo_grad_config(int i) {
  using namespace ppo_grad;
  const int v[] = {H, OBS, BF16 ? 1 : 0, K1, NS, RESIDENT ? 1 : 0, SMEM_BYTES, WIDE ? 1 : 0};
  return i >= 0 && i < 8 ? v[i] : -1;
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
