// Whole-rollout kernel for Hopper (sm_90a): T env steps of B hover envs,
// each step the actor forward, Gaussian sampling, RK4 physics, reward,
// termination and auto-reset from a P-deep pool, then the critic over every
// observation of the rollout, in one launch.
//
// Replaces the TPU kernel `ops/rollout_fused.py:fused_rollout` of the JAX
// package (Pallas body `_kernel`); computes what the port's
// `ops/rollout_fused.py` step body (`_policy`, `step_math`, `_pool_select`,
// `_merge_reset`) computes, T times.
//
// One library per hidden width: the build (`ops/_build.py`) sets AQE_H to
// 32, 64, 128 or 256, and a narrower model runs zero-padded on the next
// width up (the wrapper pads the weight pack; a padded unit's activation is
// tanh(0) = 0, so it adds exact zeros); wider models run on
// `rollout_wide.cu`. The obs are the featurizer's 75; the env step is
// `rollout_physics.cuh`, shared with the wide kernel.
//
// Bound. At B = 8192, T = 256, H = 128 the forward passes are about
// 2.2e11 f32 FLOP (105,216 per env-step) against about 0.82 GB of device
// memory traffic (obs and misc out, noise, pool and state in): 3.29 ms on
// the 67 TFLOP/s of the H100's f32 CUDA cores, by operations. Over 99% of
// the FLOP are in the four 128-wide products, which run here on the tensor
// cores in 3xTF32 (three TF32 products per f32 product): 1.34 ms at the
// 495 TFLOP/s TF32 peak, without the physics and the tanhf.
//
// Design. Envs are independent, so a CTA owns a tile of TILE = 64 envs for
// all T steps: the TPU's sequential time-chunk grid axis is the loop over t
// inside the CTA, and its `state_out` accumulator is the tile's packed state,
// which stays in shared memory from the first step to the last. Nothing
// crosses CTAs; one 320-thread CTA fills an SM (128 CTAs at B = 8192).
//
// * Only the actor is in the closed loop: dynamics, reward and reset read
//   the action means, never the value. The critic runs after the loop, in
//   the same launch, over the tile's T observations read back from obs.
// * The actor's weights are resident in shared memory for the loop, the
//   critic's in the same buffers after it, each loaded once per CTA: W1
//   (H x 80, inputs 75-79 zero, rows padded to 84), W2 (H x H, swizzled),
//   W3 and the biases. At H = 256 W2 alone is 256 KB, more than a CTA's
//   227 KB: there the products read W1 and W2 from the weight pack in
//   global memory (each warp its own rows, each entry once per group-step
//   and CTA, through L1 and L2), and only W3 and the biases are resident.
//   That frees the room for the wider h1 (64 KB a group) and the critic
//   pass's 128 KB of split h1.
// * The products on the tensor cores in 3xTF32 (`mma_tf32.cuh`): each f32
//   operand splits into hi and lo, a product is lo hi + hi lo + hi hi with
//   f32 sums (mma.sync m16n8k8), which keeps f32 accuracy; single-pass TF32
//   does not, and 32 closed-loop steps would carry its 3e-4 past the 1e-4
//   gate. An activation operand is split once, where it is made, and
//   stored as its two parts (the observations by a pass over the state's
//   hist rows, h1 by layer 1's epilogue, swizzled), so the eight warps that
//   read it do not each split it again; the weights are split as read. h2
//   stays in the accumulators, from which each thread forms its units'
//   share of the four means (or the value); the lanes and warps sum them.
// * Two groups of 32 envs overlap the physics with the products: eight MMA
//   warps (at H >= 64 each 32 envs x H / 8 units, at H = 32 each 16 envs x
//   8 units) run group 0's products, then group 1's, while warp 8 (group 0) or
//   warp 9 (group 1) stores its group's observations and runs its sampling,
//   physics, reward, record and reset, one thread per env. Named barriers
//   hand each group back and forth (READY: state stepped; MEANS: partial
//   means written) and a ninth orders the MMA warps' passes; the physics
//   warps prefetch the next step's noise into registers. The MMA warps set
//   the pace: the physics (3.7 us a step) never holds them up.
// * The critic pass walks the tile's T chunks of 64 observations: chunk
//   t + 1 is copied by cp.async while chunk t computes; each of the 8 warps
//   owns a (64 / R_WM) x (H / R_WN) tile of each layer (32 x 32 at H =
//   128); warps 8-9 write the values (misc row 8).
//
// Shared memory (bytes) at H = 128, one CTA of 320 threads per SM: W1
// 43,008, W2 65,536, W3 2,048, biases 1,056; the packed state (128 rows,
// 36,864) and,
// in its place during the critic pass, two 80-row input buffers (46,080);
// in the loop a group's split inputs 25,600, its split h1 32,768 and the
// partial means 8,192, in their place during the critic pass the split h1
// of 64 rows 65,536 and the partial values 1,024: 224,288 of the 232,448 a
// CTA may have; at H = 256 (weights in global memory) 185,648. Registers:
// 128 a thread at H = 128, no spills (ptxas -v for sm_90a; the build phase
// of chip_smoke.py prints every width's).
//
// Math stays accurate (no fast-math): tanhf, sqrtf and IEEE division; the
// logprob needs no exp.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "mma_tf32.cuh"
#include "rollout_physics.cuh"

#ifndef AQE_H
#define AQE_H 128
#endif

namespace {

using namespace rollout;
using ppo_grad::ColsPlain;
using ppo_grad::RowsPlain;
using ppo_grad::RowsSwz;
using ppo_grad::Split;
using ppo_grad::split_store;
using ppo_grad::swz;

constexpr int K1 = 80;            // OBS padded to the MMA depth; W1's inputs 75-79 are zero
constexpr int H = AQE_H;          // hidden width of this library
constexpr int TILE = 64;          // envs per CTA
constexpr int GROUP = 32;         // envs per group: one physics warp
constexpr int MMA_WARPS = 8;
constexpr int MMA_THREADS = 32 * MMA_WARPS;
constexpr int THREADS = MMA_THREADS + 32 * (TILE / GROUP);
constexpr int SLD = TILE + 8;     // row stride of the packed state and the critic's inputs
constexpr int XLD = GROUP + 8;    // row stride of a group's split inputs
constexpr int W1_LD = K1 + 4;     // row stride of W1
constexpr int UNROLL = 4;         // depth steps of a product unrolled (4 beat 2 and 16)
constexpr bool RESIDENT = H <= 128;  // W1 and W2 in shared memory; else read from global

// The weight pack of one head (floats), as `ops/rollout_fused.py:weight_pack`
// builds it (the gradient kernels' layout): W1 (H, K1), W2 (H, H), W3 (NA,
// H) with zero rows past the head's outputs, b1, b2, b3 (NA).
constexpr int P_W1 = 0;
constexpr int P_W2 = P_W1 + H * K1;
constexpr int P_W3 = P_W2 + H * H;
constexpr int P_B1 = P_W3 + NA * H;
constexpr int P_B2 = P_B1 + H;
constexpr int P_B3 = P_B2 + H;
constexpr int PACK = P_B3 + NA;

// Warp tilings. The loop: a group's 32 envs x H units, L_WM x L_WN warps.
// The critic pass: 64 envs x H units, R_WM x R_WN warps. Each warp slot
// along the units (L_WN, R_WN of them) leaves its partial sums of the head.
constexpr int L_WM = H == 32 ? 2 : 1, L_WN = MMA_WARPS / L_WM;
constexpr int L_TM = GROUP / L_WM, L_TN = H / L_WN;
constexpr int L_MT = L_TM / 16, L_NT = L_TN / 8;
constexpr int R_WM = H == 32 ? 4 : 2, R_WN = MMA_WARPS / R_WM;
constexpr int R_TM = TILE / R_WM, R_TN = H / R_WN;
constexpr int R_MT = R_TM / 16, R_NT = R_TN / 8;
constexpr int HP_GROUP = L_WN * NA * GROUP;  // one group's partial means

// Shared memory (floats). Operands stored split hold their hi parts, then
// at a fixed offset their lo parts.
constexpr int S_W1 = 0;                          // [H][W1_LD] W1 (out, in), where resident
constexpr int S_W2 = S_W1 + (RESIDENT ? H * W1_LD : 0);  // [H][H] W2 (out, in), swizzled
constexpr int S_W3 = S_W2 + (RESIDENT ? H * H : 0);      // [NA][H] W3, zero rows pad the critic's
constexpr int S_B1 = S_W3 + NA * H;
constexpr int S_B2 = S_B1 + H;
constexpr int S_B3 = S_B2 + H;                   // [NA], zero pad
constexpr int S_ST = S_B3 + NA + 4;              // [ROWS][SLD] state; then [2][K1][SLD] inputs
constexpr int S_LB = S_ST + 2 * K1 * SLD;        // the layers' buffers, in the loop:
constexpr int S_XS = S_LB;                       //   [2][K1][XLD] a group's inputs, split
constexpr int S_H1 = S_XS + 2 * K1 * XLD;        //   [2][GROUP][H] its h1, split, swizzled
constexpr int S_HP = S_H1 + 2 * GROUP * H;       //   [2][L_WN][NA][GROUP] partial means
constexpr int S_H1C = S_LB;                      // in the critic pass: [2][TILE][H] h1, split,
constexpr int S_HPC = S_H1C + 2 * TILE * H;      //   swizzled; [R_WN][TILE] partial values
constexpr int LOOP_END = S_HP + 2 * HP_GROUP, CRITIC_END = S_HPC + R_WN * TILE;
constexpr int SMEM_FLOATS = LOOP_END > CRITIC_END ? LOOP_END : CRITIC_END;
constexpr int SMEM_BYTES = SMEM_FLOATS * (int)sizeof(float);

// The weights' fragment views: in shared memory where resident, else in
// the head's pack in global memory (the same constructor either way).
using W1View = std::conditional_t<RESIDENT, RowsPlain<W1_LD>, RowsPlain<K1>>;
using W2View = std::conditional_t<RESIDENT, RowsSwz<H>, RowsPlain<H>>;

// Named barriers (0 is __syncthreads): the MMA warps' own, and per group
// READY (its state stepped, MMA warps wait) and MEANS (its partial means
// written, its physics warp waits).
constexpr int BAR_MMA = 1, BAR_READY = 2, BAR_MEANS = 4;
constexpr int HANDOFF = MMA_THREADS + 32;

static_assert(H == 32 || H == 64 || H == 128 || H == 256, "the instantiated widths");
static_assert(ROWS * SLD <= 2 * K1 * SLD, "the inputs' buffers cover the state");
static_assert(S_W2 % 4 == 0 && S_ST % 4 == 0 && S_XS % 4 == 0 && S_H1 % 4 == 0 &&
              S_HP % 4 == 0 && S_H1C % 4 == 0 && S_HPC % 4 == 0 && SLD % 4 == 0 &&
              PACK % 4 == 0, "16-byte alignment");
static_assert(SLD % 32 == 8 && XLD % 32 == 8,
              "ColsPlain reads conflict-free at a stride of 8 mod 32");
static_assert(SMEM_BYTES <= 232448, "more shared memory than a CTA may have");
static_assert(TILE == 2 * GROUP && GROUP == 32 && MMA_WARPS == 8 && L_TM % 16 == 0 &&
              L_TN % 8 == 0 && R_TM % 16 == 0 && R_TN % 8 == 0, "warp tilings assume these");

// One head's weights into shared memory from its pack W: W3 and the biases
// (W3 and b3 with zero rows past the head's outputs, as packed), and where
// resident W1 (inputs 75-79 zero, as packed) and W2 swizzled.
__device__ __forceinline__ void load_head(float* sm, const float* __restrict__ W) {
  const int tid = threadIdx.x;
  if constexpr (RESIDENT) {
    for (int e = tid; e < H * W1_LD; e += THREADS) {
      const int j = e / W1_LD, f = e % W1_LD;
      sm[S_W1 + e] = f < K1 ? __ldg(W + P_W1 + j * K1 + f) : 0.f;
    }
    for (int e = tid; e < H * H; e += THREADS) {
      const int j = e / H, i = e % H;
      sm[S_W2 + j * H + (i ^ swz(j))] = __ldg(W + P_W2 + e);
    }
  }
  for (int e = tid; e < NA * H; e += THREADS) sm[S_W3 + e] = __ldg(W + P_W3 + e);
  for (int e = tid; e < 2 * H + NA; e += THREADS) sm[S_B1 + e] = __ldg(W + P_B1 + e);
}

// A hidden layer on the warp's MT x NT tiles of 16 x 8 at rows m0, units n0
// of the output: h[r][j] = tanh(sum_k A(r, k) B(k, j) + bias[j]), stored
// split for the next layer's A: its hi parts in dst [rows][H] swizzled, its
// lo parts at dst + lo_offset.
template <int MT, int NT, class VA, class VB>
__device__ __forceinline__ void hidden_tanh(const VA& a, const VB& b, int steps,
                                            const float* bias, int m0, int n0, float* dst,
                                            int lo_offset) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float acc[MT][NT][4];
  ppo_grad::zero(acc);
  ppo_grad::warp_mma<MT, NT, UNROLL>(acc, a, b, steps);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int j = n0 + 8 * nt + 2 * t;
    const float c0 = bias[j], c1 = bias[j + 1];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = m0 + 16 * mt + g + 8 * hh;
        const float2 p0 = split_store(tanhf(acc[mt][nt][2 * hh] + c0));
        const float2 p1 = split_store(tanhf(acc[mt][nt][2 * hh + 1] + c1));
        float* d = dst + r * H + (j ^ swz(r));
        *reinterpret_cast<float2*>(d) = make_float2(p0.x, p1.x);
        *reinterpret_cast<float2*>(d + lo_offset) = make_float2(p0.y, p1.y);
      }
  }
}

// The last hidden layer and the head's share of this warp: h = tanh(A B +
// bias) stays in the accumulators, and for each of the warp's rows r and
// outputs o < NO the sum over its units j of h[r][j] W3[o][j], summed over
// the 4 lanes of a row, goes to part[(slot * NO + o) * rows + r].
template <int MT, int NT, int NO, class VA, class VB>
__device__ __forceinline__ void hidden_head(const VA& a, const VB& b, int steps,
                                            const float* bias, const float* w3, int m0,
                                            int n0, int slot, int rows, float* part) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float acc[MT][NT][4];
  ppo_grad::zero(acc);
  ppo_grad::warp_mma<MT, NT, UNROLL>(acc, a, b, steps);
  float s[MT][2][NO];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int o = 0; o < NO; ++o) s[mt][hh][o] = 0.f;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int j = n0 + 8 * nt + 2 * t;
    const float c0 = bias[j], c1 = bias[j + 1];
    float2 w[NO];
#pragma unroll
    for (int o = 0; o < NO; ++o) w[o] = *reinterpret_cast<const float2*>(w3 + o * H + j);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float h0 = tanhf(acc[mt][nt][2 * hh] + c0);
        const float h1 = tanhf(acc[mt][nt][2 * hh + 1] + c1);
#pragma unroll
        for (int o = 0; o < NO; ++o) s[mt][hh][o] = fmaf(h1, w[o].y, fmaf(h0, w[o].x, s[mt][hh][o]));
      }
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int o = 0; o < NO; ++o) {
        float v = s[mt][hh][o];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if (t == 0) part[(slot * NO + o) * rows + m0 + 16 * mt + g + 8 * hh] = v;
      }
}

// Chunk t of the critic's inputs, obs rows [t][0:75][b0:b0+64], into X
// [K1][SLD] (envs past the tile's nval zero) by cp.async: 16-byte copies
// where the rows allow (B % 4 == 0), else 4-byte ones.
__device__ __forceinline__ void stage_obs(float* X, const float* obs, int t, int B, int b0,
                                          int nval) {
  const float* src = obs + (size_t)t * OBS * B + b0;
  const bool vec = (B & 3) == 0;
  for (int idx = threadIdx.x; idx < OBS * (TILE / 4); idx += THREADS) {
    const int k = idx / (TILE / 4), c = 4 * (idx % (TILE / 4));
    float* dst = X + k * SLD + c;
    const float* s = src + (size_t)k * B + c;
    if (vec && c + 4 <= nval) {
      ppo_grad::cp_async16(dst, s);
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (c + u < nval) ppo_grad::cp_async4(dst + u, s + u);
        else dst[u] = 0.f;
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
rollout_kernel(const float* __restrict__ s0, const float* __restrict__ noise,
               const float* __restrict__ pool, const float* __restrict__ pack,
               float* __restrict__ obs_out, float* __restrict__ misc_out,
               float* __restrict__ s_out, int B, int T, int P, const Consts C,
               float action_std, float lp_const) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* S = sm + S_ST;   // [ROWS][SLD] packed state of the tile
  float* HP = sm + S_HP;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b0 = blockIdx.x * TILE;
  const int nval = min(TILE, B - b0);

  load_head(sm, pack);
  for (int idx = tid; idx < ROWS * TILE; idx += THREADS) {
    const int r = idx / TILE, e = idx % TILE;
    S[r * SLD + e] = e < nval ? s0[(size_t)r * B + b0 + e] : 0.0f;
  }
  __syncthreads();

  if (warp < MMA_WARPS) {
    // The MMA warps: group 0's products, then group 1's, T times.
    const int m0 = L_TM * (warp % L_WM), slot = warp / L_WM, n0 = L_TN * slot;
    const float* w1 = RESIDENT ? sm + S_W1 : pack + P_W1;
    const float* w2 = RESIDENT ? sm + S_W2 : pack + P_W2;
    for (int h = 0; h < 2 * T; ++h) {
      const int grp = h & 1, c0 = GROUP * grp;
      bar_sync(BAR_READY + grp, HANDOFF);
      // (1) the group's observations (the featurizer window before the
      // step), split once for the 8 warps; inputs 75-79 zero
      for (int idx = tid; idx < K1 * GROUP; idx += MMA_THREADS) {
        const int k = idx / GROUP, e = idx % GROUP;
        const float2 x = split_store(k < OBS ? S[(R_HIST + k) * SLD + c0 + e] : 0.0f);
        sm[S_XS + k * XLD + e] = x.x;
        sm[S_XS + K1 * XLD + k * XLD + e] = x.y;
      }
      bar_sync(BAR_MMA, MMA_THREADS);
      // (2) layer 1, each warp L_TM of the group's envs x L_TN units
      hidden_tanh<L_MT, L_NT>(Split<ColsPlain<XLD>>(sm + S_XS, K1 * XLD, m0), W1View(w1, n0),
                              K1 / 8, sm + S_B1, m0, n0, sm + S_H1, GROUP * H);
      bar_sync(BAR_MMA, MMA_THREADS);
      // (3) layer 2 and each warp's share of the 4 means
      hidden_head<L_MT, L_NT, NA>(Split<RowsSwz<H>>(sm + S_H1, GROUP * H, m0), W2View(w2, n0),
                                  H / 8, sm + S_B2, sm + S_W3, m0, n0, slot, GROUP,
                                  HP + grp * HP_GROUP);
      bar_arrive(BAR_MEANS + grp, HANDOFF);
    }
  } else {
    // (4) a physics warp: its group's sampling, step, record and reset, one
    // thread per env.
    const int grp = warp - MMA_WARPS, e = GROUP * grp + lane;
    const bool valid = e < nval;
    const size_t col = (size_t)b0 + e;
    float* s = S + e;
    const float* part = HP + grp * HP_GROUP + lane;
    float eps[NA];
#pragma unroll
    for (int o = 0; o < NA; ++o) eps[o] = valid && T > 0 ? noise[(size_t)o * B + col] : 0.0f;
    if (T > 0) bar_arrive(BAR_READY + grp, HANDOFF);
    for (int t = 0; t < T; ++t) {
      // its observation: the featurizer window before the step
      if (valid) {
        float* o = obs_out + (size_t)t * OBS * B + col;
        for (int r = 0; r < OBS; ++r) o[(size_t)r * B] = s[(R_HIST + r) * SLD];
      }
      float next[NA];
#pragma unroll
      for (int o = 0; o < NA; ++o)
        next[o] = valid && t + 1 < T ? noise[((size_t)(t + 1) * NA + o) * B + col] : 0.0f;
      bar_sync(BAR_MEANS + grp, HANDOFF);
      float a_raw[NA], lp[NA];
#pragma unroll
      for (int o = 0; o < NA; ++o) {
        float m = part[o * GROUP];
#pragma unroll
        for (int w = 1; w < L_WN; ++w) m += part[(w * NA + o) * GROUP];
        a_raw[o] = tanhf(m + sm[S_B3 + o]) + action_std * eps[o];
        lp[o] = -0.5f * eps[o] * eps[o] - lp_const;
      }
      float reward, done, solved;
      step_env<SLD>(s, a_raw, C, reward, done, solved);
      if (valid) {
        float* m = misc_out + (size_t)t * MISC * B + col;
#pragma unroll
        for (int o = 0; o < NA; ++o) {
          m[(size_t)o * B] = a_raw[o];
          m[(size_t)(4 + o) * B] = lp[o];
          m[(size_t)(12 + o) * B] = 0.0f;
        }
        m[(size_t)9 * B] = reward;
        m[(size_t)10 * B] = done;
        m[(size_t)11 * B] = solved;
      }
      const float slot = s[R_SLOT * SLD];
      if (done > 0.5f && valid) {
        const int p = (int)fmodf(slot, (float)P);
        const float* fresh = pool + (size_t)p * ROWS * B + col;
        for (int r = 0; r < ROWS; ++r) s[r * SLD] = fresh[(size_t)r * B];
      }
      s[R_SLOT * SLD] = slot + done;
#pragma unroll
      for (int o = 0; o < NA; ++o) eps[o] = next[o];
      __syncwarp();
      if (t + 1 < T) bar_arrive(BAR_READY + grp, HANDOFF);
    }
  }
  __threadfence();  // the loop's obs stores, before the critic pass reads them back
  __syncthreads();

  for (int idx = tid; idx < ROWS * TILE; idx += THREADS) {
    const int r = idx / TILE, e = idx % TILE;
    if (e < nval) s_out[(size_t)r * B + b0 + e] = S[r * SLD + e];
  }
  load_head(sm, pack + PACK);
  __syncthreads();

  // (5) the critic over the T observation chunks of the tile: misc row 8.
  float* X = sm + S_ST;  // [2][K1][SLD]; inputs 75-79 zero
  for (int idx = tid; idx < 2 * (K1 - OBS) * SLD; idx += THREADS) {
    const int buf = idx / ((K1 - OBS) * SLD), rest = idx % ((K1 - OBS) * SLD);
    X[buf * K1 * SLD + OBS * SLD + rest] = 0.0f;
  }
  if (T > 0) {
    stage_obs(X, obs_out, 0, B, b0, nval);
    ppo_grad::cp_async_commit();
  }
  for (int t = 0; t < T; ++t) {
    ppo_grad::cp_async_wait_all();
    __syncthreads();  // chunk t staged; last chunk's values read from HP
    if (t + 1 < T) {
      stage_obs(X + ((t + 1) & 1) * K1 * SLD, obs_out, t + 1, B, b0, nval);
      ppo_grad::cp_async_commit();
    }
    if (warp < MMA_WARPS) {
      const int m0 = R_TM * (warp % R_WM), slot = warp / R_WM, n0 = R_TN * slot;
      const float* v1 = RESIDENT ? sm + S_W1 : pack + PACK + P_W1;
      const float* v2 = RESIDENT ? sm + S_W2 : pack + PACK + P_W2;
      hidden_tanh<R_MT, R_NT>(ColsPlain<SLD>(X + (t & 1) * K1 * SLD, m0), W1View(v1, n0),
                              K1 / 8, sm + S_B1, m0, n0, sm + S_H1C, TILE * H);
      bar_sync(BAR_MMA, MMA_THREADS);
      hidden_head<R_MT, R_NT, 1>(Split<RowsSwz<H>>(sm + S_H1C, TILE * H, m0), W2View(v2, n0),
                                 H / 8, sm + S_B2, sm + S_W3, m0, n0, slot, TILE, sm + S_HPC);
    }
    __syncthreads();
    if (warp >= MMA_WARPS) {
      const int e = tid - MMA_THREADS;
      const float* hp = sm + S_HPC;
      if (e < nval) {
        float v = hp[e];
        for (int w = 1; w < R_WN; ++w) v += hp[w * TILE + e];
        misc_out[((size_t)t * MISC + 8) * B + b0 + e] = v + sm[S_B3];
      }
    }
  }
}

}  // namespace

extern "C" {

// Launches the rollout on `stream` and returns cudaGetLastError(): a launch
// the card refuses (too much shared memory, bad configuration) never runs
// and is reported only here. `pack` holds the actor's and the critic's
// weight packs (2, PACK), zero-padded to this library's width.
int rollout_fused(const float* s0, const float* noise, const float* pool, const float* pack,
                  float* obs, float* misc, float* s_final, int B, int T, int P,
                  const Consts* consts, float action_std, float lp_const, int device,
                  void* stream) {
  // This library carries its own CUDA runtime, whose current device is not
  // the caller's: select the tensors' device before launching.
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0) return 0;
  err = cudaFuncSetAttribute(rollout_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (B + TILE - 1) / TILE;
  rollout_kernel<<<blocks, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      s0, noise, pool, pack, obs, misc, s_final, B, T, P, *consts, action_std, lp_const);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of one CTA, in bytes.
int rollout_fused_smem_bytes() { return SMEM_BYTES; }

// This library's hidden width and the floats of one head's weight pack.
int rollout_fused_width() { return H; }
int rollout_fused_pack_floats() { return PACK; }

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
