// Whole-rollout kernel for models wider than 256 hidden units, for Hopper
// (sm_90a): T env steps of B hover envs, each step the actor forward,
// Gaussian sampling, RK4 physics, reward, termination and auto-reset from a
// P-deep pool; then the critic over every observation of the rollout.
//
// Replaces the TPU kernel `ops/rollout_fused.py:fused_rollout` of the JAX
// package at those widths, beside `rollout_fused.cu` (the narrow design, up
// to 256, whose env step `rollout_physics.cuh` both share); computes what
// the port's `ops/rollout_fused.py:rollout_plain` computes.
//
// Any width that is a multiple of 128 runs, set at run time: a model of hr
// units runs zero-padded on hp = hr rounded up to 128 (a padded unit's
// activation is tanh(0) = 0, so it adds exact zeros).
//
// Bound. At B = 8192, T = 256, H = 512 the forward passes are 2.53e12 f32
// FLOP (1,207,296 per env-step, actor and critic): 37.8 ms on the H100's
// 67 TFLOP/s of f32 CUDA cores, by operations; 15.3 ms on the tensor cores
// in 3xTF32 (three TF32 products per f32 product, 495 TFLOP/s). The
// physics is under 0.1% of the FLOP.
//
// Design. Why not the narrow one: it keeps a tile of 64 envs for all T
// steps in one CTA and reads W2 from shared memory (to H = 128) or, at 256,
// every fragment from global memory through L1 and L2. At H = 512 W2 is 1
// MB a head (4 MB at 1024), and a 64-env tile's split h1 256 KB: neither
// fits a CTA's 227 KB. Choice: weights streamed through shared memory, not
// a thread-block cluster. A cluster of 8 CTAs sharing a tile would keep
// 128 KB of W2 per CTA resident at H = 512, but at 1024 a CTA's eighth of
// W2 is 512 KB, so 1024 needs streaming anyway; one streamed design serves
// every width.
// * A CTA owns TILE envs for all T steps, their packed state in shared
//   memory; nothing crosses CTAs. The tile's h1 (f32) stays in shared
//   memory while it fits: 64 envs to H = 512, 32 to 1152 (`design_for`:
//   the 32-env tiles only while their CTAs fit one wave). Otherwise h1 goes
//   to the CTA's own scratch in device memory ([TILE][hp], the wrapper's
//   buffer) and the tile is 64 envs: layer 1's epilogue writes it, and
//   layer 2 reads it back through the same ring as its weights, each ring
//   slot then holding the tile's 16-deep h1 chunk beside W2's. Per step
//   that is TILE x hp floats out and back against the hp^2 floats of W2
//   that every CTA streams anyway (at H = 4096 W2 is 64 MB a head, more
//   than L2 holds, so that stream comes from device memory).
// * Each step 8 MMA warps run the actor's two layers over the tile: the
//   weights pass through shared memory in chunks of 128 units x 16 depth
//   (W1's rows, then W2's), a 3-deep ring of cp.async copies that runs on
//   across layers and steps (the next step's first chunks load while the
//   physics runs). Each warp owns TILE/2 envs x 32 units of a chunk's 128:
//   layer 1's tanh goes to h1 (rows padded so that fragment reads hit 32
//   banks), layer 2's tanh stays in the accumulators, from which each
//   thread forms its units' share of the 4 means; the lanes and the 4
//   warps along the units sum them in a fixed order. 3xTF32 on mma.sync as
//   in `mma_tf32.cuh`, each operand split as it is read.
// * Then TILE / 32 physics warps, one thread an env, sample, step, record
//   and reset (`rollout_physics.cuh`), while the MMA warps wait: the steps
//   do not overlap (the narrow kernel's two-group overlap needs two h1
//   tiles, which do not fit).
// * Only the actor is in the closed loop. The critic runs after it as a
//   second kernel in the same call, a CTA per (tile, timesteps y, y +
//   gridDim.y, ...) over the stored observations, through the same
//   streamed forward (one timestep a CTA while h1 stays in shared memory;
//   with h1 in device memory gridDim.y is cut to about two CTAs an SM, so
//   that the scratch stays (blocks x gridDim.y) x TILE x hp floats).
//
// Shared memory (bytes) at TILE = 64, H = 512: the state 36,864, X^T
// (96 x 72) 27,648, h1 (64 x 516) 132,096, the weight ring 30,720, the
// partial means 4,096: 231,424 of the 232,448 a CTA may have; at TILE =
// 32, H = 1024, 200,192; with h1 in device memory (TILE = 64, any width)
// 114,688.
//
// Offsets are 32-bit within the pack (hp^2 + 100 hp floats a head:
// `ops/rollout_fused.py:_launch` refuses, naming the bytes, a width past
// them), 64-bit across the scratch and the outputs.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "mma_tf32.cuh"
#include "rollout_physics.cuh"

namespace {

using namespace rollout;
using ppo_grad::ColsPlain;
using ppo_grad::RowsPlain;
using ppo_grad::RowsPlainRt;

constexpr int K1 = 96;            // OBS padded to the wide kernels' depth; W1's inputs 75.. zero
constexpr int HT = 128;           // units of a streamed chunk; widths run padded to a multiple
constexpr int BKW = 16;           // depth of a streamed chunk
constexpr int WLD = BKW + 4;      // its rows' stride: 20 = the lanes' 32 distinct banks
constexpr int STAGES = 3;
constexpr int CHUNK_FLOATS = HT * WLD;
constexpr int MMA_WARPS = 8, MMA_THREADS = 32 * MMA_WARPS;
constexpr int WN = 4;             // warps along a chunk's units (32 each), 2 along the envs
constexpr int BAR_MMA = 1;
constexpr int SMEM_MAX = 232448;

__host__ __device__ constexpr int padded(int hr) { return (hr + HT - 1) / HT * HT; }

// One head's weight pack at width hp (floats), as `ops/rollout_fused.py:
// weight_pack` builds it with depth K1: W1 (hp, K1), W2 (hp, hp), W3 (NA,
// hp) with zero rows past the head's outputs, b1, b2 (hp), b3 (NA).
struct Pack {
  int w1, w2, w3, b1, b2, b3, size;
};
__host__ __device__ constexpr Pack make_pack(int hp) {
  return Pack{0,
              hp * K1,
              hp * K1 + hp * hp,
              hp * K1 + hp * hp + NA * hp,
              hp * K1 + hp * hp + NA * hp + hp,
              hp * K1 + hp * hp + NA * hp + 2 * hp,
              hp * K1 + hp * hp + NA * hp + 2 * hp + NA};
}

// Shared memory (floats) of a CTA of TILE envs at width hp: the packed
// state [ROWS][SLD] (the loop kernel only), X^T [K1][SLD], h1 [TILE][hp +
// 4] (unless H1G: h1 in device memory), the weight ring [STAGES][SLOT], the
// partial means [WN][NA][TILE]. A ring slot is a weight chunk [HT][WLD],
// and with H1G the tile's h1 chunk [TILE][WLD] after it.
template <int TILE, bool H1G>
struct Smem {
  static constexpr int SLD = TILE + 8;  // 8 mod 32: ColsPlain reads conflict-free
  static constexpr int SLOT = CHUNK_FLOATS + (H1G ? TILE * WLD : 0);
  int st, x, h1, w, part, floats;
  __host__ __device__ Smem(int hp, bool state) {
    st = 0;
    x = state ? ROWS * SLD : 0;
    h1 = x + K1 * SLD;
    w = h1 + (H1G ? 0 : TILE * (hp + 4));
    part = w + STAGES * SLOT;
    floats = part + WN * NA * TILE;
  }
};

// The design a width runs on at B envs on `sms` SMs: h1 in shared memory
// with 64 envs a tile to 512 units; wider, 32-env tiles with h1 in shared
// memory where the loop kernel's shared memory holds it (to 1152) and
// their CTAs fit one wave (B <= 32 sms), else 64-env tiles with h1 in
// device memory. Each design runs one CTA an SM. A 64-env tile took 1.22
// times as long as a 32-env tile, so 32-env tiles win while they need no
// second wave, and 64-env tiles, with half the waves, win above that. At
// 768 and 1024 units on an NVIDIA H100 80GB HBM3 (700 W,
// `scripts/kernel_turns.py`), 32-env against 64-env tiles: 14.3 against
// 17.8 ms and 24.4 against 29.8 ms at 1024 x 32; 338.5 against 208.7 ms
// and 582.3 against 356.5 ms at 8192 x 256.
enum Design { SMEM64, SMEM32, GLOBAL64 };
inline Design design_for(int hp, int B, int sms) {
  if (hp <= 512) return SMEM64;
  const bool fits = Smem<32, false>(hp, true).floats * 4 <= SMEM_MAX;
  return fits && B <= 32 * sms ? SMEM32 : GLOBAL64;
}

static_assert(K1 % BKW == 0 && K1 >= OBS && WLD % 4 == 0 && CHUNK_FLOATS % 4 == 0, "chunks");

// The stream of weight chunks: chunk c of a head's forward pass (per = hp
// / 128 x (K1 + hp) / 16 of them) is, in order, W1's chunks (units n x 128..,
// inputs kc x 16..) and then W2's. Chunk c into ring slot c % STAGES by the
// MMA threads, 2 16-byte copies each; with H1G a W2 chunk also brings the
// tile's h1 at its depth (TILE x 16 floats of the CTA's scratch h1g
// [TILE][hp]), one copy more each at TILE = 64.
template <int TILE, bool H1G>
__device__ __forceinline__ void load_chunk(float* ring, const float* W, const float* h1g,
                                           const Pack& pk, int hp, long long c, int per) {
  const int j = (int)(c % per), ntl = hp / HT, n1 = ntl * (K1 / BKW);
  float* dst = ring + (c % STAGES) * Smem<TILE, H1G>::SLOT;
  const float* src;
  int ld;
  if (j < n1) {
    src = W + pk.w1 + (size_t)(j / (K1 / BKW)) * HT * K1 + (j % (K1 / BKW)) * BKW;
    ld = K1;
  } else {
    const int j2 = j - n1, nk = hp / BKW;
    src = W + pk.w2 + (size_t)(j2 / nk) * HT * hp + (j2 % nk) * BKW;
    ld = hp;
    if constexpr (H1G) {
      const float* h = h1g + (j2 % nk) * BKW;
      for (int u = threadIdx.x; u < TILE * BKW / 4; u += MMA_THREADS) {
        const int row = u >> 2, q = (u & 3) * 4;
        ppo_grad::cp_async16(dst + CHUNK_FLOATS + row * WLD + q, h + (size_t)row * hp + q);
      }
    }
  }
  for (int u = threadIdx.x; u < HT * BKW / 4; u += MMA_THREADS) {
    const int row = u >> 2, q = (u & 3) * 4;
    ppo_grad::cp_async16(dst + row * WLD + q, src + (size_t)row * ld + q);
  }
}

// One head's forward over the TILE inputs X^T (rows OBS.. zero), by the MMA
// warps: h1 = tanh(W1 x + b1) into h1 (shared memory, or with H1G the CTA's
// scratch h1g, read back through the ring), h2 = tanh(W2 h1 + b2) in the
// accumulators, and each warp's share of the head's NO outputs sum_j
// h2[r][j] W3[o][j] over its units, summed over the lanes of a row, into
// hpart[(wn * NA + o) * TILE + r]. The chunks run c.. on the ring, whose
// copies run ahead to chunk c_end - 1; the caller has issued chunks up to c +
// STAGES - 2. With H1G, W2 chunk k's copy (issued two chunks ahead) reads
// the h1 columns of W1's output tile k / 8, whose epilogue ran at least a
// barrier before (W1 has 6 chunks a tile and at least 2 tiles).
template <int TILE, int NO, bool H1G>
__device__ void forward(float* sm, const Smem<TILE, H1G>& L, const float* __restrict__ W,
                        float* h1g, int hp, long long& c, long long c_end) {
  constexpr int SLD = Smem<TILE, H1G>::SLD, MT = TILE / 32, SLOT = Smem<TILE, H1G>::SLOT;
  const Pack pk = make_pack(hp);
  const int per = (hp / HT) * ((K1 + hp) / BKW), n1 = (hp / HT) * (K1 / BKW);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wm = warp & 1, wn = warp >> 1, m0 = wm * (TILE / 2);
  const float* X = sm + L.x;
  float* H1 = H1G ? h1g : sm + L.h1;
  float* ring = sm + L.w;
  const int hld = H1G ? hp : hp + 4;
  float acc[MT][4][4];
  float s[MT][2][NO];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int o = 0; o < NO; ++o) s[mt][hh][o] = 0.f;
  for (int j = 0; j < per; ++j, ++c) {
    ppo_grad::cp_async_wait<STAGES - 2>();
    rollout::bar_sync(BAR_MMA, MMA_THREADS);  // chunk c landed; chunk c - 1's slot and h1 done
    if (c + STAGES - 1 < c_end)
      load_chunk<TILE, H1G>(ring, W, h1g, pk, hp, c + STAGES - 1, per);
    ppo_grad::cp_async_commit();
    const float* wb = ring + (c % STAGES) * SLOT;
    const bool first = j < n1;
    const int nk = first ? K1 / BKW : hp / BKW;
    const int jj = first ? j : j - n1, kc = jj % nk, n0 = (jj / nk) * HT + 32 * wn;
    if (kc == 0) ppo_grad::zero(acc);
    if (first) {
      ppo_grad::warp_mma(acc, ColsPlain<SLD>(X + kc * BKW * SLD, m0),
                         RowsPlain<WLD>(wb, 32 * wn), BKW / 8);
    } else {
      if constexpr (H1G) {
        ppo_grad::warp_mma(acc, RowsPlain<WLD>(wb + CHUNK_FLOATS, m0),
                           RowsPlain<WLD>(wb, 32 * wn), BKW / 8);
      } else {
        ppo_grad::warp_mma(acc, RowsPlainRt(H1 + kc * BKW, hld, m0),
                           RowsPlain<WLD>(wb, 32 * wn), BKW / 8);
      }
    }
    if (kc != nk - 1) continue;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = n0 + 8 * nt + 2 * t;
      const float2 b = __ldg(reinterpret_cast<const float2*>(W + (first ? pk.b1 : pk.b2) + col));
      float2 w3[NO];
#pragma unroll
      for (int o = 0; o < NO; ++o)
        w3[o] = __ldg(reinterpret_cast<const float2*>(W + pk.w3 + o * hp + col));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = m0 + 16 * mt + g + 8 * hh;
          const float h0 = tanhf(acc[mt][nt][2 * hh] + b.x);
          const float h1 = tanhf(acc[mt][nt][2 * hh + 1] + b.y);
          if (first) {
            *reinterpret_cast<float2*>(H1 + r * hld + col) = make_float2(h0, h1);
          } else {
#pragma unroll
            for (int o = 0; o < NO; ++o)
              s[mt][hh][o] = fmaf(h1, w3[o].y, fmaf(h0, w3[o].x, s[mt][hh][o]));
          }
        }
    }
  }
  float* hpart = sm + L.part;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int o = 0; o < NO; ++o) {
        float v = s[mt][hh][o];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if (t == 0) hpart[(wn * NA + o) * TILE + m0 + 16 * mt + g + 8 * hh] = v;
      }
}

// The rollout loop; with H1G the CTA's h1 at scratch + blockIdx.x x TILE x hp.
template <int TILE, bool H1G>
__global__ void __launch_bounds__(MMA_THREADS + TILE, 1)
rollout_kernel(const float* __restrict__ s0, const float* __restrict__ noise,
               const float* __restrict__ pool, const float* __restrict__ pack,
               float* __restrict__ obs_out, float* __restrict__ misc_out,
               float* __restrict__ s_out, int B, int T, int P, const Consts C,
               float action_std, float lp_const, int hp, float* __restrict__ scratch) {
  constexpr int SLD = Smem<TILE, H1G>::SLD, THREADS = MMA_THREADS + TILE;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const Smem<TILE, H1G> L(hp, true);
  float* S = sm + L.st;
  float* X = sm + L.x;
  float* h1g = H1G ? scratch + (size_t)blockIdx.x * TILE * hp : nullptr;
  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * TILE;
  const int nval = min(TILE, B - b0);
  const Pack pk = make_pack(hp);
  const long long per = (hp / HT) * ((K1 + hp) / BKW), c_end = per * T;
  long long c = 0;

  for (int idx = tid; idx < ROWS * TILE; idx += THREADS) {
    const int r = idx / TILE, e = idx % TILE;
    S[r * SLD + e] = e < nval ? s0[(size_t)r * B + b0 + e] : 0.0f;
  }
  for (int idx = tid; idx < (K1 - OBS) * SLD; idx += THREADS) X[OBS * SLD + idx] = 0.f;
  if (tid < MMA_THREADS) {
    for (int k = 0; k < STAGES - 1; ++k) {
      if (k < c_end) load_chunk<TILE, H1G>(sm + L.w, pack, h1g, pk, hp, k, (int)per);
      ppo_grad::cp_async_commit();
    }
  }
  __syncthreads();
  // A physics thread's env.
  const int e = tid - MMA_THREADS;
  const bool valid = e >= 0 && e < nval;
  const size_t col = (size_t)b0 + e;
  float* s = S + e;
  for (int t = 0; t < T; ++t) {
    float eps[NA];
    if (tid < MMA_THREADS) {
      // the observations (the featurizer window before the step), then
      // the actor's forward
      for (int idx = tid; idx < OBS * TILE; idx += MMA_THREADS) {
        const int k = idx / TILE, i = idx % TILE;
        X[k * SLD + i] = S[(R_HIST + k) * SLD + i];
      }
      forward<TILE, NA, H1G>(sm, L, pack, h1g, hp, c, c_end);
    } else if (valid) {
      float* o = obs_out + (size_t)t * OBS * B + col;
      for (int r = 0; r < OBS; ++r) o[(size_t)r * B] = s[(R_HIST + r) * SLD];
#pragma unroll
      for (int a = 0; a < NA; ++a) eps[a] = noise[((size_t)t * NA + a) * B + col];
    }
    __syncthreads();  // the partial means written
    if (tid >= MMA_THREADS) {
      const float* part = sm + L.part + e;
      float a_raw[NA], lp[NA];
#pragma unroll
      for (int a = 0; a < NA; ++a) {
        if (!valid) eps[a] = 0.f;
        float m = part[a * TILE];
#pragma unroll
        for (int w = 1; w < WN; ++w) m += part[(w * NA + a) * TILE];
        a_raw[a] = tanhf(m + __ldg(pack + pk.b3 + a)) + action_std * eps[a];
        lp[a] = -0.5f * eps[a] * eps[a] - lp_const;
      }
      float reward, done, solved;
      step_env<SLD>(s, a_raw, C, reward, done, solved);
      if (valid) {
        float* m = misc_out + (size_t)t * MISC * B + col;
#pragma unroll
        for (int a = 0; a < NA; ++a) {
          m[(size_t)a * B] = a_raw[a];
          m[(size_t)(4 + a) * B] = lp[a];
          m[(size_t)(12 + a) * B] = 0.0f;
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
    }
    __syncthreads();  // the state stepped
  }
  ppo_grad::cp_async_wait_all();
  for (int idx = tid; idx < ROWS * TILE; idx += THREADS) {
    const int r = idx / TILE, i = idx % TILE;
    if (i < nval) s_out[(size_t)r * B + b0 + i] = S[r * SLD + i];
  }
}

// The critic over the observations of envs blockIdx.x x TILE.. at
// timesteps blockIdx.y, blockIdx.y + gridDim.y, ...: misc row 8; with H1G
// the CTA's h1 at scratch + (blockIdx.y x gridDim.x + blockIdx.x) x TILE x
// hp.
template <int TILE, bool H1G>
__global__ void __launch_bounds__(MMA_THREADS, 1)
critic_kernel(const float* __restrict__ obs, const float* __restrict__ pack,
              float* __restrict__ misc_out, int B, int T, int hp, float* __restrict__ scratch) {
  constexpr int SLD = Smem<TILE, H1G>::SLD;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const Smem<TILE, H1G> L(hp, false);
  const int tid = threadIdx.x, b0 = blockIdx.x * TILE;
  const int nval = min(TILE, B - b0);
  const Pack pk = make_pack(hp);
  const float* W = pack + pk.size;
  float* h1g = H1G ? scratch + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * TILE * hp
                   : nullptr;
  const long long per = (hp / HT) * ((K1 + hp) / BKW);
  float* X = sm + L.x;
  for (int t = blockIdx.y; t < T; t += gridDim.y) {
    long long c = 0;
    for (int k = 0; k < STAGES - 1; ++k) {
      if (k < per) load_chunk<TILE, H1G>(sm + L.w, W, h1g, pk, hp, k, (int)per);
      ppo_grad::cp_async_commit();
    }
    const float* src = obs + (size_t)t * OBS * B + b0;
    for (int idx = tid; idx < K1 * TILE; idx += MMA_THREADS) {
      const int k = idx / TILE, i = idx % TILE;
      X[k * SLD + i] = k < OBS && i < nval ? src[(size_t)k * B + i] : 0.f;
    }
    forward<TILE, 1, H1G>(sm, L, W, h1g, hp, c, per);
    ppo_grad::cp_async_wait_all();
    __syncthreads();
    if (tid < nval) {
      const float* part = sm + L.part + tid;
      float v = part[0];
#pragma unroll
      for (int w = 1; w < WN; ++w) v += part[w * NA * TILE];
      misc_out[((size_t)t * MISC + 8) * B + b0 + tid] = v + __ldg(W + pk.b3);
    }
    __syncthreads();  // the means read, X and the ring free for the next timestep
  }
}

// The critic's gridDim.y: a CTA a timestep while h1 stays in shared memory;
// with h1 in device memory about two CTAs an SM, each over several
// timesteps, so that the scratch stays small.
inline int critic_rows(Design d, int blocks, int T, int sms) {
  if (d != GLOBAL64) return T;
  const int y = (2 * sms + blocks - 1) / blocks;
  return y < 1 ? 1 : (y > T ? T : y);
}

template <int TILE, bool H1G>
cudaError_t launch(const float* s0, const float* noise, const float* pool, const float* pack,
                   float* obs, float* misc, float* s_final, int B, int T, int P,
                   const Consts& C, float action_std, float lp_const, int hp, float* scratch,
                   int critic_y, cudaStream_t s) {
  const int loop_bytes = Smem<TILE, H1G>(hp, true).floats * 4;
  const int critic_bytes = Smem<TILE, H1G>(hp, false).floats * 4;
  if (loop_bytes > SMEM_MAX) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(rollout_kernel<TILE, H1G>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, loop_bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(critic_kernel<TILE, H1G>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, critic_bytes);
  if (err != cudaSuccess) return err;
  const int blocks = (B + TILE - 1) / TILE;
  rollout_kernel<TILE, H1G><<<blocks, MMA_THREADS + TILE, loop_bytes, s>>>(
      s0, noise, pool, pack, obs, misc, s_final, B, T, P, C, action_std, lp_const, hp, scratch);
  err = cudaGetLastError();
  if (err != cudaSuccess || T == 0) return err;
  critic_kernel<TILE, H1G><<<dim3(blocks, critic_y), MMA_THREADS, critic_bytes, s>>>(
      obs, pack, misc, B, T, hp, scratch);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats of the scratch `rollout_wide` takes for a model of hidden width
// hr at B envs and T steps on a card of `sms` SMs: 0 while h1 stays in
// shared memory, else h1 of each loop CTA and critic CTA ([TILE][hp]).
long long rollout_wide_scratch_floats(int hr, int B, int T, int sms) {
  const int hp = padded(hr);
  const Design d = design_for(hp, B, sms);
  if (d != GLOBAL64) return 0;
  const int blocks = (B + 63) / 64, y = critic_rows(d, blocks, T, sms);
  return (long long)blocks * (y < 1 ? 1 : y) * 64 * hp;
}

// Launches the rollout and the critic pass on `stream` for a model of
// hidden width hr (the pack (2, PACK) zero-padded to hr rounded up to 128)
// with `scratch` of rollout_wide_scratch_floats(hr, B, T, sms) floats, and
// returns the first launch error: a launch the card refuses never runs and
// is reported only here. The other arguments are the narrow library's
// (`rollout_fused.cu`).
int rollout_wide(const float* s0, const float* noise, const float* pool, const float* pack,
                 float* obs, float* misc, float* s_final, int B, int T, int P,
                 const Consts* consts, float action_std, float lp_const, int hr, float* scratch,
                 int sms, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (hr < 1) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const int hp = padded(hr);
  const Design d = design_for(hp, B, sms);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == SMEM64)
    return (int)launch<64, false>(s0, noise, pool, pack, obs, misc, s_final, B, T, P, *consts,
                                  action_std, lp_const, hp, scratch, T, s);
  if (d == SMEM32)
    return (int)launch<32, false>(s0, noise, pool, pack, obs, misc, s_final, B, T, P, *consts,
                                  action_std, lp_const, hp, scratch, T, s);
  const int y = critic_rows(d, (B + 63) / 64, T, sms);
  return (int)launch<64, true>(s0, noise, pool, pack, obs, misc, s_final, B, T, P, *consts,
                               action_std, lp_const, hp, scratch, y, s);
}

// The most dynamic shared memory a CTA takes (the loop kernel at 512), in
// bytes.
int rollout_wide_smem_bytes() { return Smem<64, false>(512, true).floats * 4; }

// The floats of one head's weight pack at width hr.
int rollout_wide_pack_floats(int hr) { return make_pack(padded(hr)).size; }

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
