// Device code shared by the two PPO gradient kernels, `ppo_fused_t.cu`
// (B2, transposed batch) and `ppo_fused.cu` (B3 and B4, row-major batch).
// Both compute, over a minibatch of rows, the clipped-surrogate + value loss
// of the port's `agents.ppo.ppo_loss` under the fixed std and the gradients
// of all 12 ActorCritic leaves (75 -> 128 -> 128 -> 4 tanh actor, -> 1
// critic), with the hand-derived backward and the clip-tie convention
// where(surr1 <= surr2, 1, in_band), in_band strict on both sides. They
// differ only in how a chunk of rows reaches shared memory.
//
// Design, common to both:
//
// * The actor and the critic are independent given the rows, so each CTA
//   serves one head (blockIdx.y). Its gradient accumulators (26,884 f32,
//   105 KB) live in shared memory beside one chunk of CHUNK = 32 rows: the
//   observations (32 x 76), the two hidden layers (2 x 32 x 128), the head's
//   outputs and their gradients, about 150 KB in all, so one CTA per SM.
// * G CTAs per head (about half the SMs each) walk the minibatch's chunks
//   with stride G, in order, and write their partial sums to a workspace.
//   A second small kernel sums the G partials of each gradient entry in the
//   order 0..G-1 (no float atomics, so two launches give the same bits) and
//   writes the gradients in the (out, in) layout of `nn.Linear.weight`,
//   biases as (out,).
// * Every product runs on the f32 CUDA cores with register tiles: the
//   forward products and the two backward products through W3 and W2 are
//   out[r][j] = sum_k in[r][k] * M[k][j] with a 4 x 4 (rows x units) tile
//   per thread, M read as float4 through the read-only path (the wrapper
//   passes W1 and W2 transposed for the forward and W2, W3 as they are for
//   the backward); the weight gradients are sum_r g[r][j] * a[r][i] with an
//   8 x 4 tile per thread, added into the accumulators once per chunk.
//
// Bound: 277,248 f32 FLOP per row at hidden 128 against 332 bytes of row
// data, so compute bound on the H100's 67 TFLOP/s of f32 at every shape the
// trainer runs. This first design stays on the CUDA cores in plain f32
// (tensor cores are later work) and re-reads the weights from L1/L2 for
// every chunk.
//
// Math stays accurate (no fast-math): tanhf, expf, IEEE division.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace ppo_grad {

constexpr int OBS = 75;
constexpr int OBS_P = 76;  // padded to a multiple of 4; column 75 is zero
constexpr int H = 128;
constexpr int NA = 4;      // actor outputs; the critic's one output is padded to 4
constexpr int CHUNK = 32;  // rows per chunk
constexpr int THREADS = 256;

// Packed weights of one head (floats), built by the wrapper.
constexpr int P_W1T = 0;                   // [OBS_P][H]  W1 transposed, row 75 zero
constexpr int P_W2T = P_W1T + OBS_P * H;   // [H][H]      W2 transposed
constexpr int P_W2 = P_W2T + H * H;        // [H][H]      W2 (out, in)
constexpr int P_W3 = P_W2 + H * H;         // [NA][H]     W3 (out, in), zero rows pad
constexpr int P_B1 = P_W3 + NA * H;
constexpr int P_B2 = P_B1 + H;
constexpr int P_B3 = P_B2 + H;             // [NA], zero pad
constexpr int PACK = P_B3 + NA;

// Gradient accumulators of one head (floats), (out, in) layout.
constexpr int A_W1 = 0;                    // [H][OBS_P]
constexpr int A_W2 = A_W1 + H * OBS_P;     // [H][H]
constexpr int A_W3 = A_W2 + H * H;         // [NA][H]
constexpr int A_B1 = A_W3 + NA * H;
constexpr int A_B2 = A_B1 + H;
constexpr int A_B3 = A_B2 + H;
constexpr int ACC = A_B3 + NA;             // 26,884
constexpr int NMET = 4;                    // actor sum, critic sum, ratio max, pad
constexpr int ACCS = ACC + NMET;           // one CTA's partial in the workspace

// Shared memory (floats).
constexpr int S_ACC = 0;
constexpr int S_X = S_ACC + ACC;           // [CHUNK][OBS_P]
constexpr int S_H1 = S_X + CHUNK * OBS_P;  // [CHUNK][H]  h1, then g_h1 in place
constexpr int S_H2 = S_H1 + CHUNK * H;     // [CHUNK][H]  h2, then g_h2 in place
constexpr int S_OUT = S_H2 + CHUNK * H;    // [CHUNK][NA] head outputs
constexpr int S_G = S_OUT + CHUNK * NA;    // [CHUNK][NA] output gradients
constexpr int S_AUX = S_G + CHUNK * NA;    // [8][CHUNK]
constexpr int SMEM_FLOATS = S_AUX + 8 * CHUNK;

// Flat output: the 12 gradient leaves in flax leaf order, (out, in)
// kernels and (out,) biases, then the 3 metrics.
constexpr int O_ACTOR = OBS * H + H + H * H + H + NA * H + NA;  // 26,756
constexpr int O_CRITIC = OBS * H + H + H * H + H + H + 1;       // 26,369
constexpr int O_GRADS = O_ACTOR + O_CRITIC;
constexpr int N_OUT = O_GRADS + 3;

static_assert(ACC % 4 == 0 && PACK % 4 == 0 && ACCS % 4 == 0, "float4 alignment");
static_assert((S_X % 4) == 0 && (S_H1 % 4) == 0 && (S_H2 % 4) == 0, "float4 alignment");
static_assert(CHUNK == 32 && THREADS == 256 && H == 128, "tile mappings assume these");

// The loss's constants: 1/std, the logprob's constant 4 (log std +
// log(2 pi) / 2), the clip band's bounds and 1 / minibatch rows.
struct LossConsts {
  float inv_std, lp_const, lo, hi, inv_n;
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

// acc[b][c] = sum_k in[(r0 + b) * in_stride + k] * M[k * H + j0 + c],
// K a multiple of 4. in is shared memory, M global (read-only path).
__device__ __forceinline__ void rowprod(const float* in, int in_stride, int K,
                                        const float* __restrict__ M, int r0, int j0,
                                        float acc[4][4]) {
#pragma unroll
  for (int b = 0; b < 4; ++b)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[b][c] = 0.f;
#pragma unroll 2
  for (int k = 0; k < K; k += 4) {
    float4 a[4], w[4];
#pragma unroll
    for (int b = 0; b < 4; ++b) a[b] = lds4(in + (r0 + b) * in_stride + k);
#pragma unroll
    for (int q = 0; q < 4; ++q) w[q] = ld4(M + (k + q) * H + j0);
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const float av[4] = {a[b].x, a[b].y, a[b].z, a[b].w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        acc[b][0] = fmaf(av[q], w[q].x, acc[b][0]);
        acc[b][1] = fmaf(av[q], w[q].y, acc[b][1]);
        acc[b][2] = fmaf(av[q], w[q].z, acc[b][2]);
        acc[b][3] = fmaf(av[q], w[q].w, acc[b][3]);
      }
    }
  }
}

// Forward hidden layer: dst[r][j] = tanh(sum_k src[r][k] Mt[k][j] + bias[j]).
__device__ __forceinline__ void dense_tanh(const float* src, int src_stride, int K,
                                           const float* __restrict__ Mt,
                                           const float* __restrict__ bias, float* dst) {
  const int j0 = 4 * (threadIdx.x & 31), r0 = 4 * (threadIdx.x >> 5);
  float acc[4][4];
  rowprod(src, src_stride, K, Mt, r0, j0, acc);
  const float4 bb = ld4(bias + j0);
#pragma unroll
  for (int b = 0; b < 4; ++b)
    sts4(dst + (r0 + b) * H + j0,
         make_float4(tanhf(acc[b][0] + bb.x), tanhf(acc[b][1] + bb.y),
                     tanhf(acc[b][2] + bb.z), tanhf(acc[b][3] + bb.w)));
}

// Backward through a tanh layer, in place: act[r][j] <- (sum_k g[r][k] M[k][j])
// * (1 - act[r][j]^2). Each thread reads and writes only its own entries of
// act, so the caller needs a barrier before (readers of act done) and after.
__device__ __forceinline__ void back_tanh(const float* g, int g_stride, int K,
                                          const float* __restrict__ M, float* act) {
  const int j0 = 4 * (threadIdx.x & 31), r0 = 4 * (threadIdx.x >> 5);
  float acc[4][4];
  rowprod(g, g_stride, K, M, r0, j0, acc);
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    float* p = act + (r0 + b) * H + j0;
    const float4 h = lds4(p);
    sts4(p, make_float4(acc[b][0] * (1.f - h.x * h.x), acc[b][1] * (1.f - h.y * h.y),
                        acc[b][2] * (1.f - h.z * h.z), acc[b][3] * (1.f - h.w * h.w)));
  }
}

// acc_w[j][i] += sum_r g[r][j] * a[r][i] for j < H, i < n_in (a multiple of
// 4, the row stride of a and of acc_w), and acc_b[j] += sum_r g[r][j]. Tiles
// of 8 units x 4 inputs; the sums over the chunk's rows run in order r = 0..31.
__device__ __forceinline__ void grad_outer(const float* g, const float* a, int n_in,
                                           float* acc_w, float* acc_b) {
  const int i_groups = n_in / 4;
  const int tiles = (H / 8) * i_groups;
  for (int tile = threadIdx.x; tile < tiles; tile += THREADS) {
    const int j0 = 8 * (tile / i_groups), i0 = 4 * (tile % i_groups);
    float s[8][4];
#pragma unroll
    for (int p = 0; p < 8; ++p)
#pragma unroll
      for (int q = 0; q < 4; ++q) s[p][q] = 0.f;
#pragma unroll 4
    for (int r = 0; r < CHUNK; ++r) {
      const float4 g0 = lds4(g + r * H + j0), g1 = lds4(g + r * H + j0 + 4);
      const float4 av = lds4(a + r * n_in + i0);
      const float gv[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
#pragma unroll
      for (int p = 0; p < 8; ++p) {
        s[p][0] = fmaf(gv[p], av.x, s[p][0]);
        s[p][1] = fmaf(gv[p], av.y, s[p][1]);
        s[p][2] = fmaf(gv[p], av.z, s[p][2]);
        s[p][3] = fmaf(gv[p], av.w, s[p][3]);
      }
    }
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      float* dst = acc_w + (j0 + p) * n_in + i0;
      float4 v = lds4(dst);
      v.x += s[p][0]; v.y += s[p][1]; v.z += s[p][2]; v.w += s[p][3];
      sts4(dst, v);
    }
  }
  if (threadIdx.x < H) {
    float s = 0.f;
    for (int r = 0; r < CHUNK; ++r) s += g[r * H + threadIdx.x];
    acc_b[threadIdx.x] += s;
  }
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

// One chunk's forward and backward, accumulated into the head's gradient
// accumulators (S + S_ACC). The caller has staged the chunk's observations
// in X (row r at r * OBS_P, column 75 zero) and its aux rows in AUX
// (feature f of row r at f * CHUNK + r), then passed a barrier. Rows r >=
// valid are padding: they add nothing to the gradients, the sums or the
// ratio max. Thread 0 keeps the head's sums and ratio max in registers.
__device__ __forceinline__ void chunk_grad(const float* __restrict__ W, int head, float* S,
                                           int valid, const LossConsts& c, float& actor_sum,
                                           float& critic_sum, float& rmax) {
  float* acc = S + S_ACC;
  float* X = S + S_X;
  float* H1 = S + S_H1;
  float* H2 = S + S_H2;
  float* OUT = S + S_OUT;
  float* GO = S + S_G;  // gradient at the head's outputs
  const float* AUX = S + S_AUX;
  const int tid = threadIdx.x;

  // ---- forward
  dense_tanh(X, OBS_P, OBS_P, W + P_W1T, W + P_B1, H1);
  __syncthreads();
  dense_tanh(H1, H, H, W + P_W2T, W + P_B2, H2);
  __syncthreads();
  if (tid < CHUNK * NA) {
    const int r = tid / NA, o = tid % NA;
    const float* h = H2 + r * H;
    const float* w = W + P_W3 + o * H;
    float s = 0.f;
    for (int k = 0; k < H; k += 4) {
      const float4 hv = lds4(h + k), wv = ld4(w + k);
      s = fmaf(hv.x, wv.x, s);
      s = fmaf(hv.y, wv.y, s);
      s = fmaf(hv.z, wv.z, s);
      s = fmaf(hv.w, wv.w, s);
    }
    s += __ldg(W + P_B3 + o);
    OUT[r * NA + o] = head == 0 ? tanhf(s) : s;
  }
  __syncthreads();

  // ---- loss rows and the gradient at the head's outputs (one warp)
  if (tid < CHUNK) {
    const int r = tid;
    const bool live = r < valid;
    const float ret = AUX[5 * CHUNK + r];
    float row;
    if (head == 0) {
      const float old_lp = AUX[4 * CHUNK + r], adv = AUX[6 * CHUNK + r];
      float z[NA], mean[NA], ssq = 0.f;
#pragma unroll
      for (int o = 0; o < NA; ++o) {
        mean[o] = OUT[r * NA + o];
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
      for (int o = 0; o < NA; ++o)
        GO[r * NA + o] = ((g_lp * z[o]) * c.inv_std) * (1.f - mean[o] * mean[o]);
      const float m = warp_max(live ? ratio : 0.f);
      if (r == 0) rmax = fmaxf(rmax, m);
    } else {
      const float verr = live ? OUT[r * NA] - ret : 0.f;
      GO[r * NA + 0] = verr * c.inv_n;
      GO[r * NA + 1] = 0.f;
      GO[r * NA + 2] = 0.f;
      GO[r * NA + 3] = 0.f;
      row = 0.5f * verr * verr;
    }
    const float s = warp_sum(row);
    if (r == 0) {
      if (head == 0) actor_sum += s; else critic_sum += s;
    }
  }
  __syncthreads();

  // ---- backward
  // Output layer: acc_W3[o][k] += sum_r GO[r][o] h2[r][k]; acc_b3[o].
  {
    const int k = tid % H, o0 = tid / H;  // o0 in {0, 1}
    float s0 = 0.f, s1 = 0.f;
    for (int r = 0; r < CHUNK; ++r) {
      const float h = H2[r * H + k];
      s0 = fmaf(GO[r * NA + o0], h, s0);
      s1 = fmaf(GO[r * NA + o0 + 2], h, s1);
    }
    acc[A_W3 + o0 * H + k] += s0;
    acc[A_W3 + (o0 + 2) * H + k] += s1;
    if (tid < NA) {
      float s = 0.f;
      for (int r = 0; r < CHUNK; ++r) s += GO[r * NA + tid];
      acc[A_B3 + tid] += s;
    }
  }
  __syncthreads();
  back_tanh(GO, NA, NA, W + P_W3, H2);        // H2 <- g_h2
  __syncthreads();
  grad_outer(H2, H1, H, acc + A_W2, acc + A_B2);
  __syncthreads();
  back_tanh(H2, H, H, W + P_W2, H1);         // H1 <- g_h1
  __syncthreads();
  grad_outer(H1, X, OBS_P, acc + A_W1, acc + A_B1);
}

// The CTA's accumulators and thread 0's sums, after a barrier, into its
// partial in the workspace (2, G, ACCS).
__device__ __forceinline__ void write_partial(const float* S, float* work, int G, int head,
                                              float actor_sum, float critic_sum, float rmax) {
  float* out = work + ((size_t)head * G + blockIdx.x) * ACCS;
  for (int e = threadIdx.x; e < ACC; e += THREADS) out[e] = S[S_ACC + e];
  if (threadIdx.x == 0) {
    out[ACC + 0] = actor_sum;
    out[ACC + 1] = critic_sum;
    out[ACC + 2] = rmax;
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
