// PPO minibatch loss and all 12 ActorCritic weight gradients, for Hopper
// (sm_90a), on the rollout kernel's transposed (T, features, B) batch.
//
// Replaces the TPU kernel `ops/ppo_fused_t.py:fused_ppo_grad_t` of the JAX
// package (Pallas body `_kernel_t`); computes what the port's
// `ops/ppo_fused_t.py:ppo_grad_t_plain` computes with autograd. The design,
// the bound and the chunk's forward and backward are shared with the
// row-major kernels of `ppo_fused.cu` and live in `ppo_grad.cuh`.
//
// What is this file's own is the loader. A chunk of 64 minibatch rows is
// two halves of 32 consecutive envs; a tile is a multiple of 32, so each
// half lies in one row block, and the two halves may come from two blocks.
// Block id p is timestep t = p / (B / tile) and envs b0 = (p % (B / tile)) *
// tile onward, so each feature row of a half is 32 contiguous floats,
// copied by cp.async in 16-byte pieces (4-byte pieces when the batch is not
// 16-byte aligned) straight into the chunk's transposed X^T. A half past
// the minibatch's end is padding; a half with a bad block id is padding too
// and poisons the loss with NaN.

#include "ppo_grad.cuh"

using namespace ppo_grad;

namespace {

constexpr int HALF = 32;  // envs per half chunk; a tile is a multiple

struct Params {
  const float* obs;    // (T, OBS, B)
  const float* aux;    // (T, 8, B): action(4), old logprob sum, return, advantage, 0
  const int* perm;     // (n_blocks,) block ids t * (B / tile) + b
  const float* pack;   // (2, PACK)
  float* work;         // (2, G, ACCS)
  int T, B, tile, n_blocks, G;
  int vec;             // 1: obs and aux are 16-byte aligned
  LossConsts c;
};

// Where half hq of the minibatch starts: its timestep and first env, or
// not ok (past the end of the minibatch, or a bad block id).
struct Half {
  int t, b0;
  bool ok, bad;
};

__device__ __forceinline__ Half locate_half(const Params& P, int hq, int n_halves) {
  Half h{0, 0, false, false};
  if (hq >= n_halves) return h;
  const int m0 = hq * HALF, per_t = P.B / P.tile;
  const int p = __ldg(P.perm + m0 / P.tile);
  if (p < 0 || p >= P.T * per_t) {
    h.bad = true;
    return h;
  }
  h.t = p / per_t;
  h.b0 = (p % per_t) * P.tile + m0 % P.tile;
  h.ok = true;
  return h;
}

// Stage chunk q in input buffer buf: X^T by cp.async, aux rows 0-6 the
// same way, aux row 7 the live flags; a half that is not ok gets zeros.
__device__ __forceinline__ void stage(const Params& P, float* S, int q, int buf, int n_halves,
                                      Walk& w) {
  float* X = S + S_X + buf * K1 * CHUNK;
  float* AUX = S + S_AUX + buf * 8 * CHUNK;
  const Half h0 = locate_half(P, 2 * q, n_halves), h1 = locate_half(P, 2 * q + 1, n_halves);
  if (threadIdx.x == 0 && (h0.bad || h1.bad)) w.critic = nanf("");
  const int v = P.vec ? 4 : 1;                 // floats per copy
  const int segs = HALF / v;                   // copies per feature row of a half
  const int per_half = (OBS + 7) * segs;       // 75 obs rows, aux rows 0-6
  for (int job = threadIdx.x; job < 2 * per_half; job += THREADS) {
    const int hf = job / per_half, e = job - hf * per_half;
    const int f = e / segs, env = (e - f * segs) * v, r = hf * HALF + env;
    const Half h = hf ? h1 : h0;
    float* dst = f < OBS ? X + f * CHUNK + (r ^ swz(f)) : AUX + (f - OBS) * CHUNK + r;
    if (h.ok) {
      const float* src = f < OBS ? P.obs + ((size_t)h.t * OBS + f) * P.B
                                 : P.aux + ((size_t)h.t * 8 + (f - OBS)) * P.B;
      src += h.b0 + env;
      if (v == 4) cp_async16(dst, src); else cp_async4(dst, src);
    } else {
      for (int i = 0; i < v; ++i) dst[i] = 0.f;
    }
  }
  if (threadIdx.x < CHUNK)
    AUX[7 * CHUNK + threadIdx.x] = (threadIdx.x < HALF ? h0.ok : h1.ok) ? 1.f : 0.f;
}

__global__ void __launch_bounds__(THREADS, 1) ppo_grad_kernel(Params P) {
  extern __shared__ float4 smem4[];
  float* S = reinterpret_cast<float*>(smem4);
  const int head = blockIdx.y;  // 0 actor, 1 critic
  Walk w;
  init_walk(S, P.pack + head * PACK, w);

  const int n_halves = P.n_blocks * (P.tile / HALF);
  const int n_chunks = (n_halves + 1) / 2;
  int q = blockIdx.x, buf = 0;
  if (q < n_chunks) stage(P, S, q, 0, n_halves, w);
  cp_async_commit();
  for (; q < n_chunks; q += P.G, buf ^= 1) {
    cp_async_wait_all();
    __syncthreads();  // chunk q staged; the previous chunk's readers are done
    const int next = q + P.G;
    chunk_grad(S, buf, head, P.c, w, [&] {
      if (next < n_chunks) stage(P, S, next, buf ^ 1, n_halves, w);
      cp_async_commit();
    });
  }
  write_partial(S, P.work, P.G, head, w);
}

}  // namespace

extern "C" {

// Launches both kernels on `stream` and returns cudaGetLastError(): a launch
// the card refuses never runs and is reported only here.
int ppo_fused_t(const float* obs, const float* aux, const int* perm, const float* pack,
                float* work, float* out, int T, int B, int tile, int n_blocks, int G,
                float inv_std, float lp_const, float lo, float hi, float inv_n,
                int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(ppo_grad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const int vec = ((reinterpret_cast<uintptr_t>(obs) | reinterpret_cast<uintptr_t>(aux)) & 15) == 0;
  Params P{obs, aux, perm, pack, work, T, B, tile, n_blocks, G, vec,
           LossConsts{inv_std, lp_const, lo, hi, inv_n}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  ppo_grad_kernel<<<dim3(G, 2), THREADS, SMEM_BYTES, s>>>(P);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_kernel<<<(N_OUT + 255) / 256, 256, 0, s>>>(work, out, G);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of the gradient kernel in bytes.
int ppo_fused_t_smem_bytes() { return SMEM_BYTES; }

}  // extern "C"
