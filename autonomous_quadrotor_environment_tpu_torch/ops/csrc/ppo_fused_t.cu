// PPO minibatch loss and all 12 ActorCritic weight gradients, for Hopper
// (sm_90a), on the rollout kernel's transposed (T, features, B) batch.
//
// Replaces the TPU kernel `ops/ppo_fused_t.py:fused_ppo_grad_t` of the JAX
// package (Pallas body `_kernel_t`); computes what the port's
// `ops/ppo_fused_t.py:ppo_grad_t_plain` computes with autograd. The design,
// the bound, the instantiations (width, obs width, precision) and the
// chunk's forward and backward are shared with the row-major kernels of
// `ppo_fused.cu` and live in `ppo_grad.cuh`.
//
// What is this file's own is the loader. A chunk is 64 consecutive
// minibatch rows; minibatch row m is env b0 + m % tile at timestep t of
// block id p = perm[m / tile] (t = p / (B / tile), b0 = (p % (B / tile)) *
// tile). Any tile that divides B goes (the trainer's `update_t_tile` gives
// any of 8 or more): a chunk may gather rows of several blocks at different
// timesteps. While the chunk before it computes, the chunk's rows are
// resolved into a table (t, env) in shared memory; then each feature row of
// each group of 4 rows is copied by cp.async straight into the chunk's
// transposed X^T, in one 16-byte piece where the tile, B and the batch's
// base are multiples of 4 floats (a group then lies in one block, at 4
// consecutive envs), else in 4-byte pieces. Rows past the minibatch's end
// are padding (zeros, not live); a row with a bad block id reads zeros and
// NaN aux and is live, so it poisons the loss and the gradients with NaN.

#include "ppo_grad.cuh"

using namespace ppo_grad;

namespace {

struct Params {
  const float* obs;    // (T, OBS, B)
  const float* aux;    // (T, 8, B): action(4), old logprob sum, return, advantage, 0
  const int* perm;     // (n_blocks,) block ids t * (B / tile) + b
  const float* pack;   // (2, PACK)
  float* work;         // (2, G, ACCS)
  int T, B, tile, mb, G;
  int vec;             // 1: 16-byte copies of 4-row groups
  LossConsts c;
};

// Chunk q's rows into table buf: timestep (-1 padding past the minibatch's
// end, -2 a bad block id) and env.
__device__ __forceinline__ void resolve(const Params& P, float* S, int q, int buf) {
  if (threadIdx.x >= CHUNK) return;
  int* tab = reinterpret_cast<int*>(S + S_ROWS) + buf * 2 * CHUNK;
  const int m = q * CHUNK + threadIdx.x, per_t = P.B / P.tile;
  int t = -1, b = 0;
  if (m < P.mb) {
    const int p = __ldg(P.perm + m / P.tile);
    if (p >= 0 && p < P.T * per_t) {
      t = p / per_t;
      b = (p % per_t) * P.tile + m % P.tile;
    } else {
      t = -2;
    }
  }
  tab[threadIdx.x] = t;
  tab[CHUNK + threadIdx.x] = b;
}

// Stage the chunk of table buf in input buffer buf: X^T (but where WIDE)
// and aux rows 0-6 by cp.async, aux row 7 the live flags.
__device__ __forceinline__ void stage(const Params& P, float* S, int buf) {
  const int* tab = reinterpret_cast<const int*>(S + S_ROWS) + buf * 2 * CHUNK;
  float* X = S + S_X + buf * K1 * CHUNK;
  float* AUX = S + S_AUX + buf * 8 * CHUNK;
  const int v = P.vec ? 4 : 1;  // rows per copy
  const int groups = CHUNK / v;
  for (int job = OBS * groups * WIDE + threadIdx.x; job < (OBS + 7) * groups; job += THREADS) {
    const int f = job / groups, r = (job - f * groups) * v, t = tab[r];
    float* dst = f < OBS ? X + f * CHUNK + (r ^ swz(f)) : AUX + (f - OBS) * CHUNK + r;
    if (t >= 0) {
      const float* src = f < OBS ? P.obs + ((size_t)t * OBS + f) * P.B
                                 : P.aux + ((size_t)t * 8 + (f - OBS)) * P.B;
      if (v == 4) {
        cp_async16(dst, src + tab[CHUNK + r]);
      } else {
        cp_async4(dst, src + tab[CHUNK + r]);
      }
    } else {
      const float fill = f < OBS || t == -1 ? 0.f : nanf("");
      for (int i = 0; i < v; ++i) dst[i] = fill;
    }
  }
  if (threadIdx.x < CHUNK) AUX[7 * CHUNK + threadIdx.x] = tab[threadIdx.x] == -1 ? 0.f : 1.f;
}

__global__ void __launch_bounds__(THREADS, 1) ppo_grad_kernel(Params P) {
  extern __shared__ float4 smem4[];
  float* S = reinterpret_cast<float*>(smem4);
  const int head = blockIdx.y, slice = blockIdx.z;  // head 0 actor, 1 critic
  const float* W = P.pack + head * PACK;
  Walk w;
  init_walk(S, W, w, P.work, P.G, head, slice);

  const int n_chunks = (P.mb + CHUNK - 1) / CHUNK;
  int q = blockIdx.x, buf = 0;
  if (q < n_chunks) resolve(P, S, q, 0);
  __syncthreads();
  if (q < n_chunks) stage(P, S, 0);
  cp_async_commit();
  for (; q < n_chunks; q += P.G, buf ^= 1) {
    cp_async_wait_all();
    __syncthreads();  // chunk q staged; the previous chunk's readers are done
    const int next = q + P.G;
    if (next < n_chunks) resolve(P, S, next, buf ^ 1);
    chunk_grad(S, W, buf, head, slice, P.c, w, XRows{P.obs, (size_t)OBS * P.B, P.B}, [&] {
      if (next < n_chunks) stage(P, S, buf ^ 1);
      cp_async_commit();
    });
  }
  write_partial(S, P.work, P.G, head, slice, w);
}

}  // namespace

extern "C" {

// Launches both kernels on `stream` for a model of hidden width hr (at
// most H; the pack zero-padded to H) and returns cudaGetLastError(): a
// launch the card refuses never runs and is reported only here.
int ppo_fused_t(const float* obs, const float* aux, const int* perm, const float* pack,
                float* work, float* out, int T, int B, int tile, int n_blocks, int G,
                float inv_std, float lp_const, float lo, float hi, float inv_n, int hr,
                int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(ppo_grad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(obs) | reinterpret_cast<uintptr_t>(aux)) & 15) == 0;
  const int vec = aligned && B % 4 == 0 && tile % 4 == 0;
  Params P{obs, aux, perm, pack, work, T, B, tile, n_blocks * tile, G, vec,
           LossConsts{inv_std, lp_const, lo, hi, inv_n}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  ppo_grad_kernel<<<dim3(G, 2, NS), THREADS, SMEM_BYTES, s>>>(P);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_kernel<<<(out_floats(hr) + 255) / 256, 256, 0, s>>>(work, out, G, hr);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of the gradient kernel in bytes.
int ppo_fused_t_smem_bytes() { return SMEM_BYTES; }

}  // extern "C"
