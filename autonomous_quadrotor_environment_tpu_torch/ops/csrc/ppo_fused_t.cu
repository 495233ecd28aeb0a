// PPO minibatch loss and all 12 ActorCritic weight gradients, for Hopper
// (sm_90a), on the rollout kernel's transposed (T, features, B) batch.
//
// Replaces the TPU kernel `ops/ppo_fused_t.py:fused_ppo_grad_t` of the JAX
// package (Pallas body `_kernel_t`); computes what the port's
// `ops/ppo_fused_t.py:ppo_grad_t_plain` computes with autograd. The design,
// the bound and the chunk's forward and backward are shared with the
// row-major kernels of `ppo_fused.cu` and live in `ppo_grad.cuh`.
//
// What is this file's own is the loader: a chunk is CHUNK consecutive envs
// of one row block. Block id p is timestep t = p / (B / tile) and envs
// b0 = (p % (B / tile)) * tile, so each feature row of the chunk is 32
// contiguous floats (coalesced). A tile is a multiple of CHUNK, so a chunk
// never spans two blocks.

#include "ppo_grad.cuh"

using namespace ppo_grad;

namespace {

struct Params {
  const float* obs;    // (T, OBS, B)
  const float* aux;    // (T, 8, B): action(4), old logprob sum, return, advantage, 0
  const int* perm;     // (n_blocks,) block ids t * (B / tile) + b
  const float* pack;   // (2, PACK)
  float* work;         // (2, G, ACCS)
  int T, B, tile, n_blocks, G;
  LossConsts c;
};

__global__ void __launch_bounds__(THREADS, 1) ppo_grad_kernel(Params P) {
  extern __shared__ float4 smem4[];
  float* S = reinterpret_cast<float*>(smem4);
  float* acc = S + S_ACC;
  float* X = S + S_X;
  float* AUX = S + S_AUX;

  const int head = blockIdx.y;  // 0 actor, 1 critic
  const int tid = threadIdx.x;
  const float* W = P.pack + head * PACK;

  for (int e = tid; e < ACC; e += THREADS) acc[e] = 0.f;
  float actor_sum = 0.f, critic_sum = 0.f, rmax = 0.f;  // kept by thread 0

  const int per_block = P.tile / CHUNK;
  const int blocks_per_t = P.B / P.tile;
  const int n_chunks = P.n_blocks * per_block;
  const int n_ids = P.T * blocks_per_t;

  for (int q = blockIdx.x; q < n_chunks; q += P.G) {
    const int p = P.perm[q / per_block];
    if (p < 0 || p >= n_ids) {  // a bad block id poisons the loss
      if (tid == 0) critic_sum = nanf("");
      continue;
    }
    const int t = p / blocks_per_t;
    const int b0 = (p % blocks_per_t) * P.tile + (q % per_block) * CHUNK;

    __syncthreads();  // the previous chunk's readers of X and AUX are done
    {
      const float* src = P.obs + (size_t)t * OBS * P.B + b0;
      for (int e = tid; e < OBS * CHUNK; e += THREADS) {
        const int f = e / CHUNK, r = e % CHUNK;
        X[r * OBS_P + f] = __ldg(src + (size_t)f * P.B + r);
      }
      if (tid < CHUNK) X[tid * OBS_P + OBS] = 0.f;
      const float* asrc = P.aux + (size_t)t * 8 * P.B + b0;
      {
        const int f = tid / CHUNK, r = tid % CHUNK;  // 256 = 8 x 32
        AUX[f * CHUNK + r] = __ldg(asrc + (size_t)f * P.B + r);
      }
    }
    __syncthreads();

    chunk_grad(W, head, S, CHUNK, P.c, actor_sum, critic_sum, rmax);
  }
  __syncthreads();
  write_partial(S, P.work, P.G, head, actor_sum, critic_sum, rmax);
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
  const size_t smem = SMEM_FLOATS * sizeof(float);
  err = cudaFuncSetAttribute(ppo_grad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  Params P{obs, aux, perm, pack, work, T, B, tile, n_blocks, G,
           LossConsts{inv_std, lp_const, lo, hi, inv_n}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  ppo_grad_kernel<<<dim3(G, 2), THREADS, smem, s>>>(P);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_kernel<<<(N_OUT + 255) / 256, 256, 0, s>>>(work, out, G);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of the gradient kernel in bytes.
int ppo_fused_t_smem_bytes() { return SMEM_FLOATS * (int)sizeof(float); }

}  // extern "C"
