// PPO minibatch loss and all 12 ActorCritic weight gradients, for Hopper
// (sm_90a), on the row-major batch; and the same followed by the Adam step.
//
// Replaces two TPU kernels of the JAX package's `ops/ppo_fused.py`:
// * `fused_ppo_grad` (Pallas body `_kernel` / `_body`): what the port's
//   `ops/ppo_fused.py:ppo_grad_plain` computes with autograd;
// * `fused_ppo_grad_adam` (`_kernel_adam`): the same gradients, then one
//   Adam step on them, as `ppo_grad_adam_plain` computes it. The TPU kernel
//   runs the step at its last grid step on the resident accumulators; here
//   it runs in the fixed-order reduction pass, which holds each finished
//   gradient entry anyway: it reads the parameter and the two moments of
//   `torch.optim.Adam`'s state and writes all three back in place, with
//   torch's own formula (m lerped towards g by 1 - b1, v = b2 v + (1 - b2)
//   g^2, p += -lr / c1 * m / (sqrt(v) / sqrt(c2) + eps)), the bias
//   corrections c1, c2 from the host.
//
// The chunk's forward and backward, the per-head CTAs with their resident
// weights and register accumulators, and the fixed-order reduction are
// B2's (`ppo_grad.cuh`, where the design and the bound are written down).
// What is this file's own is the loader. The minibatch is the row blocks
// `perm` of `tile` rows each and is never gathered: minibatch row m is row
// perm[m / tile] * tile + m % tile of the row-major obs (n, OBS) and aux
// (n, 8). A chunk is 64 consecutive minibatch rows; its source rows are
// resolved into shared memory while the chunk before it computes, then its
// 64 x OBS floats are copied by 4-byte cp.async (a row of 75 floats is 300
// bytes, only 4-byte aligned) into the chunk's transposed X^T, neighbouring
// threads on neighbouring floats of a row, so the loads coalesce. Any tile
// goes: a chunk may span blocks, and the last chunk is padded with rows
// that add nothing. The library is built for one obs width (any
// EnvConfig.hist_t * 15; the depth zero-padded to K1); where it is WIDE
// (`ppo_grad.cuh`) only the aux rows are staged and the products read the
// obs rows in place through the table.

#include "ppo_grad.cuh"

using namespace ppo_grad;

namespace {

struct Params {
  const float* obs;    // (n, OBS) row-major
  const float* aux;    // (n, 8): action(4), old logprob sum, return, advantage, 0
  const int* perm;     // (n_blocks,) row-block ids of this minibatch
  const float* pack;   // (2, PACK)
  float* work;         // (2, G, ACCS)
  int n_ids, tile, mb, G;
  LossConsts c;
};

// Chunk q's source rows into table buf: a row >= 0; -1 padding past the
// minibatch's end (zeros); -2 a bad block id, whose row poisons the loss
// and the gradients with NaN. The table's second half is 0 (`XRows`).
__device__ __forceinline__ void resolve(const Params& P, float* S, int q, int buf) {
  if (threadIdx.x >= CHUNK) return;
  const int m = q * CHUNK + threadIdx.x;
  int row = -1;
  if (m < P.mb) {
    const int p = __ldg(P.perm + m / P.tile);
    row = (p >= 0 && p < P.n_ids) ? p * P.tile + m % P.tile : -2;
  }
  int* tab = reinterpret_cast<int*>(S + S_ROWS) + buf * 2 * CHUNK;
  tab[threadIdx.x] = row;
  tab[CHUNK + threadIdx.x] = 0;
}

// Stage the chunk of table buf in input buffer buf: X^T (but where WIDE)
// and aux rows 0-6 by cp.async, aux row 7 the live flags (a bad row is
// live).
__device__ __forceinline__ void stage(const Params& P, float* S, int buf) {
  const int* rows = reinterpret_cast<const int*>(S + S_ROWS) + buf * 2 * CHUNK;
  float* X = S + S_X + buf * K1 * CHUNK;
  float* AUX = S + S_AUX + buf * 8 * CHUNK;
  for (int e = threadIdx.x; e < CHUNK * OBS * !WIDE; e += THREADS) {
    const int r = e / OBS, f = e - r * OBS, row = rows[r];
    float* dst = X + f * CHUNK + (r ^ swz(f));
    if (row >= 0) cp_async4(dst, P.obs + (size_t)row * OBS + f); else *dst = 0.f;
  }
  for (int e = threadIdx.x; e < CHUNK * 8; e += THREADS) {
    const int r = e >> 3, f = e & 7, row = rows[r];
    float* dst = AUX + f * CHUNK + r;
    if (f == 7) *dst = row == -1 ? 0.f : 1.f;
    else if (row >= 0) cp_async4(dst, P.aux + (size_t)row * 8 + f);
    else *dst = row == -1 ? 0.f : nanf("");
  }
}

__global__ void __launch_bounds__(THREADS, 1) ppo_grad_rows_kernel(Params P) {
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
    chunk_grad(S, W, buf, head, slice, P.c, w, XRows{P.obs, (size_t)OBS, 1}, [&] {
      if (next < n_chunks) stage(P, S, buf ^ 1);
      cp_async_commit();
    });
  }
  write_partial(S, P.work, P.G, head, slice, w);
}

// reduce_kernel's sums with the Adam step on each finished gradient entry
// of width hr (`ppo_common.cuh:reduce_entry_adam`).
__global__ void reduce_adam_kernel(const float* __restrict__ work, float* __restrict__ metrics,
                                   int G, int hr, AdamLeaves L, AdamConsts a) {
  reduce_entry_adam(work, metrics, G, hr, layout(), L, a);
}

cudaError_t launch_grad(const Params& P, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      ppo_grad_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  ppo_grad_rows_kernel<<<dim3(P.G, 2, NS), THREADS, SMEM_BYTES, s>>>(P);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// B3: the gradient kernel and the reduction into `out` (out_floats(hr)
// floats) on `stream`, for a model of hidden width hr (at most H; the pack
// zero-padded to H). Returns cudaGetLastError(): a launch the card refuses
// never runs and is reported only here.
int ppo_fused(const float* obs, const float* aux, const int* perm, const float* pack,
              float* work, float* out, int n, int tile, int n_blocks, int G,
              float inv_std, float lp_const, float lo, float hi, float inv_n, int hr,
              int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Params P{obs, aux, perm, pack, work, n / tile, tile, n_blocks * tile, G,
           LossConsts{inv_std, lp_const, lo, hi, inv_n}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = launch_grad(P, s);
  if (err != cudaSuccess) return (int)err;
  reduce_kernel<<<(out_floats(hr) + 255) / 256, 256, 0, s>>>(work, out, G, hr);
  return (int)cudaGetLastError();
}

// B4: the gradient kernel, then the reduction with the Adam step on the 36
// leaves in `leaves` (params, exp_avg, exp_avg_sq, each in flax leaf order,
// at the model's width hr), in place; the three metrics into `metrics`.
int ppo_fused_adam(const float* obs, const float* aux, const int* perm, const float* pack,
                   float* work, float* metrics, int n, int tile, int n_blocks, int G,
                   float inv_std, float lp_const, float lo, float hi, float inv_n, int hr,
                   void* const* leaves, float one_minus_b1, float b2, float one_minus_b2,
                   float neg_step_size, float bc2_sqrt, float eps, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Params P{obs, aux, perm, pack, work, n / tile, tile, n_blocks * tile, G,
           LossConsts{inv_std, lp_const, lo, hi, inv_n}};
  AdamLeaves L;
  for (int k = 0; k < 12; ++k) {
    L.p[k] = static_cast<float*>(leaves[k]);
    L.m[k] = static_cast<float*>(leaves[12 + k]);
    L.v[k] = static_cast<float*>(leaves[24 + k]);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = launch_grad(P, s);
  if (err != cudaSuccess) return (int)err;
  reduce_adam_kernel<<<(out_floats(hr) + 255) / 256, 256, 0, s>>>(
      work, metrics, G, hr, L, AdamConsts{one_minus_b1, b2, one_minus_b2, neg_step_size, bc2_sqrt, eps});
  return (int)cudaGetLastError();
}

// Dynamic shared memory of the gradient kernel in bytes.
int ppo_fused_smem_bytes() { return SMEM_BYTES; }

}  // extern "C"
