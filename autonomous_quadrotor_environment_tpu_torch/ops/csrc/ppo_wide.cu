// PPO minibatch loss and all 12 ActorCritic weight gradients on the
// row-major batch, alone or followed by the Adam step, for models wider
// than 128 hidden units, for Hopper (sm_90a).
//
// Replaces the TPU kernels `ops/ppo_fused.py:fused_ppo_grad` and
// `fused_ppo_grad_adam` of the JAX package at those widths, beside
// `ppo_fused.cu` (the narrow design, up to 128; it also builds at 256);
// computes what the port's `ops/ppo_fused.py:ppo_grad_plain` and
// `ppo_grad_adam_plain` compute. The design, the bound and the launch
// sequence live in `ppo_grad_wide.cuh`;
// the Adam step runs in the fixed-order reduction pass, in place on the
// model's own leaves, as in `ppo_fused.cu`.
//
// What is this file's own is the gather: minibatch row m is row perm[m /
// tile] * tile + m % tile of the row-major obs (n, OBS) and aux (n, 8), any
// tile. One thread a row writes the row's obs into the super-chunk's X^T
// (the reads of one feature stride the rows, but each thread walks its row
// in order, so L1 serves its next features) and its aux into the aux rows.
// Padding and bad block ids as in `ppo_wide_t.cu`.

#include "ppo_grad_wide.cuh"

using namespace ppo_wide;

namespace {

struct Params {
  const float* obs;  // (n, OBS) row-major
  const float* aux;  // (n, 8): action(4), old logprob sum, return, advantage, 0
  const int* perm;   // (n_blocks,) row-block ids of this minibatch
  int n_ids, tile, mb;
};

__global__ void gather_kernel(Params P, int r0, int R, float* __restrict__ xs,
                              float* __restrict__ aux) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R) return;
  const int m = r0 + i;
  int row = -1;
  if (m < P.mb) {
    const int p = __ldg(P.perm + m / P.tile);
    row = (p >= 0 && p < P.n_ids) ? p * P.tile + m % P.tile : -2;
  }
  for (int f = 0; f < K1; ++f) {
    const float x = f < OBS ? (row >= 0 ? __ldg(P.obs + (size_t)row * OBS + f) : 0.f)
                            : 0.f;
    xs[(size_t)f * R + i] = x;
  }
  for (int c = 0; c < 7; ++c)
    aux[(size_t)c * R + i] = row >= 0 ? __ldg(P.aux + (size_t)row * 8 + c)
                                      : (row == -1 ? 0.f : nanf(""));
  aux[(size_t)7 * R + i] = row == -1 ? 0.f : 1.f;
}

// reduce_kernel's sums with the Adam step on each finished gradient entry
// of width hr (`ppo_common.cuh:reduce_entry_adam`).
__global__ void reduce_adam_kernel(const float* __restrict__ work, float* __restrict__ metrics,
                                   int G, int hr, AdamLeaves L, AdamConsts a) {
  reduce_entry_adam(work, metrics, G, hr, make_layout(padded(hr), OBS), L, a);
}

cudaError_t launch_grad(const Params& P, const float* pack, float* work, int hr, int G,
                        const LossConsts& c, cudaStream_t s) {
  auto gather = [&](int r0, int R, float* xs, float* ax) {
    gather_kernel<<<(R + 255) / 256, 256, 0, s>>>(P, r0, R, xs, ax);
    return cudaGetLastError();
  };
  return run(gather, pack, work, hr, P.mb, G, c, s);
}

}  // namespace

extern "C" {

// B3 at the wide widths: the gradient's kernels and the reduction into
// `out` (out_floats(hr) floats) on `stream`; the narrow library's
// arguments (`ppo_fused.cu`). Returns the first launch error.
int ppo_fused(const float* obs, const float* aux, const int* perm, const float* pack,
              float* work, float* out, int n, int tile, int n_blocks, int G,
              float inv_std, float lp_const, float lo, float hi, float inv_n, int hr,
              int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Params P{obs, aux, perm, n / tile, tile, n_blocks * tile};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = launch_grad(P, pack, work, hr, G, LossConsts{inv_std, lp_const, lo, hi, inv_n}, s);
  if (err != cudaSuccess) return (int)err;
  reduce_kernel<<<(ppo_grad_out_floats(hr) + 255) / 256, 256, 0, s>>>(work, out, G, hr);
  return (int)cudaGetLastError();
}

// B4 at the wide widths: the gradient's kernels, then the reduction with
// the Adam step on the 36 leaves in `leaves` (params, exp_avg, exp_avg_sq,
// each in flax leaf order, at the model's width hr), in place; the three
// metrics into `metrics`.
int ppo_fused_adam(const float* obs, const float* aux, const int* perm, const float* pack,
                   float* work, float* metrics, int n, int tile, int n_blocks, int G,
                   float inv_std, float lp_const, float lo, float hi, float inv_n, int hr,
                   void* const* leaves, float one_minus_b1, float b2, float one_minus_b2,
                   float neg_step_size, float bc2_sqrt, float eps, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Params P{obs, aux, perm, n / tile, tile, n_blocks * tile};
  AdamLeaves L;
  for (int k = 0; k < 12; ++k) {
    L.p[k] = static_cast<float*>(leaves[k]);
    L.m[k] = static_cast<float*>(leaves[12 + k]);
    L.v[k] = static_cast<float*>(leaves[24 + k]);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = launch_grad(P, pack, work, hr, G, LossConsts{inv_std, lp_const, lo, hi, inv_n}, s);
  if (err != cudaSuccess) return (int)err;
  reduce_adam_kernel<<<(ppo_grad_out_floats(hr) + 255) / 256, 256, 0, s>>>(
      work, metrics, G, hr, L, AdamConsts{one_minus_b1, b2, one_minus_b2, neg_step_size, bc2_sqrt, eps});
  return (int)cudaGetLastError();
}

// Dynamic shared memory of the product kernel in bytes.
int ppo_wide_smem_bytes() { return GEMM_SMEM; }

}  // extern "C"
