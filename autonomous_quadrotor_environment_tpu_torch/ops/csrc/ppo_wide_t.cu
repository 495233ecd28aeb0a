// PPO minibatch loss and all 12 ActorCritic weight gradients on the rollout
// kernel's transposed (T, features, B) batch, for models wider than 128
// hidden units, for Hopper (sm_90a).
//
// Replaces the TPU kernel `ops/ppo_fused_t.py:fused_ppo_grad_t` of the JAX
// package at those widths, beside `ppo_fused_t.cu` (the narrow design, up
// to 128; it also builds at 256); computes what the port's `ops/ppo_fused_t.py:ppo_grad_t_plain`
// computes with autograd. The design, the bound and the launch sequence
// live in `ppo_grad_wide.cuh`.
//
// What is this file's own is the gather: minibatch row m is env b0 + m %
// tile at timestep t of block id p = perm[m / tile] (t = p / (B / tile), b0
// = (p % (B / tile)) * tile), any tile that divides B. One thread a row
// writes the row's obs into the super-chunk's X^T and its aux into the aux
// rows; neighbouring rows are neighbouring envs of a block, so the reads
// and the writes coalesce. Rows past the minibatch's end are padding (zeros,
// not live); a row with a bad block id reads zeros and NaN aux and is live,
// so it poisons the loss and the gradients with NaN.

#include "ppo_grad_wide.cuh"

using namespace ppo_wide;

namespace {

struct Params {
  const float* obs;  // (T, OBS, B)
  const float* aux;  // (T, 8, B): action(4), old logprob sum, return, advantage, 0
  const int* perm;   // (n_blocks,) block ids t * (B / tile) + b
  int T, B, tile, mb;
};

// Rows r0..r0+R-1 into xs (K1 x R: obs, then zeros) and aux (8 x R: aux
// 0-6, row 7 the live flags).
__global__ void gather_kernel(Params P, int r0, int R, float* __restrict__ xs,
                              float* __restrict__ aux) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R) return;
  const int m = r0 + i, per_t = P.B / P.tile;
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
  for (int f = 0; f < K1; ++f) {
    const float x = f < OBS ? (t >= 0 ? __ldg(P.obs + ((size_t)t * OBS + f) * P.B + b) : 0.f)
                            : 0.f;
    xs[(size_t)f * R + i] = x;
  }
  for (int c = 0; c < 7; ++c)
    aux[(size_t)c * R + i] = t >= 0 ? __ldg(P.aux + ((size_t)t * 8 + c) * P.B + b)
                                    : (t == -1 ? 0.f : nanf(""));
  aux[(size_t)7 * R + i] = t == -1 ? 0.f : 1.f;
}

}  // namespace

extern "C" {

// Launches the gradient's kernels on `stream` for a model of hidden width
// hr (the pack zero-padded to hr rounded up to 128) and returns the first
// launch error: a launch the card refuses never runs and is reported only
// here. The arguments are the narrow library's (`ppo_fused_t.cu`).
int ppo_fused_t(const float* obs, const float* aux, const int* perm, const float* pack,
                float* work, float* out, int T, int B, int tile, int n_blocks, int G,
                float inv_std, float lp_const, float lo, float hi, float inv_n, int hr,
                int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Params P{obs, aux, perm, T, B, tile, n_blocks * tile};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto gather = [&](int r0, int R, float* xs, float* ax) {
    gather_kernel<<<(R + 255) / 256, 256, 0, s>>>(P, r0, R, xs, ax);
    return cudaGetLastError();
  };
  err = run(gather, pack, work, hr, P.mb, G, LossConsts{inv_std, lp_const, lo, hi, inv_n}, s);
  if (err != cudaSuccess) return (int)err;
  reduce_kernel<<<(ppo_grad_out_floats(hr) + 255) / 256, 256, 0, s>>>(work, out, G, hr);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of the product kernel in bytes.
int ppo_wide_t_smem_bytes() { return GEMM_SMEM; }

}  // extern "C"
