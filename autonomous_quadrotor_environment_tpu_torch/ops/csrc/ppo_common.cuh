// What the narrow PPO gradient kernels (`ppo_grad.cuh`, per hidden width up
// to 128) and the wide ones (`ppo_grad_wide.cuh`, any multiple of 128) share:
// the loss's constants and its per-row math with the clip-tie convention,
// warp reductions, the layout of a CTA's partial of the gradient sums, and
// the fixed-order reduction passes over the partials (B4's with the Adam
// step).

#pragma once

#include <math.h>
#include <stddef.h>

namespace ppo_grad {

constexpr int NA = 4;  // actor outputs; the critic's one output is padded to 4

// The loss's constants: 1/std, the logprob's constant 4 (log std +
// log(2 pi) / 2), the clip band's bounds and 1 / minibatch rows.
struct LossConsts {
  float inv_std, lp_const, lo, hi, inv_n;
};

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

// One row's loss term and the gradient at the head's outputs `mean` (the
// actor's tanh means, or the critic's value in mean[0]): aux is the row's
// [action(4), old logprob sum, return, advantage]. A row that is not live
// is padding: it adds nothing (its gradient and term are 0, its ratio 0,
// which no max sees). Returns the term; the ratio goes to `ratio`.
__device__ __forceinline__ float loss_row(int head, bool live, const float (&mean)[NA],
                                          const float* aux, const LossConsts& c,
                                          float (&go)[NA], float& ratio) {
  if (head == 0) {
    const float old_lp = aux[4], adv = aux[6];
    float z[NA], ssq = 0.f;
#pragma unroll
    for (int o = 0; o < NA; ++o) {
      z[o] = (aux[o] - mean[o]) * c.inv_std;
      ssq = fmaf(z[o], z[o], ssq);
    }
    const float lp = -0.5f * ssq - c.lp_const;
    const float r = expf(lp - old_lp);
    const bool in_band = r > c.lo && r < c.hi;
    const float surr1 = r * adv;
    const float surr2 = fminf(fmaxf(r, c.lo), c.hi) * adv;
    const float g_ratio = -c.inv_n * adv * (surr1 <= surr2 ? 1.f : (in_band ? 1.f : 0.f));
    const float g_lp = live ? g_ratio * r : 0.f;
#pragma unroll
    for (int o = 0; o < NA; ++o) go[o] = ((g_lp * z[o]) * c.inv_std) * (1.f - mean[o] * mean[o]);
    ratio = live ? r : 0.f;
    return live ? -fminf(surr1, surr2) : 0.f;
  }
  const float verr = live ? mean[0] - aux[5] : 0.f;
  go[0] = verr * c.inv_n;
  go[1] = go[2] = go[3] = 0.f;
  ratio = 0.f;
  return 0.5f * verr * verr;
}

constexpr int NMET = 4;  // a partial's metrics: actor sum, critic sum, ratio max, pad

// The offsets (floats) of one head's gradient sums in a CTA's partial, (out,
// in) layout at the instantiated width h: dW1 [h][obs_p], dW2 [h][h], dW3
// [NA][h], b1, b2 [h], b3 [NA]; then the NMET metrics at acc.
struct Layout {
  int h, obs, obs_p, w1, w2, w3, b1, b2, b3, acc;
};

__host__ __device__ constexpr Layout make_layout(int h, int obs) {
  const int obs_p = (obs + 3) / 4 * 4;
  return Layout{h,
                obs,
                obs_p,
                0,
                h * obs_p,
                h * obs_p + h * h,
                h * obs_p + h * h + NA * h,
                h * obs_p + h * h + NA * h + h,
                h * obs_p + h * h + NA * h + 2 * h,
                h * obs_p + h * h + NA * h + 2 * h + NA};
}

// Flat output at the model's real width hr: the 12 gradient leaves in flax
// leaf order, (out, in) kernels and (out,) biases, then the 3 metrics.
__host__ __device__ constexpr int out_actor(int obs, int hr) {
  return obs * hr + hr + hr * hr + hr + NA * hr + NA;
}
__host__ __device__ constexpr int out_critic(int obs, int hr) {
  return obs * hr + hr + hr * hr + hr + hr + 1;
}

// Where output entry e (< out_actor + out_critic) of the model's real width
// hr lives: its head, its index in the padded partial of layout L, its leaf
// (0..11, flax leaf order) and its offset in that leaf.
struct Entry {
  int head, src, leaf, off;
};

__device__ __forceinline__ Entry locate(int e, int hr, const Layout& L) {
  Entry r;
  r.head = e < out_actor(L.obs, hr) ? 0 : 1;
  r.leaf = 6 * r.head;
  int k = e - r.head * out_actor(L.obs, hr);
  if (k < L.obs * hr) {
    r.src = L.w1 + (k / L.obs) * L.obs_p + k % L.obs;
  } else if ((k -= L.obs * hr) < hr) {
    r.src = L.b1 + k;
    r.leaf += 1;
  } else if ((k -= hr) < hr * hr) {
    r.src = L.w2 + (k / hr) * L.h + k % hr;
    r.leaf += 2;
  } else if ((k -= hr * hr) < hr) {
    r.src = L.b2 + k;
    r.leaf += 3;
  } else {
    k -= hr;
    const int n_out = r.head == 0 ? NA : 1;
    if (k < n_out * hr) {
      r.src = L.w3 + (k / hr) * L.h + k % hr;
      r.leaf += 4;
    } else {
      k -= n_out * hr;
      r.src = L.b3 + k;
      r.leaf += 5;
    }
  }
  r.off = k;
  return r;
}

// The sum of entry src over the G partials (each `stride` floats) of one
// head, in the order 0..G-1.
__device__ __forceinline__ float sum_partials(const float* __restrict__ work, int G, size_t stride,
                                              int head, int src) {
  float s = 0.f;
  for (int c = 0; c < G; ++c) s += work[((size_t)head * G + c) * stride + src];
  return s;
}

// Metric m (0 actor sum, 1 critic sum, 2 ratio max) over the partials; the
// metrics sit at `acc` of each partial (actor's and ratio max in head 0's,
// critic's in head 1's).
__device__ __forceinline__ float reduce_metric(const float* __restrict__ work, int G,
                                               size_t stride, int acc, int m) {
  const int head = m == 1 ? 1 : 0;
  float s = 0.f;
  for (int c = 0; c < G; ++c) {
    const float v = work[((size_t)head * G + c) * stride + acc + m];
    s = m == 2 ? fmaxf(s, v) : s + v;
  }
  return s;
}

// The 12 parameter leaves and their two Adam moments, flax leaf order,
// each laid out as the gradient's leaf in the flat output.
struct AdamLeaves {
  float* p[12];
  float* m[12];
  float* v[12];
};

struct AdamConsts {
  float one_minus_b1, b2, one_minus_b2, neg_step_size, bc2_sqrt, eps;
};

// The reduction pass, a thread per output entry e: the flat output of the
// model's width hr (the 12 gradients, then the 3 metrics) from the G
// partials of layout L, each gradient entry summed in the order 0..G-1 (no
// float atomics, so two launches give the same bits).
__device__ __forceinline__ void reduce_entry(const float* __restrict__ work, float* __restrict__ out,
                                             int G, int hr, const Layout& L) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  const int n = out_actor(L.obs, hr) + out_critic(L.obs, hr);
  if (e >= n + 3) return;
  if (e >= n) {
    out[e] = reduce_metric(work, G, L.acc + NMET, L.acc, e - n);
    return;
  }
  const Entry at = locate(e, hr, L);
  out[e] = sum_partials(work, G, L.acc + NMET, at.head, at.src);
}

// The same sums with torch.optim.Adam's step taken on each finished
// gradient entry, in place on the leaves `P`, instead of writing it out (m
// lerped towards g by 1 - b1, v = b2 v + (1 - b2) g^2, p += -lr / c1 * m /
// (sqrt(v) / sqrt(c2) + eps)); the metrics go to metrics[0..2].
__device__ __forceinline__ void reduce_entry_adam(const float* __restrict__ work,
                                                  float* __restrict__ metrics, int G, int hr,
                                                  const Layout& L, const AdamLeaves& P,
                                                  const AdamConsts& a) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  const int n = out_actor(L.obs, hr) + out_critic(L.obs, hr);
  if (e >= n + 3) return;
  if (e >= n) {
    metrics[e - n] = reduce_metric(work, G, L.acc + NMET, L.acc, e - n);
    return;
  }
  const Entry at = locate(e, hr, L);
  const float g = sum_partials(work, G, L.acc + NMET, at.head, at.src);
  float* pp = P.p[at.leaf] + at.off;
  float* mp = P.m[at.leaf] + at.off;
  float* vp = P.v[at.leaf] + at.off;
  const float m = *mp + a.one_minus_b1 * (g - *mp);
  const float v = *vp * a.b2 + a.one_minus_b2 * (g * g);
  *mp = m;
  *vp = v;
  *pp = *pp + a.neg_step_size * (m / (sqrtf(v) / a.bc2_sqrt + a.eps));
}

}  // namespace ppo_grad
