// The env side of the rollout kernels (`rollout_fused.cu`, hidden widths up
// to 256; `rollout_wide.cu`, wider): the packed state's rows, the env
// constants, and one env step of a thread's env (RK4 physics, reward,
// termination, the featurizer window), the port's `ops/rollout_fused.py:
// step_math` for a single env. Math stays accurate (no fast-math): tanhf,
// sqrtf and IEEE division; Euler angles use the same Cephes atan2/asin
// polynomials as the JAX package and the port's plain version.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

// Env constants; field order matches `_Consts` in ops/rollout_fused.py.
struct Consts {
  float h, h_half, h_sixth;
  int substeps;
  float c8, inv_kf, km_over_kf, d_arm, i_r;
  float drag[3];
  float arm_coef, arm_coef2, inv_mass, gravity;
  float inv_j[3], j[3];
  float bb[9];
  float coefs[3];
  float inv_bb_vel, inv_bb_ang;
  float tr2[3], gate[3], tr_p[3];
  int ang_all3;
  float p_c, solved_thr, solved_reward, broken_reward;
  int terminal_replaces;
  float zero_ctrl, max_steps, inv_dt;
  int training;
};

namespace rollout {

constexpr int ROWS = 128;
constexpr int OBS = 75;
constexpr int NA = 4;             // action means
constexpr int MISC = 16;

// Packed-state rows (ops/rollout_fused.py).
constexpr int R_POS = 0, R_VEL = 3, R_QUAT = 6, R_OMEGA = 10, R_HIST = 13;
constexpr int R_PREV_ANG = 88, R_VEL_TGT = 91, R_LAST_ACT = 94, R_I = 98;
constexpr int R_PREV_SHAPING = 99, R_HAS_SHAPING = 100, R_ABS_SUM = 101;
constexpr int R_SLOT = 102, R_DONE = 103, R_SOLVED = 104, R_ANG_VEL = 105;

constexpr float PI_F = 3.14159265358979323846f;

__device__ __forceinline__ float atan_01(float a) {
  const bool big = a > 0.41421356f;
  const float x = big ? (a - 1.0f) / (a + 1.0f) : a;
  const float z = x * x;
  const float p =
      (((8.05374449538e-2f * z - 1.38776856032e-1f) * z + 1.99777106478e-1f) * z -
       3.33329491539e-1f) * z * x + x;
  return p + (big ? PI_F / 4.0f : 0.0f);
}

__device__ __forceinline__ float atan2_c(float y, float x) {
  const float ax = fabsf(x), ay = fabsf(y);
  const float mx = fmaxf(ax, ay);
  const float a = fminf(ax, ay) / fmaxf(mx, 1e-30f);
  float r = atan_01(a);
  r = (ay > ax) ? PI_F / 2.0f - r : r;
  r = (x < 0.0f) ? PI_F - r : r;
  return (y < 0.0f) ? -r : r;
}

__device__ __forceinline__ float asin_c(float t) {
  t = fminf(fmaxf(t, -1.0f), 1.0f);
  return atan2_c(t, sqrtf(fmaxf(1.0f - t * t, 0.0f)));
}

// drone_eq on one env, randomization identity, wind zero.
__device__ __forceinline__ void deriv(const float* vel, const float* q, const float* om,
                                      float thrust, const float* moment, float omega_r,
                                      const Consts& C, float* dvel, float* dq, float* dw) {
  const float inv = 1.0f / sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
  const float a = q[0] * inv, b = q[1] * inv, c = q[2] * inv, d = q[3] * inv;
  const float r00 = a * a + b * b - c * c - d * d;
  const float r01 = 2.0f * (b * c - a * d);
  const float r02 = 2.0f * (b * d + a * c);
  const float r10 = 2.0f * (b * c + a * d);
  const float r11 = a * a - b * b + c * c - d * d;
  const float r12 = 2.0f * (c * d - a * b);
  const float r20 = 2.0f * (b * d - a * c);
  const float r21 = 2.0f * (c * d + a * b);
  const float r22 = a * a - b * b - c * c + d * d;

  const float vx = vel[0], vy = vel[1], vz = vel[2];
  const float vb0 = r00 * vx + r10 * vy + r20 * vz;
  const float vb1 = r01 * vx + r11 * vy + r21 * vz;
  const float vb2 = r02 * vx + r12 * vy + r22 * vz;
  const float fd0 = C.drag[0] * fabsf(vb0) * vb0;
  const float fd1 = C.drag[1] * fabsf(vb1) * vb1;
  const float fd2 = C.drag[2] * fabsf(vb2) * vb2 + thrust;

  dvel[0] = (r00 * fd0 + r01 * fd1 + r02 * fd2) * C.inv_mass;
  dvel[1] = (r10 * fd0 + r11 * fd1 + r12 * fd2) * C.inv_mass;
  dvel[2] = (r20 * fd0 + r21 * fd1 + r22 * fd2) * C.inv_mass - C.gravity;

  const float w0 = om[0], w1 = om[1], w2 = om[2];
  const float m0 = moment[0] - C.arm_coef * fabsf(w0) * w0 - w0 * omega_r -
                   (w1 * C.j[2] * w2 - w2 * C.j[1] * w1);
  const float m1 = moment[1] - C.arm_coef * fabsf(w1) * w1 + w1 * omega_r -
                   (w2 * C.j[0] * w0 - w0 * C.j[2] * w2);
  const float m2 = moment[2] - C.arm_coef2 * fabsf(w2) * w2 -
                   (w0 * C.j[1] * w1 - w1 * C.j[0] * w0);
  dw[0] = m0 * C.inv_j[0];
  dw[1] = m1 * C.inv_j[1];
  dw[2] = m2 * C.inv_j[2];

  dq[0] = 0.5f * (-w0 * b - w1 * c - w2 * d);
  dq[1] = 0.5f * (w0 * a + w2 * c - w1 * d);
  dq[2] = 0.5f * (w1 * a - w2 * b + w0 * d);
  dq[3] = 0.5f * (w2 * a + w1 * b - w0 * c);
}

// One env step on the packed state column `s` (row r at s[r * SLD]), in
// place: the port's `step_math` for a single env.
template <int SLD>
__device__ void step_env(float* s, const float* a_raw, const Consts& C,
                         float& reward_out, float& done_out, float& solved_out) {
#define S_(r) s[(r) * SLD]
  float pos[3], vel[3], q[4], om[3];
  for (int k = 0; k < 3; ++k) {
    pos[k] = S_(R_POS + k);
    vel[k] = S_(R_VEL + k);
    om[k] = S_(R_OMEGA + k);
  }
  for (int k = 0; k < 4; ++k) q[k] = S_(R_QUAT + k);

  // f2F
  float a[4], f[4], w[4];
  for (int k = 0; k < 4; ++k) {
    a[k] = fminf(fmaxf(a_raw[k], -1.0f), 1.0f);
    f[k] = (a[k] + 1.0f) * C.c8;
    w[k] = sqrtf(f[k] * C.inv_kf);
  }
  const float thrust = f[0] + f[1] + f[2] + f[3];
  const float moment[3] = {(f[2] - f[0]) * C.d_arm, (f[1] - f[3]) * C.d_arm,
                           (-f[0] + f[1] - f[2] + f[3]) * C.km_over_kf};
  const float omega_r = (-w[0] + w[1] - w[2] + w[3]) * C.i_r;

  // RK4
  for (int sub = 0; sub < C.substeps; ++sub) {
    float k1v[3], k1q[4], k1w[3], k2v[3], k2q[4], k2w[3];
    float k3v[3], k3q[4], k3w[3], k4v[3], k4q[4], k4w[3];
    float tv[3], tq[4], tw[3];
    deriv(vel, q, om, thrust, moment, omega_r, C, k1v, k1q, k1w);
    for (int k = 0; k < 3; ++k) { tv[k] = vel[k] + C.h_half * k1v[k]; tw[k] = om[k] + C.h_half * k1w[k]; }
    for (int k = 0; k < 4; ++k) tq[k] = q[k] + C.h_half * k1q[k];
    deriv(tv, tq, tw, thrust, moment, omega_r, C, k2v, k2q, k2w);
    // position stages: dpos = vel of the stage
    const float* k1p = vel;
    float k2p[3], k3p[3], k4p[3];
    for (int k = 0; k < 3; ++k) k2p[k] = tv[k];
    for (int k = 0; k < 3; ++k) { tv[k] = vel[k] + C.h_half * k2v[k]; tw[k] = om[k] + C.h_half * k2w[k]; }
    for (int k = 0; k < 4; ++k) tq[k] = q[k] + C.h_half * k2q[k];
    deriv(tv, tq, tw, thrust, moment, omega_r, C, k3v, k3q, k3w);
    for (int k = 0; k < 3; ++k) k3p[k] = tv[k];
    for (int k = 0; k < 3; ++k) { tv[k] = vel[k] + C.h * k3v[k]; tw[k] = om[k] + C.h * k3w[k]; }
    for (int k = 0; k < 4; ++k) tq[k] = q[k] + C.h * k3q[k];
    deriv(tv, tq, tw, thrust, moment, omega_r, C, k4v, k4q, k4w);
    for (int k = 0; k < 3; ++k) k4p[k] = tv[k];
    for (int k = 0; k < 3; ++k) {
      pos[k] = pos[k] + C.h_sixth * (k1p[k] + 2.0f * k2p[k] + 2.0f * k3p[k] + k4p[k]);
    }
    for (int k = 0; k < 3; ++k) {
      vel[k] = vel[k] + C.h_sixth * (k1v[k] + 2.0f * k2v[k] + 2.0f * k3v[k] + k4v[k]);
      om[k] = om[k] + C.h_sixth * (k1w[k] + 2.0f * k2w[k] + 2.0f * k3w[k] + k4w[k]);
    }
    for (int k = 0; k < 4; ++k) {
      q[k] = q[k] + C.h_sixth * (k1q[k] + 2.0f * k2q[k] + 2.0f * k3q[k] + k4q[k]);
    }
  }
  {
    const float inv = 1.0f / sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
    for (int k = 0; k < 4; ++k) q[k] *= inv;
  }

  // Euler angles through the Cephes atan2/asin
  const float q0 = q[0], q1 = q[1], q2 = q[2], q3 = q[3];
  const float phi = atan2_c(2.0f * (q0 * q1 + q2 * q3), 1.0f - 2.0f * (q1 * q1 + q2 * q2));
  const float theta = asin_c(2.0f * (q0 * q2 - q3 * q1));
  const float psi = atan2_c(2.0f * (q0 * q3 + q1 * q2), 1.0f - 2.0f * (q2 * q2 + q3 * q3));
  const float ang[3] = {phi, theta, psi};
  const float i_new = S_(R_I) + 1.0f;
  float ang_vel[3];
  for (int k = 0; k < 3; ++k) ang_vel[k] = (ang[k] - S_(R_PREV_ANG + k)) * C.inv_dt;

  // Bounding box on |vel(3), ang(3), omega(3)|
  const bool bb_done = fabsf(vel[0]) >= C.bb[0] || fabsf(vel[1]) >= C.bb[0] ||
                       fabsf(vel[2]) >= C.bb[0] || fabsf(phi) >= C.bb[3] ||
                       fabsf(theta) >= C.bb[4] || fabsf(psi) >= C.bb[5] ||
                       fabsf(om[0]) >= C.bb[6] || fabsf(om[1]) >= C.bb[6] ||
                       fabsf(om[2]) >= C.bb[6];

  // hover_reward on the velocity error
  float verr[3];
  for (int k = 0; k < 3; ++k) verr[k] = vel[k] - S_(R_VEL_TGT + k);
  const float ssq_verr = verr[0] * verr[0] + verr[1] * verr[1] + verr[2] * verr[2];
  const float ssq_rp = phi * phi + theta * theta;
  const float ssq_ang = ssq_rp + psi * psi;
  float shaping = -(C.coefs[0] * sqrtf(ssq_verr) * C.inv_bb_vel + C.coefs[1] * fabsf(psi) * 0.25f +
                    C.coefs[2] * sqrtf(ssq_rp) * C.inv_bb_ang);
  const float r_norm = sqrtf(ssq_verr + psi * psi);
  const float ang_norm = sqrtf(C.ang_all3 ? ssq_ang : ssq_rp);
  bool taken = false;
  float bonus = 0.0f;
  for (int k = 0; k < 3; ++k) {
    const bool hit = !taken && r_norm < C.tr2[k];
    const bool inner = ang_norm < C.gate[k];
    bonus = bonus + (hit ? C.tr_p[k] * (1.0f + (inner ? 1.0f : 0.0f)) : 0.0f);
    taken = taken || hit;
  }
  shaping = shaping + bonus;

  float reward = S_(R_HAS_SHAPING) > 0.5f ? shaping - S_(R_PREV_SHAPING) : 0.0f;
  float da2 = 0.0f;
  for (int k = 0; k < 4; ++k) {
    const float da = a[k] - C.zero_ctrl;
    da2 += da * da;
  }
  reward = reward - C.p_c * da2;

  const float ssq_om = om[0] * om[0] + om[1] * om[1] + om[2] * om[2];
  const bool solved = (ssq_verr + ssq_ang + ssq_om) < C.solved_thr;
  const bool timeout = i_new >= C.max_steps;
  const float solved_r = C.terminal_replaces ? C.solved_reward : reward + C.solved_reward;
  const float broken_r = C.terminal_replaces ? C.broken_reward : reward + C.broken_reward;
  reward = solved ? solved_r : (timeout ? reward : (bb_done ? broken_r : reward));
  const bool done = bb_done || timeout || (C.training && solved);

  const float abs_sum = S_(R_ABS_SUM) + sqrtf(a[0] * a[0] + a[1] * a[1] + a[2] * a[2] + a[3] * a[3]);

  // hist push: shift left by one 15-feature step, append [raw action,
  // vel error, q, dq].
  for (int r = 0; r < OBS - 15; ++r) S_(R_HIST + r) = S_(R_HIST + 15 + r);
  float* tail = &S_(R_HIST + OBS - 15);
  for (int k = 0; k < 4; ++k) tail[k * SLD] = a_raw[k];
  for (int k = 0; k < 3; ++k) tail[(4 + k) * SLD] = verr[k];
  for (int k = 0; k < 4; ++k) tail[(7 + k) * SLD] = q[k];
  tail[11 * SLD] = 0.5f * (-om[0] * q1 - om[1] * q2 - om[2] * q3);
  tail[12 * SLD] = 0.5f * (om[0] * q0 + om[2] * q2 - om[1] * q3);
  tail[13 * SLD] = 0.5f * (om[1] * q0 - om[2] * q1 + om[0] * q3);
  tail[14 * SLD] = 0.5f * (om[2] * q0 + om[1] * q1 - om[0] * q2);

  for (int k = 0; k < 3; ++k) {
    S_(R_POS + k) = pos[k];
    S_(R_VEL + k) = vel[k];
    S_(R_OMEGA + k) = om[k];
    S_(R_PREV_ANG + k) = ang[k];
    S_(R_ANG_VEL + k) = ang_vel[k];
  }
  for (int k = 0; k < 4; ++k) {
    S_(R_QUAT + k) = q[k];
    S_(R_LAST_ACT + k) = a[k];
  }
  S_(R_I) = i_new;
  S_(R_PREV_SHAPING) = shaping;
  S_(R_HAS_SHAPING) = 1.0f;
  S_(R_ABS_SUM) = abs_sum;
  S_(R_DONE) = done ? 1.0f : 0.0f;
  S_(R_SOLVED) = solved ? 1.0f : 0.0f;
#undef S_
  reward_out = reward;
  done_out = done ? 1.0f : 0.0f;
  solved_out = solved ? 1.0f : 0.0f;
}

// Named barriers (0 is __syncthreads).
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(count) : "memory");
}

}  // namespace rollout
