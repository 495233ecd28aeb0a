"""Whole-rollout kernel: T env steps x policy forward in one launch.

Counterpart of `ops/rollout_fused.py` in the JAX package. `fused_rollout`
runs the entire rollout -- featurizer window, actor + critic forward,
Gaussian sampling, RK4 physics, reward, termination and pool-based
auto-reset -- for B envs over T steps:

* on CUDA tensors, as one launch of the hand-written kernel in
  `csrc/rollout_fused.cu`, which keeps each env's packed state on chip for
  all T steps, runs the actor's products on the tensor cores in 3xTF32
  inside the loop and the critic over the stored observations after it.
  The kernel is built per hidden width in `WIDTHS`; a model of any width
  up to 256 runs on the next one up, its weights zero-padded
  (`weight_pack`), which changes no output. Wider models, of any width,
  run on `csrc/rollout_wide.cu` (the weights streamed through shared
  memory; above 512 units the tile's h1 in a scratch in device memory
  unless the envs fill one wave of 32-env tiles, which hold it to 1152),
  which reads its width at run time and takes any multiple of
  `WIDE_STEP`: a model runs zero-padded on the next one;
* on CPU tensors, as `rollout_plain`, a Python loop of exactly the per-step
  body below (the counterpart of the JAX package's `rollout_twin`), which
  is also the reference the kernel is held against on the card.

All randomness is an input: action noise eps ~ N(0, 1) of shape (T, 4, B)
and a P-deep pool of fresh reset states. Sampling is
action = mean + std * eps, so the per-dim logprob is
-0.5*eps^2 - log_std - 0.5*log(2pi) exactly.

Layout: every per-env quantity is (features, envs), envs fastest. Packed
state rows (ROWS=128, B):
    0:3    pos          3:6    vel         6:10  quat        10:13 omega
    13:88  hist (75)    88:91  prev_ang    91:94 vel_target
    94:98  last_action  98     i           99    prev_shaping
    100    has_shaping  101    abs_sum     102   pool slot
    103    done         104    solved      105:108 ang_vel   rest zeros
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..config import BB_ANG, BB_VEL, EnvConfig
from ..core.quaternion import quat_euler, quat_normalize
from ..envs.hover import EnvState
from . import _build

ROWS = 128
OBS = 75
MISC = 16
WIDTHS = (32, 64, 128, 256)  # the hidden widths the narrow kernels are built for
# The wide rollout (`csrc/rollout_wide.cu`) takes every width from
# WIDE_FROM, padded to a multiple of WIDE_STEP, as the wide gradient kernels
# do (from `ppo_fused_t.WIDE_FROM`). At 256 the 256 instantiation stays: it
# took 25.02 ms at bench.py's shape against the wide design's 33.32 ms
# (`chip_smoke.py` kernel_options on an NVIDIA H100 80GB HBM3 at 700 W).
WIDE_FROM, WIDE_STEP = WIDTHS[-1] + 1, 128
WIDE_K1 = -(-OBS // 32) * 32  # the wide rollout's input depth (96)
ACT = 4
_LOG_2PI = math.log(2.0 * math.pi)
# The kernels' offsets within one head's arrays (a weight pack, a partial
# of the gradients' workspace, their flat output) are 32-bit floats.
INT32_MAX = 2 ** 31 - 1

# Row offsets in the packed state (see module docstring).
_POS, _VEL, _QUAT, _OMEGA = 0, 3, 6, 10
_HIST = 13
_PREV_ANG = 88
_VEL_TGT = 91
_LAST_ACT = 94
_I, _PREV_SHAPING, _HAS_SHAPING, _ABS_SUM, _SLOT, _DONE, _SOLVED = (
    98, 99, 100, 101, 102, 103, 104,
)
_ANG_VEL = 105


def supports(env_cfg: EnvConfig, learn_std: bool, obs_dim: int) -> bool:
    """Static eligibility check for the fused rollout path."""
    return (
        env_cfg.direct_control
        and not env_cfg.randomization.enabled
        and not learn_std
        and obs_dim == 75
        and env_cfg.hist_t * 15 == 75
        and _HIST + env_cfg.hist_t * 15 <= _PREV_ANG
    )


# ---------------------------------------------------------------------------
# Pack / unpack between EnvState and the (ROWS, B) matrix
# ---------------------------------------------------------------------------


def pack_env_state(states: EnvState) -> torch.Tensor:
    """Batched EnvState -> packed (ROWS, B) float32; the interleaved physics
    state is split into contiguous pos/vel/quat/omega row groups."""
    x = states.x.T.float()  # (13, B)
    b = x.shape[1]

    def row(v):
        return v.float()[None]

    s = torch.cat(
        [
            x[0:5:2], x[1:6:2], x[6:10], x[10:13],
            states.hist.T.float(),
            states.prev_ang.T.float(),
            states.vel_target.T.float(),
            states.last_action.T.float(),
            row(states.i),
            row(states.prev_shaping),
            row(states.has_shaping),
            row(states.abs_sum),
            torch.zeros(1, b, dtype=torch.float32, device=x.device),  # slot
            row(states.done),
            row(states.solved),
            states.ang_vel.T.float(),
        ],
        dim=0,
    )
    pad = torch.zeros(ROWS - s.shape[0], b, dtype=torch.float32, device=x.device)
    return torch.cat([s, pad], dim=0)


def unpack_env_state(s: torch.Tensor, template: EnvState) -> EnvState:
    """Packed (ROWS, B) -> EnvState with ``template``'s dtypes. `ang` is
    recomputed from the quaternion; `dom` is taken from the template, since
    randomization is off on this path."""
    pos, vel = s[_POS:_POS + 3], s[_VEL:_VEL + 3]
    x = torch.stack([pos, vel], dim=1).reshape(6, -1)
    x = torch.cat([x, s[_QUAT:_QUAT + 4], s[_OMEGA:_OMEGA + 3]], dim=0).T
    ang = quat_euler(quat_normalize(s[_QUAT:_QUAT + 4].T))
    t = template
    return t.replace(
        x=x.to(t.x.dtype),
        i=s[_I].to(t.i.dtype),
        prev_shaping=s[_PREV_SHAPING].to(t.prev_shaping.dtype),
        has_shaping=s[_HAS_SHAPING] > 0.5,
        prev_ang=s[_PREV_ANG:_PREV_ANG + 3].T.to(t.prev_ang.dtype),
        ang=ang.to(t.ang.dtype),
        ang_vel=s[_ANG_VEL:_ANG_VEL + 3].T.to(t.ang_vel.dtype),
        done=s[_DONE] > 0.5,
        solved=s[_SOLVED] > 0.5,
        abs_sum=s[_ABS_SUM].to(t.abs_sum.dtype),
        hist=s[_HIST:_HIST + OBS].T.to(t.hist.dtype),
        last_action=s[_LAST_ACT:_LAST_ACT + 4].T.to(t.last_action.dtype),
        vel_target=s[_VEL_TGT:_VEL_TGT + 3].T.to(t.vel_target.dtype),
    )


# ---------------------------------------------------------------------------
# Per-config scalars
# ---------------------------------------------------------------------------


def _scalars(env_cfg: EnvConfig) -> dict:
    """Every env constant the transposed step math needs, as Python floats."""
    p = env_cfg.physics
    r = env_cfg.reward
    c8 = p.t2wr * p.mass * p.gravity / 8.0
    arm_coef = p.rho * p.c_d * p.beam_thickness * (p.d_arm / 10.0) * p.arm_drag_sum
    lim = [
        env_cfg.bb_vel, env_cfg.bb_vel, env_cfg.bb_vel,
        env_cfg.bb_ang_rp, env_cfg.bb_ang_rp, env_cfg.bb_ang_psi,
        env_cfg.bb_ang_vel, env_cfg.bb_ang_vel, env_cfg.bb_ang_vel,
    ]
    return dict(
        dt=env_cfg.dt,
        substeps=env_cfg.rk_substeps,
        c8=c8,
        inv_kf=1.0 / p.k_f,
        km_over_kf=p.k_m / p.k_f,
        d_arm=p.d_arm,
        i_r=p.i_r,
        drag=[-0.5 * p.rho * p.c_d * a for a in p.area],
        arm_coef=arm_coef,
        inv_mass=1.0 / p.mass,
        gravity=p.gravity,
        inv_j=[1.0 / p.j_xx, 1.0 / p.j_yy, 1.0 / p.j_zz],
        j=[p.j_xx, p.j_yy, p.j_zz],
        bb=[l * env_cfg.bb_scale for l in lim],
        coefs=list(r.shaping_coefs),
        tr=list(r.tr),
        tr_p=list(r.tr_p),
        n_gate=math.sqrt(3.0) if r.cascade_ang_all3 else math.sqrt(2.0),
        ang_all3=r.cascade_ang_all3,
        ang_factor=r.cascade_ang_factor,
        p_c=r.p_c,
        solved_reward=r.solved_reward,
        broken_reward=r.broken_reward,
        terminal_replaces=r.terminal_replaces,
        zero_ctrl=2.0 / p.t2wr - 1.0,  # hover_action_direct
        max_steps=env_cfg.max_steps,
        training=env_cfg.training,
        hist=env_cfg.hist_t * 15,
    )


# ---------------------------------------------------------------------------
# atan2 / asin as the JAX package's Cephes-style f32 polynomials
# (arctan on [0, 1] after the (a-1)/(a+1) range reduction, extended by
# quadrant logic; asin via atan2(t, sqrt(1-t^2))). The kernel evaluates the
# same polynomials, so the port stays equal to the JAX spec.
# ---------------------------------------------------------------------------


def _atan_01(a):
    """arctan for a in [0, 1]."""
    big = a > 0.41421356
    x = torch.where(big, (a - 1.0) / (a + 1.0), a)
    z = x * x
    p = (
        ((8.05374449538e-2 * z - 1.38776856032e-1) * z + 1.99777106478e-1) * z
        - 3.33329491539e-1
    ) * z * x + x
    return p + torch.where(big, math.pi / 4.0, 0.0)


def _atan2(y, x):
    ax = torch.abs(x)
    ay = torch.abs(y)
    mx = torch.maximum(ax, ay)
    a = torch.minimum(ax, ay) / torch.clamp_min(mx, 1e-30)
    r = _atan_01(a)
    r = torch.where(ay > ax, math.pi / 2.0 - r, r)
    r = torch.where(x < 0.0, math.pi - r, r)
    return torch.where(y < 0.0, -r, r)


def _asin(t):
    t = torch.clamp(t, -1.0, 1.0)
    return _atan2(t, torch.sqrt(torch.clamp_min(1.0 - t * t, 0.0)))


# ---------------------------------------------------------------------------
# Transposed step math (the plain version's per-step body)
# ---------------------------------------------------------------------------


def _deriv(pos, vel, q, omega, thrust, moment, omega_r, C):
    """drone_eq on (3|4, B) row groups, randomization identity, wind zero."""
    qn = q * torch.rsqrt(torch.sum(q * q, dim=0, keepdim=True))
    a, b, c, d = qn[0:1], qn[1:2], qn[2:3], qn[3:4]
    r00 = a * a + b * b - c * c - d * d
    r01 = 2 * (b * c - a * d)
    r02 = 2 * (b * d + a * c)
    r10 = 2 * (b * c + a * d)
    r11 = a * a - b * b + c * c - d * d
    r12 = 2 * (c * d - a * b)
    r20 = 2 * (b * d - a * c)
    r21 = 2 * (c * d + a * b)
    r22 = a * a - b * b - c * c + d * d

    vx, vy, vz = vel[0:1], vel[1:2], vel[2:3]
    # v_body = rot.T @ vel
    vb0 = r00 * vx + r10 * vy + r20 * vz
    vb1 = r01 * vx + r11 * vy + r21 * vz
    vb2 = r02 * vx + r12 * vy + r22 * vz
    fd0 = C["drag"][0] * torch.abs(vb0) * vb0
    fd1 = C["drag"][1] * torch.abs(vb1) * vb1
    fd2 = C["drag"][2] * torch.abs(vb2) * vb2 + thrust

    # f_inertial = rot @ f_body; accel = f/m - g z
    ax = (r00 * fd0 + r01 * fd1 + r02 * fd2) * C["inv_mass"]
    ay = (r10 * fd0 + r11 * fd1 + r12 * fd2) * C["inv_mass"]
    az = (r20 * fd0 + r21 * fd1 + r22 * fd2) * C["inv_mass"] - C["gravity"]

    w0, w1, w2 = omega[0:1], omega[1:2], omega[2:3]
    # m_drag (z doubled) + m_gyro + moment - omega x (J omega)
    m0 = (
        moment[0]
        - C["arm_coef"] * torch.abs(w0) * w0
        - w0 * omega_r
        - (w1 * C["j"][2] * w2 - w2 * C["j"][1] * w1)
    )
    m1 = (
        moment[1]
        - C["arm_coef"] * torch.abs(w1) * w1
        + w1 * omega_r
        - (w2 * C["j"][0] * w0 - w0 * C["j"][2] * w2)
    )
    m2 = (
        moment[2]
        - 2.0 * C["arm_coef"] * torch.abs(w2) * w2
        - (w0 * C["j"][1] * w1 - w1 * C["j"][0] * w0)
    )
    dw = torch.cat([m0 * C["inv_j"][0], m1 * C["inv_j"][1], m2 * C["inv_j"][2]], dim=0)

    q0, q1, q2, q3 = qn[0:1], qn[1:2], qn[2:3], qn[3:4]
    dq = 0.5 * torch.cat(
        [
            -w0 * q1 - w1 * q2 - w2 * q3,
            w0 * q0 + w2 * q2 - w1 * q3,
            w1 * q0 - w2 * q1 + w0 * q3,
            w2 * q0 + w1 * q1 - w0 * q2,
        ],
        dim=0,
    )
    accel = torch.cat([ax, ay, az], dim=0)
    return vel, accel, dq, dw


def step_math(s: torch.Tensor, a_raw: torch.Tensor, C: dict):
    """One env step on the packed (ROWS, B) state with action (4, B).

    Transposed restatement of `envs/hover.step` (direct control, no
    randomization). Returns (s_next before reset, reward (1,B), done (1,B),
    solved (1,B)), the flags as 0/1 floats."""
    pos, vel = s[_POS:_POS + 3], s[_VEL:_VEL + 3]
    q, omega = s[_QUAT:_QUAT + 4], s[_OMEGA:_OMEGA + 3]
    nh = C["hist"]

    # f2F
    a = torch.clamp(a_raw, -1.0, 1.0)
    f = (a + 1.0) * C["c8"]
    thrust = torch.sum(f, dim=0, keepdim=True)
    moment = [
        (f[2:3] - f[0:1]) * C["d_arm"],
        (f[1:2] - f[3:4]) * C["d_arm"],
        (-f[0:1] + f[1:2] - f[2:3] + f[3:4]) * C["km_over_kf"],
    ]
    w = torch.sqrt(f * C["inv_kf"])
    omega_r = (-w[0:1] + w[1:2] - w[2:3] + w[3:4]) * C["i_r"]

    # RK4
    h = C["dt"] / C["substeps"]
    for _ in range(C["substeps"]):
        k1 = _deriv(pos, vel, q, omega, thrust, moment, omega_r, C)
        k2 = _deriv(
            pos + 0.5 * h * k1[0], vel + 0.5 * h * k1[1],
            q + 0.5 * h * k1[2], omega + 0.5 * h * k1[3],
            thrust, moment, omega_r, C,
        )
        k3 = _deriv(
            pos + 0.5 * h * k2[0], vel + 0.5 * h * k2[1],
            q + 0.5 * h * k2[2], omega + 0.5 * h * k2[3],
            thrust, moment, omega_r, C,
        )
        k4 = _deriv(
            pos + h * k3[0], vel + h * k3[1],
            q + h * k3[2], omega + h * k3[3],
            thrust, moment, omega_r, C,
        )
        c = h / 6.0
        pos = pos + c * (k1[0] + 2 * k2[0] + 2 * k3[0] + k4[0])
        vel = vel + c * (k1[1] + 2 * k2[1] + 2 * k3[1] + k4[1])
        q = q + c * (k1[2] + 2 * k2[2] + 2 * k3[2] + k4[2])
        omega = omega + c * (k1[3] + 2 * k2[3] + 2 * k3[3] + k4[3])
    q = q * torch.rsqrt(torch.sum(q * q, dim=0, keepdim=True))

    # Euler angles through the Cephes atan2/asin
    q0, q1, q2, q3 = q[0:1], q[1:2], q[2:3], q[3:4]
    phi = _atan2(2 * (q0 * q1 + q2 * q3), 1 - 2 * (q1 * q1 + q2 * q2))
    theta = _asin(2 * (q0 * q2 - q3 * q1))
    psi = _atan2(2 * (q0 * q3 + q1 * q2), 1 - 2 * (q2 * q2 + q3 * q3))
    ang = torch.cat([phi, theta, psi], dim=0)
    i_new = s[_I:_I + 1] + 1.0
    ang_vel = (ang - s[_PREV_ANG:_PREV_ANG + 3]) * (1.0 / C["dt"])

    # Bounding box on |vel(3), ang(3), omega(3)|
    bb = C["bb"]
    bb_done = (
        torch.any(torch.abs(vel) >= bb[0], dim=0, keepdim=True)
        | (torch.abs(phi) >= bb[3])
        | (torch.abs(theta) >= bb[4])
        | (torch.abs(psi) >= bb[5])
        | torch.any(torch.abs(omega) >= bb[6], dim=0, keepdim=True)
    )

    # hover_reward on the velocity error
    verr = vel - s[_VEL_TGT:_VEL_TGT + 3]

    def ssq(v):
        return torch.sum(v * v, dim=0, keepdim=True)

    c0, c1, c2 = C["coefs"]
    shaping = -(
        c0 * torch.sqrt(ssq(verr)) * (1.0 / BB_VEL)
        + c1 * torch.abs(psi) * 0.25
        + c2 * torch.sqrt(ssq(ang[0:2])) * (1.0 / BB_ANG)
    )
    r_norm = torch.sqrt(ssq(verr) + psi * psi)
    ang_norm = torch.sqrt(ssq(ang) if C["ang_all3"] else ssq(ang[0:2]))
    taken = torch.zeros_like(bb_done)
    bonus = torch.zeros_like(shaping)
    for tr_i, trp_i in zip(C["tr"], C["tr_p"]):
        hit = ~taken & (r_norm < 2.0 * tr_i)
        inner = ang_norm < C["n_gate"] * tr_i * C["ang_factor"]
        bonus = bonus + torch.where(hit, trp_i * (1.0 + inner.to(s.dtype)), 0.0)
        taken = taken | hit
    shaping = shaping + bonus

    has_prev = s[_HAS_SHAPING:_HAS_SHAPING + 1] > 0.5
    reward = torch.where(has_prev, shaping - s[_PREV_SHAPING:_PREV_SHAPING + 1], 0.0)
    da = a - C["zero_ctrl"]
    reward = reward - C["p_c"] * torch.sum(da * da, dim=0, keepdim=True)

    solved = (ssq(verr) + ssq(ang) + ssq(omega)) < 9.0 * C["tr"][0] ** 2
    timeout = i_new >= C["max_steps"]
    if C["terminal_replaces"]:
        solved_r = torch.full_like(reward, C["solved_reward"])
        broken_r = torch.full_like(reward, C["broken_reward"])
    else:
        solved_r = reward + C["solved_reward"]
        broken_r = reward + C["broken_reward"]
    reward = torch.where(
        solved, solved_r,
        torch.where(timeout, reward, torch.where(bb_done, broken_r, reward)),
    )
    done = bb_done | timeout
    if C["training"]:
        done = done | solved

    # Effort accumulation (effort = clipped action)
    abs_sum = s[_ABS_SUM:_ABS_SUM + 1] + torch.sqrt(ssq(a))

    # hist push: [raw action, vel error, q, dq]
    dq_new = 0.5 * torch.cat(
        [
            -omega[0:1] * q1 - omega[1:2] * q2 - omega[2:3] * q3,
            omega[0:1] * q0 + omega[2:3] * q2 - omega[1:2] * q3,
            omega[1:2] * q0 - omega[2:3] * q1 + omega[0:1] * q3,
            omega[2:3] * q0 + omega[1:2] * q1 - omega[0:1] * q2,
        ],
        dim=0,
    )
    feat = torch.cat([a_raw, verr, q, dq_new], dim=0)
    hist = torch.cat([s[_HIST + 15:_HIST + nh], feat], dim=0)

    done_f, solved_f = done.to(s.dtype), solved.to(s.dtype)
    s_next = torch.cat(
        [
            pos, vel, q, omega, hist,
            ang,                                   # prev_ang
            s[_VEL_TGT:_VEL_TGT + 3],
            a,                                     # last_action (clipped)
            i_new,
            shaping,
            torch.ones_like(shaping),              # has_shaping
            abs_sum,
            s[_SLOT:_SLOT + 1],
            done_f,
            solved_f,
            ang_vel,
            s[_ANG_VEL + 3:],                      # padding rows
        ],
        dim=0,
    )
    return s_next, reward, done_f, solved_f


def _policy(hist, wT, eps, action_std, log_std):
    """Transposed actor + critic forward and reparameterized sample.

    hist (75, B); wT = 12 transposed leaves; eps (4, B) standard normals.
    Returns (action (4,B), logprob (4,B), value (1,B))."""
    w1, b1, w2, b2, w3, b3, v1, c1, v2, c2, v3, c3 = wT
    h1 = torch.tanh(w1 @ hist + b1)
    h2 = torch.tanh(w2 @ h1 + b2)
    mean = torch.tanh(w3 @ h2 + b3)
    g1 = torch.tanh(v1 @ hist + c1)
    g2 = torch.tanh(v2 @ g1 + c2)
    value = v3 @ g2 + c3
    action = mean + action_std * eps
    logprob = -0.5 * eps * eps - (log_std + 0.5 * _LOG_2PI)
    return action, logprob, value


def _pool_select(pool, slot, p_size):
    """fresh[r, l] = pool[slot[l] % P, r, l]."""
    m = torch.remainder(slot, float(p_size))
    fresh = torch.zeros_like(pool[0])
    for p_i in range(p_size):
        fresh = fresh + torch.where(m == float(p_i), pool[p_i], 0.0)
    return fresh


def _merge_reset(s_next, fresh, done):
    """where(done, fresh episode, stepped), with the pool-slot counter row
    advanced by `done`."""
    merged = torch.where(done > 0.5, fresh, s_next)
    slot_row = s_next[_SLOT:_SLOT + 1] + done
    return torch.cat([merged[:_SLOT], slot_row, merged[_SLOT + 1:]], dim=0)


def transpose_leaves(model) -> list[torch.Tensor]:
    """ActorCritic -> 12 transposed leaves in the flax leaf order
    (`agents.networks.LEAVES`): kernels (out, in), biases (out, 1)."""
    out = []
    for layer in model.linears():
        out.append(layer.weight.detach())
        out.append(layer.bias.detach()[:, None])
    return out


def rollout_plain(s0, noise, pool, wT, C: dict, action_std: float):
    """The plain PyTorch rollout: a loop of exactly the per-step body (the
    counterpart of the JAX package's `rollout_twin`).

    Returns (s_final (ROWS,B), obs (T,75,B), misc (T,16,B)) like
    `fused_rollout`."""
    log_std = math.log(action_std)
    s = s0
    obs_t, misc_t = [], []
    for eps_t in noise:
        obs = s[_HIST:_HIST + OBS]
        action, logprob, value = _policy(obs, wT, eps_t, action_std, log_std)
        s_next, reward, done, solved = step_math(s, action, C)
        fresh = _pool_select(pool, s_next[_SLOT:_SLOT + 1], pool.shape[0])
        s = _merge_reset(s_next, fresh, done)
        obs_t.append(obs)
        misc_t.append(torch.cat(
            [action, logprob, value, reward, done, solved, torch.zeros_like(action)], dim=0
        ))
    return s, torch.stack(obs_t), torch.stack(misc_t)


# ---------------------------------------------------------------------------
# The kernel's wrapper
# ---------------------------------------------------------------------------


class _Consts(ctypes.Structure):
    """Mirror of `struct Consts` in csrc/rollout_fused.cu (same field
    order). Every value is the float32 rounding of the Python double that
    the plain version uses."""

    _fields_ = [
        ("h", ctypes.c_float), ("h_half", ctypes.c_float), ("h_sixth", ctypes.c_float),
        ("substeps", ctypes.c_int),
        ("c8", ctypes.c_float), ("inv_kf", ctypes.c_float), ("km_over_kf", ctypes.c_float),
        ("d_arm", ctypes.c_float), ("i_r", ctypes.c_float),
        ("drag", ctypes.c_float * 3),
        ("arm_coef", ctypes.c_float), ("arm_coef2", ctypes.c_float),
        ("inv_mass", ctypes.c_float), ("gravity", ctypes.c_float),
        ("inv_j", ctypes.c_float * 3), ("j", ctypes.c_float * 3),
        ("bb", ctypes.c_float * 9),
        ("coefs", ctypes.c_float * 3),
        ("inv_bb_vel", ctypes.c_float), ("inv_bb_ang", ctypes.c_float),
        ("tr2", ctypes.c_float * 3), ("gate", ctypes.c_float * 3), ("tr_p", ctypes.c_float * 3),
        ("ang_all3", ctypes.c_int),
        ("p_c", ctypes.c_float), ("solved_thr", ctypes.c_float),
        ("solved_reward", ctypes.c_float), ("broken_reward", ctypes.c_float),
        ("terminal_replaces", ctypes.c_int),
        ("zero_ctrl", ctypes.c_float), ("max_steps", ctypes.c_float), ("inv_dt", ctypes.c_float),
        ("training", ctypes.c_int),
    ]


def _consts(C: dict) -> _Consts:
    if len(C["tr"]) != 3 or len(C["tr_p"]) != 3:
        raise ValueError("the kernel takes exactly three cascade thresholds")
    h = C["dt"] / C["substeps"]

    def arr(vals):
        return (ctypes.c_float * len(vals))(*vals)

    return _Consts(
        h=h, h_half=0.5 * h, h_sixth=h / 6.0, substeps=C["substeps"],
        c8=C["c8"], inv_kf=C["inv_kf"], km_over_kf=C["km_over_kf"],
        d_arm=C["d_arm"], i_r=C["i_r"], drag=arr(C["drag"]),
        arm_coef=C["arm_coef"], arm_coef2=2.0 * C["arm_coef"],
        inv_mass=C["inv_mass"], gravity=C["gravity"],
        inv_j=arr(C["inv_j"]), j=arr(C["j"]), bb=arr(C["bb"]), coefs=arr(C["coefs"]),
        inv_bb_vel=1.0 / BB_VEL, inv_bb_ang=1.0 / BB_ANG,
        tr2=arr([2.0 * t for t in C["tr"]]),
        gate=arr([C["n_gate"] * t * C["ang_factor"] for t in C["tr"]]),
        tr_p=arr(C["tr_p"]),
        ang_all3=int(C["ang_all3"]),
        p_c=C["p_c"], solved_thr=9.0 * C["tr"][0] ** 2,
        solved_reward=C["solved_reward"], broken_reward=C["broken_reward"],
        terminal_replaces=int(C["terminal_replaces"]),
        zero_ctrl=C["zero_ctrl"], max_steps=float(C["max_steps"]), inv_dt=1.0 / C["dt"],
        training=int(C["training"]),
    )


def _leaf_shapes(hidden: int) -> list[tuple]:
    return [
        (hidden, OBS), (hidden, 1), (hidden, hidden), (hidden, 1), (4, hidden), (4, 1),
        (hidden, OBS), (hidden, 1), (hidden, hidden), (hidden, 1), (1, hidden), (1, 1),
    ]


def is_wide(hidden: int) -> bool:
    """Whether a model of ``hidden`` units runs on the wide kernels."""
    return hidden >= WIDE_FROM


def kernel_width(hidden: int) -> int:
    """The width a model of ``hidden`` units runs on: the smallest of
    `WIDTHS` that holds it, or on the wide rollout ``hidden`` rounded up to
    `WIDE_STEP` (either is the wide gradient kernels' width too)."""
    if not is_wide(hidden):
        return next(w for w in WIDTHS if hidden <= w)
    return -(-hidden // WIDE_STEP) * WIDE_STEP


def check_offsets(what: str, floats: int, hidden: int) -> None:
    """Raise unless an array of ``floats`` floats of a model of ``hidden``
    units is one that the kernels' 32-bit offsets address, naming the bytes
    it needs: the one limit on a width the kernels have besides the card's
    memory."""
    if floats > INT32_MAX:
        raise ValueError(
            f"a model of {hidden} hidden units needs {4 * floats} bytes of {what}, more "
            f"than the kernels' 32-bit offsets address ({4 * INT32_MAX} bytes)"
        )


def device_buffer(floats: int, device: torch.device, what: str, hidden: int) -> torch.Tensor:
    """An uninitialised float32 buffer of ``floats`` on ``device``; where the
    card's memory cannot hold it, an error naming the bytes it needs."""
    try:
        return torch.empty(floats, dtype=torch.float32, device=device)
    except torch.cuda.OutOfMemoryError as err:
        raise RuntimeError(
            f"a model of {hidden} hidden units needs {4 * floats} bytes of {what} on "
            f"{device}, more than it has free"
        ) from err


def source(hidden: int) -> str:
    """The kernel source a model of ``hidden`` units runs on."""
    return "rollout_wide" if is_wide(hidden) else "rollout_fused"


def library(hidden: int) -> tuple:
    """The build's defines (`_build.build`) of the `source` library that a
    model of ``hidden`` units runs on: one per narrow width, none for the
    wide library, which serves every wide width."""
    return () if is_wide(hidden) else (("H", kernel_width(hidden)),)


def pack_offsets(width: int, k1: int) -> dict:
    """Offsets (floats) in one head's weight pack at instantiated width
    ``width`` and input depth ``k1``, as the kernels declare them (P_*)."""
    o = {"P_W1": 0}
    o["P_W2"] = o["P_W1"] + width * k1
    o["P_W3"] = o["P_W2"] + width * width
    o["P_B1"] = o["P_W3"] + ACT * width
    o["P_B2"] = o["P_B1"] + width
    o["P_B3"] = o["P_B2"] + width
    o["PACK"] = o["P_B3"] + ACT
    return o


def weight_pack(leaves: list, width: int, k1: int) -> torch.Tensor:
    """The kernels' (2, PACK) weights: per head W1 (out, in) zero-padded to
    (width, k1), W2 to (width, width), W3 to (4, width), b1, b2 to width, b3
    to 4. ``leaves`` are the 12 ActorCritic leaves in flax leaf order,
    kernels (out, in), biases (out,) or (out, 1), of any width <= ``width``
    and obs width <= ``k1``. The padded units have zero weights in and out
    and a zero bias: their activations are tanh(0) = 0 and they add exact
    zeros to every sum, so the pack computes what the leaves compute."""
    o = pack_offsets(width, k1)
    pack = torch.zeros(2, o["PACK"], dtype=torch.float32, device=leaves[0].device)
    for head, (w1, b1, w2, b2, w3, b3) in enumerate((leaves[:6], leaves[6:])):
        p = pack[head]
        h, obs = w1.shape
        n_out = w3.shape[0]
        p[o["P_W1"]:o["P_W2"]].view(width, k1)[:h, :obs] = w1
        p[o["P_W2"]:o["P_W3"]].view(width, width)[:h, :h] = w2
        p[o["P_W3"]:o["P_B1"]].view(ACT, width)[:n_out, :h] = w3
        p[o["P_B1"]:o["P_B1"] + h] = b1.reshape(-1)
        p[o["P_B2"]:o["P_B2"] + h] = b2.reshape(-1)
        p[o["P_B3"]:o["P_B3"] + n_out] = b3.reshape(-1)
    return pack


def _check(name, t, shape, device, dtype=torch.float32):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{name}: want {dtype} {tuple(shape)} on {device}, "
            f"got {t.dtype} {tuple(t.shape)} on {t.device}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(s0, noise, pool, wT, C, action_std):
    device = s0.device
    steps, _, b = noise.shape
    p_size = pool.shape[0]
    _check("s0", s0, (ROWS, b), device)
    _check("noise", noise, (steps, 4, b), device)
    if p_size < 1:
        raise ValueError("the reset pool must hold at least one state per env")
    _check("pool", pool, (p_size, ROWS, b), device)
    if len(wT) != 12:
        raise ValueError("wT must hold the 12 transposed ActorCritic leaves")
    hidden = wT[0].shape[0]
    width = kernel_width(hidden)
    wide = is_wide(hidden)
    k1 = WIDE_K1 if wide else 80
    check_offsets("weight pack a head", pack_offsets(width, k1)["PACK"], hidden)
    for i, (w, shape) in enumerate(zip(wT, _leaf_shapes(hidden))):
        if w.device != device or w.dtype != torch.float32 or tuple(w.shape) != shape:
            raise ValueError(
                f"leaf {i}: want float32 {shape} on {device}, "
                f"got {w.dtype} {tuple(w.shape)} on {w.device}"
            )
    name = source(hidden)
    lib = _build.load(name, library(hidden))
    pack = weight_pack(wT, width, k1)
    want = lib.rollout_wide_pack_floats(hidden) if wide else lib.rollout_fused_pack_floats()
    if pack.shape[1] != want:
        raise RuntimeError("weight pack size disagrees with the kernel's")
    if wide:
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        scratch = device_buffer(max(lib.rollout_wide_scratch_floats(hidden, b, steps, sms), 1),
                                device, "rollout scratch (h1 of each CTA)", hidden)

    obs = torch.empty(steps, OBS, b, dtype=torch.float32, device=device)
    misc = torch.empty(steps, MISC, b, dtype=torch.float32, device=device)
    s_final = torch.empty(ROWS, b, dtype=torch.float32, device=device)
    consts = _consts(C)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        args = (s0.data_ptr(), noise.data_ptr(), pool.data_ptr(), pack.data_ptr(),
                obs.data_ptr(), misc.data_ptr(), s_final.data_ptr(),
                b, steps, p_size, ctypes.addressof(consts),
                action_std, math.log(action_std) + 0.5 * _LOG_2PI)
        if wide:
            err = lib.rollout_wide(*args, hidden, scratch.data_ptr(), sms, device.index, stream)
        else:
            err = lib.rollout_fused(*args, device.index, stream)
    if err != 0:
        msg = lib.cuda_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: error {err} ({msg})")
    fused_rollout.launches += 1
    return s_final, obs, misc


def fused_rollout(
    s0: torch.Tensor,      # (ROWS, B) packed
    noise: torch.Tensor,   # (T, 4, B) standard normals
    pool: torch.Tensor,    # (P, ROWS, B) packed fresh episodes
    wT: list,              # 12 transposed leaves
    env_cfg: EnvConfig,
    action_std: float,
):
    """Run the whole rollout: one kernel launch for CUDA tensors, the plain
    version for CPU tensors.

    Returns (s_final (ROWS,B), obs (T,75,B), misc (T,16,B)) where misc rows
    are [action(4), logprob(4), value, reward, done, solved, zeros(4)].
    `fused_rollout.launches` counts the kernel launches."""
    if not supports(env_cfg, learn_std=False, obs_dim=OBS):
        raise ValueError(
            "the fused rollout takes direct control, no randomization and 75-dim obs"
        )
    C = _scalars(env_cfg)
    if s0.device.type == "cuda":
        return _launch(s0, noise, pool, wT, C, action_std)
    if s0.device.type != "cpu":
        raise ValueError(f"fused_rollout runs on CUDA or CPU tensors, not {s0.device}")
    return rollout_plain(s0, noise, pool, wT, C, action_std)


fused_rollout.launches = 0
