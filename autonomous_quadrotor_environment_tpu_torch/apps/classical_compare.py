"""Classical-controller comparison: PID vs LQR vs RL, identical seeds.

Counterpart of `apps/classical_compare.py` in the JAX package (the
reference's five-leg same-start comparison, lqr_quad.py:10-171,
pid_vel_control.py:15-173, ppo_quad_eval.py:25-66, analyzed by
classical_controller_results/results_analyzer.py:7-90): 20 episodes x 500
steps from the SAME seeded initial states, legs = {LQR, LQR-unclipped,
PID, PID-unclipped, RL}. It runs on the CUDA card unless given
``--device cpu``; on the card each leg's step loop replays CUDA graphs of
100 steps (`utils.graphs.scan`).

Fidelity notes, each as in the JAX package:
  * Initial states: `reference_start_states` replays the reference's
    seeded `np.random` stream (`env.seed(1)`: per episode the
    robust-parameter draws, then the reset state), so the episodes start
    from the reference's literal 20 states. The 20 episodes of a leg are
    one batch, as the JAX package's `vmap` has them.
  * Warmup: LQR runs T=1 (lqr_quad.py:115-118), PID and RL T=5.
  * Loop order: PID steps FIRST with the hover action, then computes the
    next action from the post-step state (pid_vel_control.py:137-155); LQR
    and RL compute the action first (lqr_quad.py:125-165,
    ppo_quad_eval.py:50-60).
  * "clipped" selects BOTH the env's motor-saturation flag and the
    controller's gain/weight set. RL has one leg (direct control,
    training=False).
  * Log layout (E, 500, 13) = [vel(3), ang(3), ang_vel(3), step_effort(4)]
    per step, saved as .npz.
  * Metrics (results_analyzer.py:23-90): success = ||last[0:4]|| < 0.05;
    settling time, overshoot and control effort averaged over the
    successful episodes only.

    python -m autonomous_quadrotor_environment_tpu_torch.apps.classical_compare \\
        --legs all --policy autonomous_quadrotor_environment_tpu/fixtures/nn_solved_128_0.msgpack
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ..agents.networks import ActorCritic
from ..baselines import (
    VELOCITY_GAINS,
    VELOCITY_GAINS_UNCLIPPED,
    cascaded_pid_control,
    cascaded_pid_init,
    lqr_control,
    make_lqr_gains,
)
from ..config import BB_POS, BB_VEL, EnvConfig
from ..core.dynamics import f2F, f2w
from ..core.quaternion import euler_quat
from ..core.randomization import zeros_domain
from ..device import resolve_device
from ..envs import hover
from ..utils import graphs
from .robust_eval import load_policy

N_EPISODES = 20
MAX_STEPS = 500
SUCCESS_NORM = 0.05  # reference results_analyzer.py:23-27
CHUNK = 100  # steps per graph replay on the card


def reference_start_states(n_episodes: int = N_EPISODES, seed: int = 1) -> np.ndarray:
    """The reference's exact seeded initial states (quadrotor_env.py:426-445).

    `env.seed(seed)` calls `np.random.seed` (:193); each `reset()` then
    consumes, in order: the robust-parameter draws (random(4), normal(0,.3,1),
    random(4), normal(0,.1,3), :98-101, drawn even with robust control off)
    and the state draws (:440-445). The quaternion is computed in float32,
    as the JAX package computes it (x64 off)."""
    np.random.seed(seed)
    states = np.zeros((n_episodes, 13))
    for j in range(n_episodes):
        np.random.random(4)
        np.random.normal(0, 0.3, 1)
        np.random.random(4)
        np.random.normal(np.zeros(3), 0.1, [3])
        ang = np.random.rand(3) - 0.5
        q = euler_quat(torch.as_tensor(ang, dtype=torch.float32)).numpy()
        pos = np.clip(np.random.normal([0, 0, 0], 2), -BB_POS / 2, BB_POS / 2)
        vel = np.clip(np.random.normal([0, 0, 0], 2), -BB_VEL / 2, BB_VEL / 2)
        omega = np.clip(np.random.normal([0, 0, 0], 2), -BB_VEL * 1.5, BB_POS * 1.5)
        states[j, 0:5:2] = pos
        states[j, 1:6:2] = vel
        states[j, 6:10] = q
        states[j, 10:13] = omega
    return states


def _step_effort(action: torch.Tensor, env_cfg: EnvConfig) -> torch.Tensor:
    """Per-motor normalized effort of the step just taken (reference
    env.step_effort, quadrotor_env.py:222-244 / :268)."""
    dom = zeros_domain(action.shape[0], action.dtype, action.device)
    if env_cfg.direct_control:
        return f2F(action, env_cfg.physics, dom).step_effort
    return f2w(action[:, 0], action[:, 1:4], env_cfg.physics, dom,
               clipped=env_cfg.clipped).step_effort


def _log_step(env_s: hover.EnvState, action: torch.Tensor, env_cfg: EnvConfig) -> torch.Tensor:
    """(B, 13) [vel(3), ang(3), ang_vel(3), step_effort(4)]: the reference's
    memory_step (lqr_quad.py:165, pid_vel_control.py:156)."""
    return torch.cat([env_s.x[:, 1:6:2], env_s.ang, env_s.ang_vel,
                      _step_effort(action, env_cfg)], dim=-1)


def _reset(env_cfg: EnvConfig, starts, device) -> hover.EnvState:
    x0 = torch.as_tensor(np.asarray(starts), dtype=torch.float32).to(device)
    return hover.reset(None, env_cfg, det_state=x0)


def _episode_major(log: torch.Tensor) -> np.ndarray:
    """A (T, E, 13) step-major log as the (E, T, 13) numpy array."""
    return log.transpose(0, 1).cpu().numpy()


@torch.no_grad()
def run_pid(env_cfg: EnvConfig, starts: np.ndarray, gains, device=None) -> np.ndarray:
    """Velocity-regulation cascaded PID, step-first loop (reference
    pid_vel_control.py:137-156); the (E, 500, 13) log."""
    dev = resolve_device(device)
    phys = env_cfg.physics
    env_s = _reset(env_cfg, starts, dev)
    e = env_s.x.shape[0]
    hover_action = torch.tensor([phys.gravity * phys.mass, 0.0, 0.0, 0.0],
                                device=dev).expand(e, 4).contiguous()

    def body(carry, i, x, consts):
        env_s, pid_s, action = carry
        env_s, _ = hover.step(env_s, action, env_cfg)
        log = _log_step(env_s, action, env_cfg)
        zeros = torch.zeros_like(env_s.ang)
        pid_s, action = cascaded_pid_control(
            pid_s, env_s.x[:, 1:6:2], zeros, env_s.ang, env_s.ang_vel, zeros, zeros,
            zeros[:, 0], gains, phys, env_cfg.dt,
        )
        return (env_s, pid_s, action), log

    carry = (env_s, cascaded_pid_init(e, device=dev), hover_action)
    _, log = graphs.scan(("classical_pid", env_cfg, gains), body, carry, MAX_STEPS, chunk=CHUNK)
    return _episode_major(log)


@torch.no_grad()
def run_lqr(env_cfg: EnvConfig, starts: np.ndarray, device=None) -> np.ndarray:
    """Velocity-regulation double-loop LQR, act-then-step loop (reference
    lqr_quad.py:125-165); the (E, 500, 13) log."""
    dev = resolve_device(device)
    gains = make_lqr_gains(env_cfg.physics, clipped=env_cfg.clipped, device=dev)
    env_s = _reset(env_cfg, starts, dev)

    def body(carry, i, x, gains):
        env_s, euler_ant = carry
        action, euler_ant = lqr_control(
            gains, env_s.x[:, 1:6:2], env_s.ang, env_s.ang_vel, euler_ant,
            env_cfg.physics, env_cfg.dt,
        )
        env_s, _ = hover.step(env_s, action, env_cfg)
        return (env_s, euler_ant), _log_step(env_s, action, env_cfg)

    _, log = graphs.scan(("classical_lqr", env_cfg), body, (env_s, env_s.ang), MAX_STEPS,
                         consts=gains, chunk=CHUNK)
    return _episode_major(log)


def make_rl_runner(env_cfg_direct: EnvConfig, model: ActorCritic):
    """``runner(starts) -> (E, 500, 13)`` log of the RL leg, the starts an
    (E, 13) array or tensor. On the card its chunks replay graphs captured
    at the first call that read the model's parameters in place, so
    repeated calls (`train_control --polish` flies the leg at every eval)
    see the trained weights."""
    params = list(model.parameters())
    device = params[0].device

    def body(env_s, i, x, consts):
        action = model.actor_mean(env_s.hist)
        env_s, _ = hover.step(env_s, action, env_cfg_direct)
        return env_s, _log_step(env_s, action, env_cfg_direct)

    @torch.no_grad()
    def runner(starts) -> np.ndarray:
        env_s = _reset(env_cfg_direct, starts, device)
        _, log = graphs.scan(("classical_rl", id(model), env_cfg_direct), body, env_s,
                             MAX_STEPS, chunk=CHUNK, params=params)
        return _episode_major(log)

    return runner


def run_rl(env_cfg_direct: EnvConfig, starts: np.ndarray, model: ActorCritic) -> np.ndarray:
    """The trained PPO controller, deterministic actor (reference
    ppo_quad_eval.py:44-62: training=False, T=5)."""
    return make_rl_runner(env_cfg_direct, model)(starts)


def _settling_time(norm_ok: np.ndarray, dt: float) -> float | None:
    """Last entry into the |vel|<0.05 band (reference ts_calculator,
    results_analyzer.py:31-43)."""
    ts = None
    last = True
    t = len(norm_ok)
    for i, ok in enumerate(reversed(norm_ok)):
        if not ok and last:
            ts = (t - i) * dt
        last = ok
    return ts


def _overshoot(episode: np.ndarray) -> float:
    """Mean per-axis max |vel| after the first sign change (reference
    ov_calculator, results_analyzer.py:45-60)."""
    ov = np.zeros(3)
    for i in range(3):
        ax = episode[:, i]
        neg = ax < 0
        # The reference latches the first step-to-step sign change at index
        # >0 (a change at j=0, initial prev "positive", writes passou=0,
        # leaving the latch open for the next change).
        changes = np.nonzero(neg[1:] != neg[:-1])[0] + 1
        if len(changes) > 0:
            ov[i] = np.max(np.abs(ax[changes[0]:]))
    return float(np.mean(ov))


def analyze(log: np.ndarray, env_cfg: EnvConfig, dt: float = 0.01) -> dict:
    """The reference analyzer's per-file table (results_analyzer.py:16-90):
    success on ||last[0:4]||, the remaining metrics masked to successes."""
    phys = env_cfg.physics
    succ, ts_l, ov_l, ef_l, efmax_l, epp_l, ev_l = [], [], [], [], [], [], []
    final_norms = []
    for ep in log:
        final_norms.append(float(np.linalg.norm(ep[-1, 0:4])))
        ok = final_norms[-1] < SUCCESS_NORM
        succ.append(ok)
        if not ok:
            continue
        newton = (ep[:, -4:] + 1.0) * phys.mass * phys.gravity * phys.t2wr / 8.0
        vel_norm = np.linalg.norm(ep[:, 0:3], axis=1)
        ts_l.append(_settling_time(vel_norm < SUCCESS_NORM, dt) or 0.0)
        ov_l.append(_overshoot(ep))
        ef_l.append(float(np.mean(np.sum(np.abs(newton), axis=1))))
        efmax_l.append(float(np.max(np.sum(np.abs(newton), axis=1))))
        epp_l.append(float(np.linalg.norm(ep[-1, 0:3])))
        ev_l.append(float(np.mean(vel_norm)))
    any_ok = len(ts_l) > 0
    return {
        # Per-episode ||last[0:4]|| against the 0.05 cut (the LQR-clipped
        # leg has episodes within ~1% of it).
        "episode_final_norms": sorted(final_norms),
        "success_rate": float(np.mean(succ)),
        "settling_time_mean_s": float(np.mean(ts_l)) if any_ok else None,
        "overshoot_mean": float(np.mean(ov_l)) if any_ok else None,
        "ss_error_mean": float(np.mean(epp_l)) if any_ok else None,
        "accum_error_mean": float(np.mean(ev_l)) if any_ok else None,
        "effort_mean_n": float(np.mean(ef_l)) if any_ok else None,
        "effort_max_n": float(np.mean(efmax_l)) if any_ok else None,
    }


def leg_env(leg: str) -> EnvConfig:
    """The env config of a leg: indirect control for PID and LQR (their
    warmup, the clip flag of the leg), direct control for RL."""
    if leg == "rl":
        return EnvConfig(n_steps=MAX_STEPS, warmup=5, direct_control=True, training=False)
    warmup = 1 if leg.startswith("lqr") else 5
    return EnvConfig(n_steps=MAX_STEPS, warmup=warmup, direct_control=False, training=True,
                     clipped=not leg.endswith("_unclipped"))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--seed", type=int, default=1, help="reference uses 1")
    p.add_argument("--policy", type=str, default=None, help="RL checkpoint (.msgpack)")
    p.add_argument("--policy-size", type=int, default=128)
    p.add_argument(
        "--legs", type=str, default="all",
        help="comma list from {pid,pid_unclipped,lqr,lqr_unclipped,rl} or 'all'",
    )
    p.add_argument("--out", type=str, default="runs/classical")
    p.add_argument("--device", type=str, default=None,
                   help="torch device; the CUDA card when omitted")
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    legs = (
        ["lqr", "lqr_unclipped", "pid", "pid_unclipped", "rl"]
        if args.legs == "all"
        else args.legs.split(",")
    )
    starts = reference_start_states(N_EPISODES, args.seed)
    os.makedirs(args.out, exist_ok=True)
    results = {}
    for leg in legs:
        if leg not in ("pid", "pid_unclipped", "lqr", "lqr_unclipped", "rl"):
            raise SystemExit(f"unknown leg {leg!r}")
        cfg = leg_env(leg)
        if leg == "pid":
            log = run_pid(cfg, starts, VELOCITY_GAINS, device)
        elif leg == "pid_unclipped":
            log = run_pid(cfg, starts, VELOCITY_GAINS_UNCLIPPED, device)
        elif leg.startswith("lqr"):
            log = run_lqr(cfg, starts, device)
        else:
            if not args.policy:
                continue
            log = run_rl(cfg, starts, load_policy(args.policy, args.policy_size, device))
        results[leg] = analyze(log, cfg)
        np.savez(f"{args.out}/{leg}_log_same_start.npz", log)

    with open(f"{args.out}/summary.json", "w") as f:
        json.dump(results, f, indent=2)
    print(json.dumps(results, indent=2))
    return results


if __name__ == "__main__":
    main()
