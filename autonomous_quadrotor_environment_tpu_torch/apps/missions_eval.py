"""Mission-tracking evaluation of the RL controller or the cascaded PID.

Counterpart of `apps/missions_eval.py` in the JAX package (the
reference's mission harness and PID mission script, environment/
position.py:23-262 and PID_control.py:220-278): flies every episode of the
target table (missions/targets.py) with the RL policy, on the true state or
on the fused sensor estimate (``--sensors``), in the hybrid mode
(``--vision``: every 10th frame the body-attached camera's view of the
origin marker is rendered, the chessboard PnP pose solved and blended into
the INS), or with the cascaded PID, and writes the response-metrics table
as CSV and a JSON line. The 14 episodes fly as one batch; on the CUDA card
(the default; ``--device cpu`` otherwise) the step loop replays CUDA graphs
of 100 steps, and only the 10 due steps of a chunk render and solve.

Each episode's sensor draws come from a generator of its own, seeded from
``--seed`` and the episode (the counterpart of the JAX package's
``fold_in(PRNGKey(seed), ep)``; the streams themselves differ).

    python -m autonomous_quadrotor_environment_tpu_torch.apps.missions_eval \\
        --policy autonomous_quadrotor_environment_tpu/fixtures/nn_solved_128_0.msgpack --sensors
"""

from __future__ import annotations

import argparse
import csv
import json
import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..agents.networks import ActorCritic
from ..baselines import POSITION_GAINS, cascaded_pid_control, cascaded_pid_init
from ..baselines.velocity_pid import vel_pid, vel_pid_init
from ..config import CameraConfig, EnvConfig, MarkerConfig, SensorConfig
from ..core.dynamics import aux_at_state
from ..core.quaternion import deriv_quat, quat_normalize
from ..core.randomization import zeros_domain
from ..device import resolve_device
from ..envs import hover
from ..envs.featurizer import feat_size, push_hist
from ..envs.sensors import (
    SensorNoise,
    draw_sensor_noise,
    reads_from_env,
    sensor_fused,
    sensor_reset,
)
from ..missions import (
    Trajectory,
    episode_n,
    gen_trajectory,
    mission_target,
    response_metrics,
    spiral_trajectory,
    stack_trajectories,
    target_parse,
)
from ..utils import graphs
from ..utils.cache import enable_compilation_cache
from ..vision import vision_correction_step, vision_fusion_init
from .robust_eval import load_policy
from .train_control import stream

MISSION_STEPS = 5000
CHUNK = 100  # steps per graph replay on the card
VISION_EVERY = 10  # the hybrid mode's cadence (vision_correction_step's ``every``)
_SENSORS = 3  # stream tag of the sensor draws


class SensorDraws(NamedTuple):
    """The draws of a sensor-mode mission batch: each episode's drift-rate
    uniforms (E, 3) for `sensor_reset`, and every step's fused-read noise
    with leading axes (steps, E)."""

    drift_u: torch.Tensor
    noise: SensorNoise


def _make_traj(spec, dt) -> Trajectory:
    if spec.mission_class == 1:
        return gen_trajectory(
            MISSION_STEPS, max(int(spec.time / dt), 1), np.asarray(spec.target), dt=dt
        )
    args = list(spec.target)
    return spiral_trajectory(
        int(args[0]), int(args[1]), args[2], args[3], args[4], np.asarray(args[5]), dt=dt
    )


def episode_trajectories(dt: float, device=None) -> Trajectory:
    """The tables of every episode of the target table, as one batch."""
    return stack_trajectories([_make_traj(target_parse(ep), dt)
                               for ep in range(episode_n())]).to(device)


def draw_sensors(seed: int, episodes: int, steps: int, device) -> SensorDraws:
    """Each episode's draws from its own generator (`train_control.stream`
    of ``seed``, the sensor tag and the episode): its drift uniforms, then
    its steps' noise."""
    drift, normal, uniform = [], [], []
    for ep in range(episodes):
        gen = torch.Generator(device=device).manual_seed(stream(seed, _SENSORS, ep))
        drift.append(torch.rand(3, generator=gen, device=device))
        noise = draw_sensor_noise(gen, (steps,))
        normal.append(noise.normal)
        uniform.append(noise.uniform)
    return SensorDraws(torch.stack(drift), SensorNoise(torch.stack(normal, 1),
                                                       torch.stack(uniform, 1)))


def _hover_start(env_cfg: EnvConfig, e: int, device) -> hover.EnvState:
    x0 = torch.zeros(e, 13, device=device)
    x0[:, 6] = 1.0
    return hover.reset(None, env_cfg, det_state=x0)


def make_mission_body(env_cfg: EnvConfig, model: ActorCritic, scfg: SensorConfig,
                      use_sensors: bool, use_vision: bool = False):
    """The per-step mission control body and its carry's initializer,
    ``body(carry, i, noise, table, phase) -> (carry, log)`` and
    ``init(episodes, drift_u) -> carry``.

    Shared by the batch runner below and the interactive rig
    (apps/live_mission.py), so every control mode has one implementation.
    The carry holds every mode's state (sensors, velocity PID, vision
    fusion) whatever the flags, so the modes' step loops share one carry
    and can be switched live (the reference's menu buttons flip
    REAL_CTRL/IMG_POS_DETER on the same running sim, menu.py:28-50). The
    body reads the RL controller with the outer velocity-error PID
    injecting the mission offset (reference position.py:232-247,
    velocity_pid.py), observing (state - mission target - velocity offset)
    through its own window, on the true state or (``use_sensors``) on the
    fused estimate from ``noise``; ``use_vision`` adds the hybrid
    ("IMG_POS_DETER") correction, due where ``phase`` (the step modulo
    `VISION_EVERY`, a Python int) is 1. The log row is [state(13), position
    error(3), its norm, the INS position error]."""
    device = next(model.parameters()).device
    phys, dt = env_cfg.physics, env_cfg.dt
    # The missions' camera has a higher resolution than the landing one,
    # like the reference's (its saved intrinsics imply a ~960 px buffer,
    # config/camera_calibration_cam_1.npz): the board must stay detectable
    # from cruise altitude.
    mission_cam = CameraConfig(width=480, height=480)
    marker_cfg = MarkerConfig()

    def init(e: int, drift_u: Optional[torch.Tensor] = None):
        env_s = _hover_start(env_cfg, e, device)
        aux0 = aux_at_state(env_s.x, torch.zeros(e, 4, device=device), phys,
                            zeros_domain(e, device=device))
        drift_u = torch.zeros(e, 3, device=device) if drift_u is None else drift_u.to(device)
        sens0 = sensor_reset(drift_u, reads_from_env(env_s.x, aux0), scfg)
        return (env_s, sens0, vel_pid_init(e, device=device), vision_fusion_init(e, device=device),
                torch.zeros(e, feat_size(5), device=device), torch.zeros(e, 4, device=device))

    def body(carry, i, noise, table, phase=None):
        env_s, sens_s, vp_s, f_s, hist, action = carry
        tgt = mission_target(Trajectory(*table, dt), i)
        x = env_s.x
        if use_sensors:
            # Diagnostics at the current state from the action that produced
            # it: one RHS evaluation, the reference's pairing.
            aux = aux_at_state(x, action, phys, env_s.dom, direct_control=env_cfg.direct_control)
            sens_s, fused = sensor_fused(sens_s, reads_from_env(x, aux), noise, scfg, phys, dt)
            state14 = fused.states_sens
            if use_vision:  # hybrid: PnP corrections into the INS
                f_s, sens_s, _ = vision_correction_step(
                    f_s, sens_s, x[:, 0:5:2], torch.zeros_like(x[:, 0:2]), i, dt, mission_cam,
                    marker_cfg, every=VISION_EVERY, quad_quat=x[:, 6:10], phase=phase)
        else:
            # True-state mode: the controller's quat_dot features must be
            # real (the reference feeds the env's quat_state).
            state14 = torch.cat([x[:, 0:10], deriv_quat(x[:, 10:13], quat_normalize(x[:, 6:10]))],
                                dim=-1)
        vp_s, verr = vel_pid(vp_s, state14, tgt, dt)
        hist = push_hist(hist, state14 - tgt - verr, action)
        action = model.actor_mean(hist)
        env_s, _ = hover.step(env_s, action, env_cfg)
        err_pos = env_s.x[:, 0:5:2] - tgt[:, 0:5:2]
        est_err = torch.linalg.vector_norm(sens_s.pos_ins - env_s.x[:, 0:5:2], dim=-1)
        log = torch.cat([env_s.x, err_pos, torch.linalg.vector_norm(err_pos, dim=-1)[:, None],
                         est_err[:, None]], dim=-1)
        return (env_s, sens_s, vp_s, f_s, hist, action), log

    return body, init


def make_rl_mission_runner(env_cfg: EnvConfig, model: ActorCritic, scfg: SensorConfig,
                           use_sensors: bool, steps: int, use_vision: bool = False):
    """``run(traj, draws=None) -> (E, steps, 18)`` logs of `make_mission_body`
    over the tables ``traj``, one episode per table; sensor mode
    (``use_sensors``, which ``use_vision`` needs) takes its draws ``draws``
    (`SensorDraws`)."""
    if use_vision and not use_sensors:
        raise ValueError("the hybrid (vision) mode corrects the fused sensor estimate: "
                         "it needs use_sensors")
    params = list(model.parameters())
    device = params[0].device
    body, init = make_mission_body(env_cfg, model, scfg, use_sensors, use_vision)

    @torch.no_grad()
    def run(traj: Trajectory, draws: Optional[SensorDraws] = None) -> np.ndarray:
        traj = traj.to(device)
        e = traj.positions.shape[0]
        if use_sensors and draws is None:
            raise ValueError("sensor mode needs its draws (draw_sensors)")
        carry = init(e, None if draws is None else draws.drift_u)
        noise = graphs.tree_map(lambda a: a.to(device), draws.noise) if use_sensors else None
        _, log = graphs.scan(("rl_mission", id(model), env_cfg, scfg, use_sensors, use_vision),
                             body, carry, steps, xs=noise,
                             consts=(traj.positions, traj.velocities), chunk=CHUNK,
                             params=params, period=VISION_EVERY if use_vision else None)
        return log.transpose(0, 1).cpu().numpy()

    return run


def make_pid_mission_runner(env_cfg: EnvConfig, steps: int, device=None):
    """``run(traj) -> (E, steps, 17)`` logs [state(13), position error(3),
    its norm] of the cascaded position PID tracking the tables."""
    dev = resolve_device(device)
    dt = env_cfg.dt

    def body(carry, i, x, table):
        env_s, pid_s = carry
        tgt = mission_target(Trajectory(*table, dt), i)
        s = env_s.x
        pid_s, action = cascaded_pid_control(
            pid_s, s[:, 0:5:2], s[:, 1:6:2], env_s.ang, env_s.ang_vel, tgt[:, 0:5:2],
            tgt[:, 1:6:2], torch.zeros_like(s[:, 0]), POSITION_GAINS, env_cfg.physics, dt,
        )
        env_s, _ = hover.step(env_s, action, env_cfg)
        err_pos = env_s.x[:, 0:5:2] - tgt[:, 0:5:2]
        log = torch.cat([env_s.x, err_pos, torch.linalg.vector_norm(err_pos, dim=-1)[:, None]],
                        dim=-1)
        return (env_s, pid_s), log

    @torch.no_grad()
    def run(traj: Trajectory) -> np.ndarray:
        traj = traj.to(dev)
        e = traj.positions.shape[0]
        carry = (_hover_start(env_cfg, e, dev), cascaded_pid_init(e, device=dev))
        _, log = graphs.scan(("pid_mission", env_cfg), body, carry, steps,
                             consts=(traj.positions, traj.velocities), chunk=CHUNK)
        return log.transpose(0, 1).cpu().numpy()

    return run


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--policy", type=str, default=None, help="RL checkpoint; omit for PID")
    p.add_argument("--policy-size", type=int, default=128)
    p.add_argument("--sensors", action="store_true",
                   help="control on fused sensor estimates instead of true state")
    p.add_argument("--vision", action="store_true",
                   help="hybrid mode: PnP pose corrections blended into the INS every 10 "
                        "frames (implies --sensors)")
    p.add_argument("--steps", type=int, default=MISSION_STEPS)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", type=str, default="runs/missions")
    p.add_argument("--device", type=str, default=None,
                   help="torch device; the CUDA card when omitted")
    return p


def main(argv=None) -> dict:
    enable_compilation_cache()
    args = build_parser().parse_args(argv)
    if args.vision:
        args.sensors = True
    device = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    scfg = SensorConfig()
    if args.policy:
        env_cfg = EnvConfig(n_steps=args.steps, direct_control=True, training=False)
        model = load_policy(args.policy, args.policy_size, device)
        name = "rl" + ("_vis" if args.vision else "_sens" if args.sensors else "")
        runner = make_rl_mission_runner(env_cfg, model, scfg, args.sensors, args.steps,
                                        use_vision=args.vision)
    else:
        env_cfg = EnvConfig(n_steps=args.steps, direct_control=False, training=False)
        name = "pid"
        runner = make_pid_mission_runner(env_cfg, args.steps, device)

    traj = episode_trajectories(env_cfg.dt, device)
    if args.policy and args.sensors:
        logs = runner(traj, draw_sensors(args.seed, episode_n(), args.steps, device))
    else:
        logs = runner(traj)

    rows = []
    for ep in range(episode_n()):
        spec = target_parse(ep)
        log = logs[ep]  # (T, 13 + 3 + 1 [+ 1]): state, err_pos, |err| [, INS error]
        y = log[:, 0:13].T
        err_sum = float(log[:, 16].sum())
        target3 = list(spec.target) if spec.mission_class == 1 else [0.0, 0.0, 0.0]
        m = response_metrics(
            y, target3[:3], control_effort=0.0, abs_error=err_sum,
            env_max_steps=args.steps, dt=env_cfg.dt,
        )
        m["episode"] = ep
        m["mission_class"] = spec.mission_class
        m["mean_track_err"] = float(log[:, 16].mean())
        rows.append(m)

    csv_path = f"{args.out}/{name}_results.csv"
    with open(csv_path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        w.writeheader()
        w.writerows(rows)
    results = {"episodes": rows,
               "mean_track_err": float(np.mean([r["mean_track_err"] for r in rows]))}
    if args.policy and args.sensors:  # the INS position error, log column 17
        results["mean_ins_err"] = float(np.mean([log[:, 17].mean() for log in logs]))
    print(json.dumps({"mean_track_err": results["mean_track_err"], "csv": csv_path}))
    return results


if __name__ == "__main__":
    main()
