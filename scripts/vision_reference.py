"""The JAX package's own vision pose and hybrid missions on the CPU.

Runs, through the JAX package's functions on the CPU:

- `vision/pipeline.py:vision_pose` with the missions' camera (480 x 480,
  body-attached) at the 64 poses of `POSES` (each quad position, marker
  position and attitude quaternion): its ok flag, env-frame position,
  quaternion and reprojection rms;
- `apps/missions_eval.py`'s RL runner with the solved fixture on the fused
  sensor estimate (``--sensors``) and in the hybrid mode (``--vision``,
  PnP fixes blended into the INS every 10 frames) at seeds 0, 1 and 2: each
  seed's mean tracking error (log column 16) and per-episode errors, and
  the mean INS position error (log column 17).

It prints one JSON object per line, each named by ``"what"``, and the
seconds each part took. These are the reference numbers that the PyTorch
port's `chip_smoke.py` vision and missions phases hold the card to (the
card has no JAX, so that script carries them as constants). A vision
mission seed takes minutes on a CPU (7,000 renders at 480 x 480);
``--seeds`` and ``--parts`` split the work across processes:

    python scripts/vision_reference.py [--parts poses,missions] [--seeds 0,1,2]
"""

import argparse
import json
import math
import os
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from autonomous_quadrotor_environment_tpu.agents.networks import ActorCritic  # noqa: E402
from autonomous_quadrotor_environment_tpu.apps import missions_eval  # noqa: E402
from autonomous_quadrotor_environment_tpu.config import (  # noqa: E402
    CameraConfig,
    EnvConfig,
    MarkerConfig,
    SensorConfig,
)
from autonomous_quadrotor_environment_tpu.fixtures import FIXTURE_DIR  # noqa: E402
from autonomous_quadrotor_environment_tpu.missions import episode_n, target_parse  # noqa: E402
from autonomous_quadrotor_environment_tpu.utils import load_params  # noqa: E402
from autonomous_quadrotor_environment_tpu.vision import vision_pose  # noqa: E402

POLICY = os.path.join(FIXTURE_DIR, "nn_solved_128_0.msgpack")
SEEDS = (0, 1, 2)
GROUND_Z = -5.0


def _quat(axis, deg):
    a = np.asarray(axis, np.float64)
    a = a / np.linalg.norm(a)
    h = math.radians(deg) / 2.0
    return [math.cos(h)] + list(math.sin(h) * a)


def poses():
    """64 (quad position (3,), marker position (2,), quaternion (4,)) rows,
    rounded to 4 decimals: the three round-trip poses of the JAX package's
    `tests/test_vision.py`, level; 13 level poses at 1-4 m; 40 poses tilted
    by up to 15 degrees at 1.5-3.5 m; 8 poses with the board out of view."""
    rng = np.random.default_rng(13)
    rows = []
    level = [1.0, 0.0, 0.0, 0.0]
    for quad_xy, marker_xy, h in [((0.0, 0.0), (0.0, 0.0), 1.6),
                                  ((0.3, -0.2), (0.1, 0.1), 2.0),
                                  ((-0.2, 0.25), (-0.1, 0.2), 1.2)]:
        rows.append(([quad_xy[0], quad_xy[1], h + GROUND_Z], list(marker_xy), level))
    for k in range(13):
        h = 1.0 + 0.25 * k
        rows.append(([0.1 * math.sin(k), 0.1 * math.cos(k), h + GROUND_Z], [0.0, 0.0], level))
    for _ in range(40):
        h = rng.uniform(1.5, 3.5)
        xy = rng.uniform(-0.3, 0.3, 2)
        axis = rng.normal(size=3)
        rows.append(([xy[0], xy[1], h + GROUND_Z], [0.0, 0.0],
                     _quat(axis, rng.uniform(0.0, 15.0))))
    for quad_xy, h, deg in [((5.0, 0.0), 2.0, 0.0), ((-6.0, 3.0), 3.0, 0.0),
                            ((20.0, 20.0), 4.0, 0.0), ((0.0, -4.0), 1.5, 0.0),
                            ((1.5, 0.0), 1.0, 15.0), ((0.0, 1.6), 1.2, 10.0),
                            ((-3.0, -3.0), 2.5, 15.0), ((0.0, 0.0), 0.2, 0.0)]:
        rows.append(([quad_xy[0], quad_xy[1], h + GROUND_Z], [0.0, 0.0],
                     _quat([0.3, 1.0, 0.0], deg)))
    return [[[round(float(v), 4) for v in part] for part in row] for row in rows]


def emit(what: str, **fields) -> None:
    print(json.dumps({"what": what, **fields}), flush=True)


def run_poses():
    t0 = time.time()
    cam, marker = CameraConfig(width=480, height=480), MarkerConfig()
    fn = jax.jit(lambda p, m, q: vision_pose(p, m, cam, marker, quad_quat=q))
    out = []
    for pos, mxy, quat in poses():
        o = fn(jnp.asarray(pos, jnp.float32), jnp.asarray(mxy, jnp.float32),
               jnp.asarray(quat, jnp.float32))
        out.append([bool(o.ok)] + [float(v) for v in o.pos_env] + [float(v) for v in o.quat]
                   + [float(o.rms)])
    emit("vision_pose", width=480, height=480, poses=poses(), out=out,
         seconds=time.time() - t0)


def run_missions(seeds):
    env_cfg = EnvConfig(n_steps=missions_eval.MISSION_STEPS, direct_control=True,
                        training=False)
    model = ActorCritic(hidden=128)
    params = load_params(POLICY, model.init(jax.random.PRNGKey(0), jnp.zeros((1, 75))))
    for mode, vision in (("rl_sens", False), ("rl_vis", True)):
        runner = missions_eval.make_rl_mission_runner(
            env_cfg, model, params, SensorConfig(), True, missions_eval.MISSION_STEPS,
            use_vision=vision)
        for seed in seeds:
            t0 = time.time()
            track, ins = [], []
            for ep in range(episode_n()):
                traj = missions_eval._make_traj(target_parse(ep), env_cfg.dt)
                key = jax.random.fold_in(jax.random.PRNGKey(seed), ep)
                log = np.asarray(runner(traj, key))
                track.append(float(log[:, 16].mean()))
                ins.append(float(log[:, 17].mean()))
            emit("missions", mode=mode, seed=seed, mean_track_err=float(np.mean(track)),
                 mean_ins_err=float(np.mean(ins)), episodes=track, ins_episodes=ins,
                 seconds=time.time() - t0)


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--parts", default="poses,missions")
    p.add_argument("--seeds", default=",".join(map(str, SEEDS)))
    args = p.parse_args()
    parts = args.parts.split(",")
    if "poses" in parts:
        run_poses()
    if "missions" in parts:
        run_missions([int(s) for s in args.seeds.split(",")])


if __name__ == "__main__":
    main()
