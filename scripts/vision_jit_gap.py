"""How far the JAX package's hybrid mission differs from itself, jitted and
op by op, beside the PyTorch port's run of the same draws.

tests/test_torch_missions_vision.py holds the port's hybrid (``--vision``)
runner to the JAX package's jitted one at 2 episodes x 41 steps, seed 0,
with the JAX draws injected. This script runs that case three ways on the
CPU: the JAX runner jitted, the JAX runner op by op (`jax.disable_jit`),
and the port's runner (eager, the JAX draws injected through
tests/torch_parity.py). Per episode it prints one JSON line: each run's
mean tracking error (log column 16) and mean INS error (column 17), and
their relative gaps to the jitted run. The gaps of the JAX package's two
runs to each other are the floor under the test's tolerances:

    python scripts/vision_jit_gap.py
"""

import json
import os
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from autonomous_quadrotor_environment_tpu.agents.networks import ActorCritic  # noqa: E402
from autonomous_quadrotor_environment_tpu.apps import missions_eval as jme  # noqa: E402
from autonomous_quadrotor_environment_tpu.config import EnvConfig, SensorConfig  # noqa: E402
from autonomous_quadrotor_environment_tpu.missions import target_parse  # noqa: E402
from autonomous_quadrotor_environment_tpu.utils import load_params  # noqa: E402
from autonomous_quadrotor_environment_tpu_torch import config as tconfig  # noqa: E402
from autonomous_quadrotor_environment_tpu_torch import missions as tmissions  # noqa: E402
from autonomous_quadrotor_environment_tpu_torch.apps import missions_eval as me  # noqa: E402
from autonomous_quadrotor_environment_tpu_torch.apps.robust_eval import load_policy  # noqa: E402
from autonomous_quadrotor_environment_tpu_torch.fixtures import SOLVED_CONTROLLER  # noqa: E402
from torch_parity import jax_mission_sensor_draws  # noqa: E402

STEPS, SEED, EPISODES = 41, 0, (0, 1)


def main():
    cfg = EnvConfig(n_steps=STEPS, direct_control=True, training=False)
    model = ActorCritic(hidden=128)
    params = load_params(SOLVED_CONTROLLER, model.init(jax.random.PRNGKey(0), jnp.zeros((1, 75))))
    run = jme.make_rl_mission_runner(cfg, model, params, SensorConfig(), True, STEPS,
                                     use_vision=True)
    tcfg = tconfig.EnvConfig(n_steps=STEPS, direct_control=True, training=False)
    traj = tmissions.stack_trajectories([me._make_traj(tmissions.target_parse(ep), tcfg.dt)
                                         for ep in EPISODES])
    t0 = time.time()
    port = me.make_rl_mission_runner(tcfg, load_policy(SOLVED_CONTROLLER, 128,
                                                       torch.device("cpu")),
                                     tconfig.SensorConfig(), True, STEPS, use_vision=True)(
        traj, jax_mission_sensor_draws(SEED, len(EPISODES), STEPS))
    port_s = time.time() - t0
    for ep in EPISODES:
        jtraj = jme._make_traj(target_parse(ep), cfg.dt)
        key = jax.random.fold_in(jax.random.PRNGKey(SEED), ep)
        t0 = time.time()
        jitted = np.asarray(run(jtraj, key))
        jit_s = time.time() - t0
        t0 = time.time()
        with jax.disable_jit():
            op = np.asarray(run(jtraj, key))
        op_s = time.time() - t0
        row = {"episode": ep, "seconds": {"jitted": jit_s, "op_by_op": op_s, "port": port_s}}
        for col, name in ((16, "track_err"), (17, "ins_err")):
            means = {"jitted": float(jitted[:, col].mean()), "op_by_op": float(op[:, col].mean()),
                     "port": float(port[ep, :, col].mean())}
            row[name] = means
            row[name + "_gap_to_jitted"] = {
                k: abs(v / means["jitted"] - 1.0) for k, v in means.items() if k != "jitted"}
            row[name + "_port_gap_to_op_by_op"] = abs(means["port"] / means["op_by_op"] - 1.0)
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
