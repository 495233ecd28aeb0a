"""The JAX package's own cross-eval of the shipped robust and nominal controllers.

Flies `fixtures/nn_robust_128_0.msgpack` and `fixtures/nn_solved_128_0.msgpack`
through `agents.make_eval_fn` (the eval `apps/robust_eval.py` reports) in the
calm env and the windy one (`RandomizationConfig(enabled=True)`: randomized
physics and 5 m/s gusts), `EnvConfig(n_steps=1000)`, 256 episodes at
PRNGKey(0), and prints one JSON line per policy x env cell. These are the
reference rates that the PyTorch port's `chip_smoke.py` robust_eval phase
holds the card to (the card has no JAX, so that script carries them as
constants). Runs on the CPU in about a minute:

    python scripts/robust_fixture_rate.py
"""

import json
import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from autonomous_quadrotor_environment_tpu.agents.ppo import make_eval_fn  # noqa: E402
from autonomous_quadrotor_environment_tpu.config import (  # noqa: E402
    EnvConfig,
    RandomizationConfig,
)
from autonomous_quadrotor_environment_tpu.fixtures import (  # noqa: E402
    load_robust_controller,
    load_solved_controller,
)

EPISODES, KEY = 256, 0


def main():
    policies = {"robust": load_robust_controller(), "nominal": load_solved_controller()}
    envs = {
        "calm": EnvConfig(n_steps=1000),
        "windy": EnvConfig(n_steps=1000, randomization=RandomizationConfig(enabled=True)),
    }
    for pol_name, (model, params) in policies.items():
        for env_name, cfg in envs.items():
            out = jax.jit(make_eval_fn(model, cfg, EPISODES))(params, jax.random.PRNGKey(KEY))
            print(json.dumps({"cell": f"{pol_name}/{env_name}", "episodes": EPISODES,
                              "key": KEY, **{k: float(v) for k, v in out.items()}}), flush=True)


if __name__ == "__main__":
    main()
