"""The JAX package's own classical comparison, missions and step response on the CPU.

Runs, through the JAX package's entry points and runners on the CPU:

- `apps/classical_compare.py`'s five legs (20 reference starts x 500
  steps; the RL leg flies `fixtures/nn_solved_128_0.msgpack`): each
  episode's final norm ||last[0:4]||, in episode order, and the leg's rate;
- `apps/missions_eval.py`'s 14 episodes x 5000 steps with the PID and with
  the RL fixture on the true state: each episode's mean tracking error;
  and with the RL fixture on the fused sensor estimate (``--sensors``) at
  seeds 0, 1 and 2: each seed's mean and per-episode errors;
- `apps/step_response.py` (2000 steps, amplitude 1) with the RL fixture:
  the six cases' metrics.

It prints one JSON object per line, each named by ``"what"``. These are
the reference numbers that the PyTorch port's `chip_smoke.py` classical,
missions and step_response phases hold the card to (the card has no JAX,
so that script carries them as constants). Runs on the CPU in a few
minutes; ``--parts`` picks some of the three, ``--mission-steps`` flies the
missions' first steps only (`chip_smoke.py` holds the card to 2500):

    python scripts/classical_reference.py [--parts classical,missions,step_response]
        [--mission-steps 2500]
"""

import argparse
import json
import os
import sys
import tempfile

import jax

jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from autonomous_quadrotor_environment_tpu.apps import (  # noqa: E402
    classical_compare,
    missions_eval,
    step_response,
)
from autonomous_quadrotor_environment_tpu.fixtures import FIXTURE_DIR  # noqa: E402

POLICY = os.path.join(FIXTURE_DIR, "nn_solved_128_0.msgpack")
SENSOR_SEEDS = (0, 1, 2)


def emit(what: str, **fields) -> None:
    print(json.dumps({"what": what, **fields}), flush=True)


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--parts", default="classical,missions,step_response")
    p.add_argument("--mission-steps", type=int, default=missions_eval.MISSION_STEPS)
    args = p.parse_args()
    parts = args.parts.split(",")
    with tempfile.TemporaryDirectory() as out:
        if "classical" in parts:
            summary = classical_compare.main(["--legs", "all", "--policy", POLICY, "--out", out])
            for leg, row in summary.items():
                log = np.load(f"{out}/{leg}_log_same_start.npz")["arr_0"]
                norms = np.linalg.norm(log[:, -1, 0:4], axis=1)
                emit("classical", leg=leg, success_rate=row["success_rate"],
                     final_norms=[float(x) for x in norms])
        steps = ["--steps", str(args.mission_steps), "--out", out]
        if "missions" in parts:
            for mode, argv in (("pid", []), ("rl", ["--policy", POLICY])):
                res = missions_eval.main(argv + steps)
                emit("missions", mode=mode, seed=0, steps=args.mission_steps,
                     mean_track_err=res["mean_track_err"],
                     episodes=[r["mean_track_err"] for r in res["episodes"]])
            for seed in SENSOR_SEEDS:
                res = missions_eval.main(["--policy", POLICY, "--sensors", "--seed", str(seed)]
                                         + steps)
                emit("missions", mode="rl_sens", seed=seed, steps=args.mission_steps,
                     mean_track_err=res["mean_track_err"],
                     episodes=[r["mean_track_err"] for r in res["episodes"]])
    if "step_response" in parts:
        emit("step_response", steps=2000, amplitude=1.0,
             metrics=step_response.main(["--policy", POLICY]))


if __name__ == "__main__":
    main()
