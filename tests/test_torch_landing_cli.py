"""The port's landing-benchmark CLI on the CPU: the JAX package's flags,
one JSON dict with its keys, in float32 and with bf16 convolutions."""

import json
import os
import subprocess
import sys

from autonomous_quadrotor_environment_tpu_torch.fixtures import LANDING_POLICY, SOLVED_CONTROLLER

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = ("eval_reward", "eval_solved", "eval_time_s", "eval_finished")


def test_eval_landing_cli_on_the_cpu():
    cmd = [sys.executable, "-m", "autonomous_quadrotor_environment_tpu_torch.apps.eval_landing",
           "--controller", SOLVED_CONTROLLER, "--policy", LANDING_POLICY,
           "--episodes", "2", "--seed", "0", "--device", "cpu"]
    # One thread: the eager small ops gain nothing from more, and the test
    # workers already share the cores.
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=240, env=env)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert set(out) == set(KEYS)
    assert out["eval_finished"] == 1.0 and 0.0 <= out["eval_solved"] <= 1.0
    assert 0.0 < out["eval_time_s"] <= 152 * 10 * 0.01
    # bf16 convolutions (the landing trainer's default compute dtype).
    bf16 = subprocess.run(cmd + ["--conv-dtype", "bfloat16"], cwd=REPO, capture_output=True,
                          text=True, timeout=240, env=env)
    assert bf16.returncode == 0, bf16.stderr
    out = json.loads(bf16.stdout.strip().splitlines()[-1])
    assert set(out) == set(KEYS) and out["eval_finished"] == 1.0
