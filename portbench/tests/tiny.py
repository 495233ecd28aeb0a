"""A copy of the benchmark's files in a temporary root, every cell cut to a
size the CPU runs in seconds; the program is imported from the repository
and the frozen controller's file copied beside the copy."""

import json
import os
import shutil

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CONTROLLER = os.path.join("autonomous_quadrotor_environment_tpu", "fixtures",
                          "nn_solved_128_0.msgpack")
SIZES = {
    "hover_fused_8192x256": dict(num_envs=16, rollout_steps=16, minibatch_size=64,
                                 shuffle_block=8),
    "hover_defaults_1024x128": dict(num_envs=8, rollout_steps=8),
    "landing_train_1024x24": dict(num_envs=4, rollout_steps=3),
}
LANDING_MINIBATCH = 4


def copy_benchmark(dst) -> str:
    dst = str(dst)
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dst)
    shutil.copytree(os.path.join(ROOT, "portbench"), os.path.join(dst, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    os.makedirs(os.path.join(dst, os.path.dirname(CONTROLLER)))
    shutil.copy(os.path.join(ROOT, CONTROLLER), os.path.join(dst, CONTROLLER))
    return dst


def edit_json(path: str, fn) -> None:
    with open(path) as f:
        data = json.load(f)
    fn(data)
    with open(path, "w") as f:
        json.dump(data, f, indent=1)


def tiny_root(dst) -> str:
    """The copy with every cell shrunk."""
    root = copy_benchmark(dst)
    for name, sizes in SIZES.items():
        edit_json(os.path.join(root, "portbench", "workloads", name + ".json"),
                  lambda d, s=sizes: d.update(s))
    edit_json(os.path.join(root, "portbench", "configs", "landing_cnn_ctrl128.json"),
              lambda d: d["ppo"].update(minibatch_size=LANDING_MINIBATCH))
    return root
