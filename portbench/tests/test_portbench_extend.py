"""A later change adds a configuration, a cell and a metric as new files
and new entries only (the cell's name added to the lists of the end-to-end
metrics it reports); the harness finds them with no file under
portbench/ edited. A traffic that does not train brings its own driver
with its own comparison, and runs through run.py unchanged."""

import json
import os
import sys

from portbench import harness
from portbench.tests import tiny

EVAL_DRIVER = '''
"""A forward-only traffic: its numbers and its comparison are its own."""
import torch


class Program:
    def __init__(self, run):
        self.x = torch.arange(8.0, device=run.device)
        self.work_per_step = 8.0
        self.readings = {"answer": float((self.x * 2).sum())}

    def step(self):
        return {"answer": (self.x * 2).sum()}

    def free(self):
        self.x = None


def program(run):
    return Program(run)


def reference(run, control=False):
    return {"answer": float(sum(2.0 * i for i in range(8)))}


def gaps(run, readings, ref):
    return {"answer_gap": abs(readings["answer"] - ref["answer"])}
'''


def test_new_cell_config_and_metric_are_found_without_edits(tmp_path):
    root = tiny.copy_benchmark(tmp_path)
    here = os.path.join(root, "portbench")
    before = {}
    for dirpath, _, files in os.walk(here):
        for name in files:
            with open(os.path.join(dirpath, name), "rb") as f:
                before[os.path.join(dirpath, name)] = f.read()
    # new files
    with open(os.path.join(here, "configs", "hover_ppo_n64.json"), "w") as f:
        cfg = json.load(open(os.path.join(here, "configs", "hover_ppo_n128.json")))
        cfg["model"]["hidden"] = 64
        json.dump(cfg, f)
    with open(os.path.join(here, "workloads", "hover_fused_1024x64.json"), "w") as f:
        json.dump({**json.load(open(os.path.join(here, "workloads", "hover_fused_8192x256.json"))),
                   "num_envs": 1024, "rollout_steps": 64}, f)
    with open(os.path.join(here, "layer_metrics", "dummy_share.py"), "w") as f:
        f.write("def read(ctx):\n    return 42.0\n")
    # new entries
    bench = harness.benchmark(root)
    bench["configs"].append({"name": "hover_ppo_n64", "source": "https://example.org/n64",
                             "file": "portbench/configs/hover_ppo_n64.json", "reduced": [],
                             "why": "a narrower controller"})
    bench["workloads"].append({"name": "hover_fused_n64", "config": "hover_ppo_n64",
                               "traffic": "hover_fused_1024x64", "chips": 1, "why": "dummy"})
    for m in bench["end_to_end"]:
        if m["name"] in ("env_steps_per_s", "train_step_ms_p90"):
            m["workloads"].append("hover_fused_n64")
    bench["per_layer"].append({"name": "dummy_share", "unit": "%", "better": "higher",
                               "source": "host_clock", "layer": "device",
                               "moves": "env_steps_per_s", "workloads": ["hover_fused_n64"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)

    cell = harness.find_cell("hover_fused_n64", root)
    assert cell.config["model"]["hidden"] == 64 and cell.traffic["num_envs"] == 1024
    assert cell.driver.__name__.endswith("hover_ppo")
    assert [m["name"] for m in cell.per_layer] == ["dummy_share"]
    assert harness.metric_reader(cell.per_layer[0], root).read(None) == 42.0
    assert "env_steps_per_s" in [m["name"] for m in cell.end_to_end]
    for path, data in before.items():
        with open(path, "rb") as f:
            assert f.read() == data, path


def test_a_traffic_with_its_own_comparison_runs_without_edits(tmp_path):
    root = tiny.copy_benchmark(tmp_path)
    here = os.path.join(root, "portbench")
    with open(os.path.join(here, "drivers", "dummy_eval.py"), "w") as f:
        f.write(EVAL_DRIVER)
    with open(os.path.join(here, "workloads", "dummy_eval_8.json"), "w") as f:
        json.dump({"driver": "dummy_eval", "profile_steps": 1, "limits": {"answer_gap": 0.0}}, f)
    bench = harness.benchmark(root)
    bench["workloads"].append({"name": "dummy_eval_8", "config": "hover_ppo_n128",
                               "traffic": "dummy_eval_8", "chips": 1, "why": "dummy"})
    bench["end_to_end"].append({"name": "eval_answers_per_s", "unit": "answers/s",
                                "better": "higher", "bound": 0.05, "source": "host_clock",
                                "workloads": ["dummy_eval_8"]})
    with open(os.path.join(here, "end_to_end", "eval_answers_per_s.py"), "w") as f:
        f.write("def read(ctx):\n    return ctx.window.steps * ctx.work_per_step / ctx.window.wall_s\n")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    sys.path.insert(0, os.path.join(harness.ROOT, "portbench"))
    import run as bench_run

    args = bench_run.parse(["--workload", "dummy_eval_8", "--seed", "5", "--seconds", "0.2",
                            "--trace", "0"])
    line, lines, code = bench_run.execute(args, "cpu", root=root)
    out = json.loads(line)
    assert code == 0 and out["correct"], lines
    assert list(out["checks"]) == ["answer_gap"] and lines == ["answer_gap 0 limit 0"]
    assert set(out["metrics"]) == {"eval_answers_per_s", "setup_s"}
