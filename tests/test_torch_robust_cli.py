"""The port's checkpoint writer, training logs, trainer CLI and robust
cross-eval CLI against the JAX package's, on the CPU: checkpoints read both
ways and byte-equal where flax writes the same tree; the CSV log's header
and resume; `train_control --inner 3` equal to `--inner 1`; a robust
curriculum run writing the files the JAX package's writes; `--dp` refused
with the ROADMAP item that will port it; `robust_eval
--forensic` writing the JAX package's keys; the shipped robust fixture."""

import csv
import json
import os

import jax
import numpy as np
import pytest

from autonomous_quadrotor_environment_tpu.agents.networks import ActorCritic as JActorCritic
from autonomous_quadrotor_environment_tpu.agents.ppo import make_eval_fn as jmake_eval_fn
from autonomous_quadrotor_environment_tpu.agents.ppo import (
    make_forensic_eval_fn as jmake_forensic_eval_fn,
)
from autonomous_quadrotor_environment_tpu.apps import train_control as jtrain_control
from autonomous_quadrotor_environment_tpu.apps.robust_eval import _taxonomy as jtaxonomy
from autonomous_quadrotor_environment_tpu.config import EnvConfig as JEnvConfig
from autonomous_quadrotor_environment_tpu.fixtures import load_robust_controller as jload_robust
from autonomous_quadrotor_environment_tpu.utils import load_params as jload_params
from autonomous_quadrotor_environment_tpu.utils import save_params as jsave_params
from autonomous_quadrotor_environment_tpu_torch.agents.networks import ActorCritic, to_flax
from autonomous_quadrotor_environment_tpu_torch.apps import robust_eval, train_control
from autonomous_quadrotor_environment_tpu_torch.fixtures import (
    ROBUST_CONTROLLER,
    SOLVED_CONTROLLER,
    load_robust_controller,
)
from autonomous_quadrotor_environment_tpu_torch.utils import (
    TRAIN_LOG_HEADER,
    CSVLogger,
    JSONLLogger,
    load_params,
    save_params,
)
from torch_parity import one_torch_thread  # noqa: F401  (the module's fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, np.asarray(v)


@pytest.mark.parametrize("half", [False, True])
def test_checkpoints_cross_between_the_packages(tmp_path, half):
    """The port's `save_params` writes what the JAX package's `load_params`
    reads back equal (float16-stored leaves cast up, as for the shipped
    fixtures), the port reads what the JAX package writes, and both write
    the same bytes for the same tree."""
    _, jparams = jload_robust()
    tparams = to_flax(load_robust_controller(device="cpu"))
    save_params(str(tmp_path / "port.msgpack"), tparams, half=half)
    jsave_params(str(tmp_path / "jax.msgpack"), jparams, half=half)
    assert (tmp_path / "port.msgpack").read_bytes() == (tmp_path / "jax.msgpack").read_bytes()
    back = jload_params(str(tmp_path / "port.msgpack"), jparams)
    want = dict(_leaves(tparams))
    got = dict(_leaves(jax.tree.map(np.asarray, back)))
    assert set(got) == set(want)
    for k, v in want.items():
        expect = v.astype(np.float16).astype(np.float32) if half else v
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], expect, err_msg=k)
    from_jax = dict(_leaves(load_params(str(tmp_path / "jax.msgpack"))))
    for k, v in from_jax.items():
        np.testing.assert_array_equal(v, got[k], err_msg=k)
    # A learned std's 0-d leaf too, written into a directory save_params makes.
    tree = {"params": {"log_std": np.full((), -2.3, np.float32), **tparams["params"]}}
    save_params(str(tmp_path / "new" / "std.msgpack"), tree, half=half)
    assert load_params(str(tmp_path / "new" / "std.msgpack"))["params"]["log_std"].shape == ()


def test_csv_logger_writes_the_reference_header_and_resumes(tmp_path):
    path = str(tmp_path / "logs" / "log.csv")
    log = CSVLogger(path, TRAIN_LOG_HEADER)
    assert log.rows == 0
    log.append({"LR": 5e-4, "Training Count": 5})
    log.append({"LR": 5e-4, "Training Count": 10})
    again = CSVLogger(path, TRAIN_LOG_HEADER)
    assert again.rows == 2
    again.append({"Training Count": 15})
    with open(path) as f:
        rows = list(csv.reader(f))
    assert rows[0] == TRAIN_LOG_HEADER == jtrain_control.TRAIN_LOG_HEADER
    assert [r[TRAIN_LOG_HEADER.index("Training Count")] for r in rows[1:]] == ["5", "10", "15"]
    jl = JSONLLogger(str(tmp_path / "j" / "t.jsonl"))
    jl.log(update=1, loss=0.5)
    row = json.loads((tmp_path / "j" / "t.jsonl").read_text())
    assert row["update"] == 1 and "ts" in row


SMALL = ["--seed", "3", "--size", "16", "--updates", "6", "--num-envs", "8",
         "--rollout-steps", "16", "--eval-every", "3", "--eval-episodes", "4",
         "--solved-threshold", "1.1", "--device", "cpu"]


def test_train_control_inner_matches_single_steps(tmp_path):
    """`train_control --inner 3` reproduces the --inner 1 run exactly: the
    same draws, the same update order, the same final eval and weights (the
    port's counterpart of tests/test_apps.py's test)."""
    r1 = train_control.main(SMALL + ["--out", str(tmp_path / "single")])
    r3 = train_control.main(SMALL + ["--inner", "3", "--out", str(tmp_path / "inner")])
    assert r1["total_steps"] == r3["total_steps"] == 6 * 8 * 16
    for k, v in r1["final_eval"].items():
        assert v == r3["final_eval"][k], k
    a = (tmp_path / "single" / "nn_final_16_3.msgpack").read_bytes()
    assert a == (tmp_path / "inner" / "nn_final_16_3.msgpack").read_bytes()


ROBUST = ["--robust", "--curriculum", "0,1", "--severity-sample", "--seed", "0", "--size",
          "16", "--updates", "4", "--num-envs", "8", "--rollout-steps", "16",
          "--eval-every", "2", "--eval-episodes", "4", "--k-epochs", "2"]


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_robust_curriculum_run_writes_what_jax_writes(tmp_path, monkeypatch):
    """A `--robust --severity-sample --curriculum 0,1` run of both packages'
    trainers: the same files (logs, eval-time and final checkpoints), the
    same CSV header and row count, the same JSONL keys, the same return
    keys, and checkpoints that each package reads. (The JAX app's
    persistent compilation cache is left off: it would write outside the
    checkout.)"""
    from autonomous_quadrotor_environment_tpu.utils import cache

    monkeypatch.setattr(cache, "enable_compilation_cache", lambda *a, **k: None)
    rj = jtrain_control.main(ROBUST + ["--out", str(tmp_path / "jax")])
    rt = train_control.main(ROBUST + ["--device", "cpu", "--out", str(tmp_path / "port")])
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    assert "untrained_networks/nn_16_0.msgpack" in _files(tmp_path / "port")
    assert set(rt) == set(rj) and set(rt["final_eval"]) == set(rj["final_eval"])
    assert rt["total_steps"] == rj["total_steps"]
    for side in ("jax", "port"):
        with open(tmp_path / side / "log_16_0.csv") as f:
            rows = list(csv.reader(f))
        assert rows[0] == TRAIN_LOG_HEADER and len(rows) == 3
    keys = [set(json.loads(line)) for side in ("jax", "port")
            for line in (tmp_path / side / "train_16_0.jsonl").read_text().splitlines()]
    assert keys[0] == keys[2] and keys[1] == keys[3]
    # Each package reads the other's final checkpoint into a hidden-16 model.
    jmodel = JActorCritic(hidden=16)
    template = jmodel.init(jax.random.PRNGKey(0), np.zeros((1, 75), np.float32))
    back = jload_params(str(tmp_path / "port" / "nn_final_16_0.msgpack"), template)
    ported = dict(_leaves(load_params(str(tmp_path / "port" / "nn_final_16_0.msgpack"))))
    for k, v in _leaves(jax.tree.map(np.asarray, back)):
        np.testing.assert_array_equal(v, ported[k], err_msg=k)
    assert ActorCritic.from_flax(load_params(str(tmp_path / "jax" / "nn_final_16_0.msgpack"))
                                 ).hidden == 16


@pytest.mark.parametrize("flag,item", [("--dp=2", "A16")])
def test_train_control_refuses_what_is_not_ported(flag, item, tmp_path):
    with pytest.raises(NotImplementedError, match=item):
        train_control.main(SMALL + [flag, "--out", str(tmp_path)])
    assert not os.listdir(tmp_path)


def test_robust_eval_forensic_writes_the_jax_keys(tmp_path):
    """`robust_eval --episodes 2 --device cpu --forensic`: the table's cells
    and metrics are the JAX package's eval keys, the forensic file holds the
    JAX package's layout (records with its forensic keys, and a taxonomy
    equal to the JAX package's `_taxonomy` of those records)."""
    out = str(tmp_path / "f" / "forensic.json")
    table = robust_eval.main(["--nominal", SOLVED_CONTROLLER, "--robust", ROBUST_CONTROLLER,
                              "--episodes", "2", "--device", "cpu", "--forensic", out])
    jmodel, jparams = jload_robust()
    cfg = JEnvConfig(n_steps=20)
    jeval = jmake_eval_fn(jmodel, cfg, 2)(jparams, jax.random.PRNGKey(0))
    jrec = jmake_forensic_eval_fn(jmodel, cfg, 2)(jparams, jax.random.PRNGKey(0))
    assert set(table) == {f"{p}/{e}" for p in ("nominal", "robust") for e in ("calm", "windy")}
    for row in table.values():
        assert set(row) == set(jeval) and all(np.isfinite(v) for v in row.values())
    with open(out) as f:
        forensic = json.load(f)
    assert set(forensic) == {"policy", "episodes", "seed", "windy_full", "windy_sampled"}
    assert forensic["policy"] == "robust" and forensic["episodes"] == 2
    for env_name in ("windy_full", "windy_sampled"):
        rec = forensic[env_name]["records"]
        assert set(rec) == set(jrec) and all(len(v) == 2 for v in rec.values())
        assert forensic[env_name]["taxonomy"] == json.loads(json.dumps(jtaxonomy(rec)))
    station = forensic["windy_full"]["records"]["station"]
    assert sum(station) / 2 == table["robust/windy"]["eval_station_keeping"]


def test_load_robust_controller_matches_the_jax_fixture():
    _, jparams = jload_robust()
    want = dict(_leaves(jax.tree.map(np.asarray, jparams)))
    got = dict(_leaves(to_flax(load_robust_controller(device="cpu"))))
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
