"""The port's stacked multi-seed training (`agents.multiseed`,
`parallel.multiseed`, `apps.stacked` and the study apps) on the CPU: the
stacked study is the serial experiment run side by side, so

- the stacked init is `ppo_init` per seed, bit for bit;
- a stacked step tracks the serial step per seed (parameters rtol 1e-4,
  atol 1e-6: tests/test_multiseed.py:56-70), a second one from each seed's
  `seed_slice` too, and the JAX package's `make_multiseed_train_step` with
  its draws injected (the port-against-JAX step tolerance, atol lr * 0.05
  and metrics rtol 5e-4, tests/test_torch_train.py);
- a stacked learning-rate grid tracks the serial runs at those rates;
- the fused configs, mismatched learning rates and uneven seed splits are
  refused, and the seed-parallel loop calls no collective;
- `seed_study --stacked` writes the CSV that `train_control` writes for the
  same seed; the save-at-solve snapshot is the parameters at the first
  latching eval; the three study apps run end to end, serial and stacked,
  and resume."""

import csv
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from autonomous_quadrotor_environment_tpu import config as jcfg
from autonomous_quadrotor_environment_tpu.agents import multiseed as jms
from autonomous_quadrotor_environment_tpu_torch import config as tcfg
from autonomous_quadrotor_environment_tpu_torch.agents import multiseed as ms
from autonomous_quadrotor_environment_tpu_torch.agents import ppo as tppo
from autonomous_quadrotor_environment_tpu_torch.agents.networks import ActorCritic, to_flax
from autonomous_quadrotor_environment_tpu_torch.apps import (
    lr_sweep,
    seed_study,
    size_sweep,
    stacked,
    train_control,
)
from autonomous_quadrotor_environment_tpu_torch.envs import hover
from autonomous_quadrotor_environment_tpu_torch.parallel import multiseed as pms
from autonomous_quadrotor_environment_tpu_torch.parallel.dp import DPMesh
from autonomous_quadrotor_environment_tpu_torch.utils import load_params
from torch_parity import one_torch_thread  # noqa: F401  (the module's fixture)
from torch_parity import jax_perms, jax_rollout_draws, port_env_config, port_states, t

pytestmark = pytest.mark.usefixtures("one_torch_thread")
ENV = tcfg.EnvConfig(n_steps=50)
PPO = tcfg.PPOConfig(k_epochs=2, minibatch_size=0)
TRAIN = tcfg.TrainConfig(num_envs=8, rollout_steps=8, network_size=16)
SEEDS = [0, 3]
MICRO = ["--updates", "4", "--eval-every", "2", "--num-envs", "8", "--rollout-steps", "8",
         "--device", "cpu"]


def _params_close(a, b, rtol=1e-4, atol=1e-6):
    for x, y in zip(a.parameters(), b.parameters()):
        np.testing.assert_allclose(x.detach().numpy(), y.detach().numpy(), rtol=rtol, atol=atol)


def test_stacked_init_equals_ppo_init_per_seed():
    model, _, state = ms.multiseed_init(SEEDS, ENV, PPO, TRAIN, device="cpu")
    for i, seed in enumerate(SEEDS):
        m, _, serial = tppo.ppo_init(seed, ENV, PPO, TRAIN, device="cpu")
        mine = ms.seed_slice(state, i)
        assert all(torch.equal(a, b) for a, b in zip(mine.model.parameters(), m.parameters()))
        assert all(torch.equal(getattr(mine.env_states, f.name), getattr(serial.env_states, f.name))
                   for f in dataclasses.fields(serial.env_states) if f.name != "dom")
        assert torch.equal(state.gens[i].get_state(), serial.gen.get_state())


CONFIGS = {
    "full_batch": (ENV, PPO, TRAIN),
    "minibatches_resets_clip": (
        tcfg.EnvConfig(n_steps=50, bb_scale=0.15),
        tcfg.PPOConfig(k_epochs=2, minibatch_size=32, shuffle_block=8, max_grad_norm=0.5),
        TRAIN),
    "velocity_pool_robust": (
        dataclasses.replace(tcfg.EnvConfig(n_steps=50, vel_target_max=(1.0, 1.0, 1.0)),
                            randomization=tcfg.RandomizationConfig(enabled=True)),
        tcfg.PPOConfig(k_epochs=2, minibatch_size=16, shuffle_block=1),
        dataclasses.replace(TRAIN, reset_pool=2)),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_stacked_steps_track_the_serial_steps(name):
    """Two stacked steps of seeds 0 and 3 against two serial steps of each
    seed; the second serial step runs from the `seed_slice` of the stacked
    state after the first (its model, Adam moments and count, envs and
    generator), against the second stacked step."""
    env_cfg, pcfg, tc = CONFIGS[name]
    model, opt, state = ms.multiseed_init(SEEDS, env_cfg, pcfg, tc, device="cpu")
    step = ms.make_multiseed_train_step(model, opt, env_cfg, pcfg, tc)
    state, met = step(state)
    slices = [ms.seed_slice(state, i) for i in range(len(SEEDS))]
    gen_states = [g.get_state() for g in state.gens]
    for i, seed in enumerate(SEEDS):
        m, o, serial = tppo.ppo_init(seed, env_cfg, pcfg, tc, device="cpu")
        _, mm = tppo.make_train_step(m, o, env_cfg, pcfg, tc)(serial)
        _params_close(ms.seed_slice(model, i), m)
        for k, v in mm.items():
            np.testing.assert_allclose(float(met[k][i]), float(v), rtol=1e-4, atol=1e-6,
                                       err_msg=k)
    state, met = step(state)
    for i, sl in enumerate(slices):
        sl.gen.set_state(gen_states[i])
        _, mm = tppo.make_train_step(sl.model, sl.optimizer, env_cfg, pcfg, tc)(sl)
        _params_close(ms.seed_slice(model, i), sl.model)
        np.testing.assert_allclose(float(met["loss"][i]), float(mm["loss"]), rtol=1e-4,
                                   atol=1e-6)
    assert state.update_i == 2


def test_stacked_step_tracks_jax_multiseed_step():
    """`multiseed_step_from_draws` from the JAX package's stacked init, each
    seed's draws walked from its key as the JAX step splits it (rollout
    chains with resets in a tight box, block permutations), against JAX's
    `make_multiseed_train_step`."""
    jenv = jcfg.EnvConfig(n_steps=50, bb_scale=0.15)
    ppo_kw = dict(k_epochs=2, minibatch_size=32, shuffle_block=8)
    jppo, jtrain = jcfg.PPOConfig(**ppo_kw), jcfg.TrainConfig(num_envs=8, rollout_steps=8,
                                                               network_size=16)
    jmodel, tx, jstate = jms.multiseed_init(SEEDS, jenv, jppo, jtrain)
    jnew, mj = jax.jit(jms.make_multiseed_train_step(jmodel, tx, jenv, jppo, jtrain))(jstate)
    pcfg, env_cfg = tcfg.PPOConfig(**ppo_kw), port_env_config(jenv)
    draws, models = [], []
    for i in range(len(SEEDS)):
        params = jax.tree.map(np.asarray, jms.seed_slice(jstate.params, i))
        states = jms.seed_slice(jstate.env_states, i)
        _, k_roll, k_upd = jax.random.split(jms.seed_slice(jstate.key, i), 3)
        noise, fresh_x0, _ = jax_rollout_draws(jmodel, params, states, k_roll, jenv, 8, 0)
        perms = torch.from_numpy(jax_perms(k_upd, 2, 8, 2))
        draws.append(ms.StepDraws(t(noise), hover.ResetDraws(t(fresh_x0).reshape(-1, 13),
                                                             None, None, None), None, perms))
        models.append(ActorCritic.from_flax(params))
    model = ms.StackedActorCritic(models)
    opt = ms.make_injectable_optimizer(model, pcfg)
    env_states = ms._cat([port_states(jms.seed_slice(jstate.env_states, i))
                          for i in range(len(SEEDS))])
    _, mt = ms.multiseed_step_from_draws(model, opt, env_states, draws, env_cfg, pcfg)
    for i in range(len(SEEDS)):
        got = to_flax(ms.seed_slice(model, i))["params"]
        want = jax.tree.map(np.asarray, jms.seed_slice(jnew.params, i))["params"]
        for head in got:
            for layer in got[head]:
                for kind in got[head][layer]:
                    np.testing.assert_allclose(got[head][layer][kind], want[head][layer][kind],
                                               atol=jppo.lr * 0.05, rtol=0)
        for k in mj:
            np.testing.assert_allclose(float(mt[k][i]), float(mj[k][i]), rtol=5e-4, atol=1e-6,
                                       err_msg=k)


def test_stacked_lr_grid_tracks_serial_lrs():
    """Learning rates per cell in the stacked optimizer's state: seed 0 at
    1e-3 and at 1e-5 in one program against the serial runs at those rates;
    the two cells move apart; a list of rates of another length is
    refused."""
    lrs = [1e-3, 1e-5]
    model, opt, state = ms.multiseed_init([0, 0], ENV, PPO, TRAIN, lrs=lrs, device="cpu")
    ms.make_multiseed_train_step(model, opt, ENV, PPO, TRAIN)(state)
    for i, lr in enumerate(lrs):
        cfg = dataclasses.replace(PPO, lr=lr)
        m, o, serial = tppo.ppo_init(0, ENV, cfg, TRAIN, device="cpu")
        tppo.make_train_step(m, o, ENV, cfg, TRAIN)(serial)
        _params_close(ms.seed_slice(model, i), m)
    assert not torch.equal(model.leaves[0][0], model.leaves[0][1])
    with pytest.raises(ValueError, match="lrs for"):
        ms.multiseed_init([0, 1, 2], ENV, PPO, TRAIN, lrs=[1e-3], device="cpu")


def test_fused_configs_and_uneven_splits_are_refused():
    model, opt, _ = ms.multiseed_init([0], ENV, PPO, TRAIN, device="cpu")
    for p, tc in [(dataclasses.replace(PPO, fused_update=True), TRAIN),
                  (PPO, dataclasses.replace(TRAIN, fused_rollout=True))]:
        with pytest.raises(ValueError, match="multiseed"):
            ms.make_multiseed_train_step(model, opt, ENV, p, tc)
    mesh = DPMesh(rank=0, size=2, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="shard evenly"):
        pms.multiseed_init_sharded([0, 1, 2], ENV, PPO, TRAIN, mesh)


def test_seed_parallel_loop_calls_no_collective(monkeypatch):
    """Rank 1 of 2 trains seeds 2 and 3 of [0, 1, 2, 3] with every
    collective patched to raise, bit for bit as the stacked loop of those
    seeds alone."""
    mesh = DPMesh(rank=1, size=2, device=torch.device("cpu"))
    m0, o0, s0 = ms.multiseed_init([2, 3], ENV, PPO, TRAIN, device="cpu")
    s0, want = ms.make_multiseed_train_loop(m0, o0, ENV, PPO, TRAIN, 2)(s0)

    def refuse(*args, **kwargs):
        raise AssertionError("a collective in the seed-parallel loop")

    for name in ("all_reduce", "broadcast", "all_gather", "barrier"):
        monkeypatch.setattr(dist, name, refuse)
    model, opt, state = pms.multiseed_init_sharded([0, 1, 2, 3], ENV, PPO, TRAIN, mesh)
    loop = pms.make_multiseed_parallel_train_loop(model, opt, ENV, PPO, TRAIN, mesh, 2)
    state, got = loop(state)
    assert got["loss"].shape == (2, 2) and torch.equal(got["loss"], want["loss"])
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), m0.parameters()))


def _evals(path):
    with open(path) as f:
        return [(int(r["Training Count"]), float(r["Reward avg"]), int(r["Total Episodes"]))
                for r in csv.DictReader(f)]


def test_stacked_study_csv_equals_train_control_csv(tmp_path):
    """Seed 0 through `seed_study --stacked` and through the serial
    `train_control`: the same evals (each from the stream (seed, _EVAL, i))
    and episode counts, rewards within rtol 1e-4."""
    micro = MICRO + ["--size", "16", "--eval-episodes", "4"]
    train_control.main(["--seed", "0", "--out", str(tmp_path / "serial")] + micro)
    seed_study.main(["--stacked", "--seeds", "1", "--out", str(tmp_path / "stacked")] + micro)
    serial, stacked_rows = (_evals(tmp_path / d / "log_16_0.csv") for d in ("serial", "stacked"))
    assert len(serial) == len(stacked_rows) == 2
    for (su, sr, se), (tu, tr, te) in zip(serial, stacked_rows):
        assert su == tu and se == te
        np.testing.assert_allclose(tr, sr, rtol=1e-4)


def test_stacked_save_at_solve_snapshots_the_first_latching_eval(tmp_path, monkeypatch):
    """A scripted eval latches cell 0 at the first eval and cell 1 at the
    second: cell 0's solved checkpoint is the parameters after 2 updates
    (an independent 2-update loop's, bit for bit), not its final ones; cell
    1's equals its final checkpoint."""
    calls = []

    def scripted(model, env_cfg, episodes=None):
        def fake(gens):
            calls.append(len(gens))
            second = float(len(calls) > 1)
            return {"eval_reward": torch.ones(2), "eval_solved": torch.tensor([1.0, second]),
                    "eval_length": torch.full((2,), 10.0)}
        return fake

    monkeypatch.setattr(stacked, "make_multiseed_eval_fn", scripted)
    cells = [stacked.StackedCell(seed=s, csv_path=f"{tmp_path}/log_16_{s}.csv",
                                 jsonl_path=f"{tmp_path}/train_16_{s}.jsonl",
                                 ckpt_path=f"{tmp_path}/nn_final_16_{s}.msgpack",
                                 solved_ckpt_path=f"{tmp_path}/nn_solved_16_{s}.msgpack")
             for s in SEEDS]
    stacked.run_stacked_study(cells, ENV, PPO, TRAIN, updates=4, eval_every=2, eval_episodes=4,
                              solved_threshold=0.95, device="cpu")
    model, opt, state = ms.multiseed_init(SEEDS, ENV, PPO, TRAIN, device="cpu")
    ms.make_multiseed_train_loop(model, opt, ENV, PPO, TRAIN, 2)(state)
    leaves = lambda path: [v for _, v in sorted(_flat(load_params(path)))]
    after2 = [v for _, v in sorted(_flat(to_flax(ms.seed_slice(model, 0))))]
    assert all(np.array_equal(a, b) for a, b in zip(leaves(cells[0].solved_ckpt_path), after2))
    assert not all(np.array_equal(a, b) for a, b in zip(leaves(cells[0].solved_ckpt_path),
                                                        leaves(cells[0].ckpt_path)))
    assert all(np.array_equal(a, b) for a, b in zip(leaves(cells[1].solved_ckpt_path),
                                                    leaves(cells[1].ckpt_path)))
    assert len(calls) == 2


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + k + "/")
        else:
            yield prefix + k, np.asarray(v)


APPS = {
    "seed_study": (seed_study, ["--size", "16", "--seeds", "2", "--eval-episodes", "4"],
                   ["log_16_0.csv", "log_16_1.csv"]),
    "lr_sweep": (lr_sweep, ["--size", "16", "--lrs", "1e-3,1e-5", "--seeds", "1"],
                 ["lr_0.001/log_16_0.csv", "lr_1e-05/log_16_0.csv"]),
    "size_sweep": (size_sweep, ["--sizes", "16,32", "--seeds", "1", "--eval-episodes", "4",
                                "--figure", "band.png"],
                   ["log_16_0.csv", "log_32_0.csv"]),
}


@pytest.mark.parametrize("mode", ["serial", "stacked"])
@pytest.mark.parametrize("app", list(APPS))
def test_study_apps_end_to_end(tmp_path, app, mode, capsys):
    """Each study app at micro size (4 updates, an eval every 2), serial
    (`train_control` per cell) and --stacked: each cell's CSV (2 rows, in
    lr_sweep the cell's own rate in the LR column), the summary; run again,
    every complete cell is skipped and the summary is the same."""
    module, extra, csvs = APPS[app]
    argv = MICRO + [str(tmp_path / a) if a.endswith(".png") else a for a in extra]
    argv += ["--out", str(tmp_path)] + (["--stacked"] if mode == "stacked" else [])
    summary = module.main(argv)
    for rel in csvs:
        with open(tmp_path / rel) as f:
            rows = list(csv.DictReader(f))
        assert len(rows) == 2 and all(np.isfinite(float(r["Reward avg"])) for r in rows)
        if app == "lr_sweep":
            assert float(rows[0]["LR"]) == float(rel.split("/")[0][3:])
    with open(tmp_path / "summary.json") as f:
        assert json.load(f) == json.loads(json.dumps(summary))
    capsys.readouterr()
    again = module.main(argv)
    assert "skipping" in capsys.readouterr().out
    assert json.loads(json.dumps(again)) == json.loads(json.dumps(summary))


def test_study_apps_write_their_tables_without_matplotlib(tmp_path, monkeypatch, capsys):
    """On a machine without matplotlib (the CUDA card's) the study apps
    write every file but the figure, and say so; size_sweep's table is the
    one `sweep_band_figure` returns beside its figure."""
    size_argv = MICRO + ["--sizes", "16", "--seeds", "1", "--eval-episodes", "4", "--stacked",
                         "--figure", str(tmp_path / "band.png"), "--out", str(tmp_path / "size")]
    with_figure = size_sweep.main(size_argv)
    os.remove(tmp_path / "band.png")
    for module in (seed_study, lr_sweep, size_sweep):
        monkeypatch.setattr(module, "have_matplotlib", lambda: False)
    capsys.readouterr()
    assert size_sweep.main(size_argv) == with_figure  # every cell done: the table alone
    lr_sweep.main(MICRO + APPS["lr_sweep"][1] + ["--stacked", "--out", str(tmp_path / "lr")])
    seed_study.main(MICRO + ["--size", "16", "--seeds", "1", "--eval-episodes", "4",
                             "--stacked", "--out", str(tmp_path / "seed")])
    assert capsys.readouterr().out.count("matplotlib is not installed") == 3
    for d in ("lr", "size", "seed"):
        assert os.path.exists(tmp_path / d / "summary.json")
    assert not list(tmp_path.rglob("*.png"))
