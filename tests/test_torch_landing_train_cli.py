"""The port's landing-trainer CLI on the CPU, the landing checkpoint
writer against the JAX package's `save_params`, the stacked-frame
`ConvTrunk3D` against the JAX forward, and the frozen-composition notice."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autonomous_quadrotor_environment_tpu.landing import networks as jnet
from autonomous_quadrotor_environment_tpu.utils import save_params as jsave_params
from autonomous_quadrotor_environment_tpu_torch.agents.ppo import make_optimizer
from autonomous_quadrotor_environment_tpu_torch.apps import train_landing
from autonomous_quadrotor_environment_tpu_torch.config import PPOConfig
from autonomous_quadrotor_environment_tpu_torch.fixtures import (
    LANDING_POLICY,
    SOLVED_CONTROLLER,
    load_solved_controller,
)
from autonomous_quadrotor_environment_tpu_torch.landing import env as tenv
from autonomous_quadrotor_environment_tpu_torch.landing import networks as tnet
from autonomous_quadrotor_environment_tpu_torch.landing import ppo as tppo
from autonomous_quadrotor_environment_tpu_torch.utils import load_params, save_params
from torch_parity import n, one_torch_thread  # noqa: F401 (the fixture below)

KEYS = {"update", "eval_reward", "eval_solved", "eval_time_s", "eval_finished", "loss",
        "actor_loss", "critic_loss", "entropy", "reward_per_decision", "episodes",
        "solved_frac", "ts"}

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_train_landing_cli_on_the_cpu(tmp_path, monkeypatch):
    """2 updates at 2 envs x 2 decisions through `make_landing_train_loop`
    (--inner 2), one 2-episode eval: the JSONL row with the JAX package's
    keys, the rolling and best checkpoints, which read back equal to the
    model bit for bit; then --resume of that space-to-depth checkpoint into
    a plain model (0 updates) writes the same function in the plain layout;
    --dp is refused with its ROADMAP item."""
    models = []
    init = train_landing.landing_ppo_init

    def kept(*args, **kwargs):
        made = init(*args, **kwargs)
        models.append(made[0])
        return made

    monkeypatch.setattr(train_landing, "landing_ppo_init", kept)
    base = ["--controller", SOLVED_CONTROLLER, "--num-envs", "2", "--rollout-steps", "2",
            "--eval-episodes", "2", "--device", "cpu"]
    out = train_landing.main(base + ["--updates", "2", "--eval-every", "2", "--inner", "2",
                                     "--out", str(tmp_path)])
    assert sorted(os.listdir(tmp_path)) == ["PPO_landing_0.msgpack", "PPO_landing_best_0.msgpack",
                                            "train_landing_0.jsonl"]
    rows = [json.loads(line) for line in open(tmp_path / "train_landing_0.jsonl")]
    assert [r["update"] for r in rows] == [2] and set(rows[0]) == KEYS
    assert out["final_eval"]["eval_finished"] == 1.0 and out["best_eval_solved"] >= 0.0
    assert all(np.isfinite(v) for v in rows[0].values())
    want = tnet.to_flax(models[0])
    ckpt = str(tmp_path / "PPO_landing_0.msgpack")
    for path, w in jax.tree_util.tree_leaves_with_path(load_params(ckpt)):
        got = dict(jax.tree_util.tree_leaves_with_path(want))[path]
        assert got.dtype == w.dtype == np.float32 and np.array_equal(got, w)
    assert tnet.detect_s2d(ckpt)

    plain = tmp_path / "plain"
    train_landing.main(base + ["--updates", "0", "--no-conv-s2d", "--resume", ckpt,
                               "--out", str(plain)])
    back = load_params(str(plain / "PPO_landing_0.msgpack"))
    assert not tnet.detect_s2d(str(plain / "PPO_landing_0.msgpack"))
    for path, w in jax.tree_util.tree_leaves_with_path(tnet.params_from_s2d(want)):
        assert np.array_equal(dict(jax.tree_util.tree_leaves_with_path(back))[path], w)
    with pytest.raises(NotImplementedError, match="A16"):
        train_landing.main(base + ["--dp", "2", "--out", str(tmp_path / "dp")])


@pytest.mark.parametrize("s2d", [False, True])
def test_checkpoint_writer_is_byte_equal_to_jax(tmp_path, s2d):
    """The shipped landing policy's params (a flax tree the JAX package
    wrote; float16 leaves taken to float32) through
    `LandingActorCritic.from_flax`, `to_flax` and `save_params`: the same
    bytes as the JAX package's `save_params` of those params, in the plain
    and the space-to-depth layout."""
    params = jax.tree.map(lambda x: jnp.asarray(x, jnp.float32), load_params(LANDING_POLICY))
    if s2d:
        params = jnet.params_to_s2d(params)
    jsave_params(str(tmp_path / "jax.msgpack"), params)
    port = tnet.LandingActorCritic.from_flax(jax.device_get(params))
    assert port.conv_s2d == s2d
    save_params(str(tmp_path / "port.msgpack"), tnet.to_flax(port))
    assert (tmp_path / "port.msgpack").read_bytes() == (tmp_path / "jax.msgpack").read_bytes()


def test_frozen_composition_notice_and_fall_back(capsys):
    """shuffle_block == minibatch without a reshuffle prints the JAX
    package's notice at the first step only; a block that does not divide
    the batch falls back to the per-row shuffle."""
    cfg = dataclasses.replace(PPOConfig.landing_variant(), k_epochs=1, minibatch_size=2,
                              shuffle_block=2)
    assert tppo.update_plan(cfg, 4).frozen
    assert tppo.update_plan(dataclasses.replace(cfg, shuffle_block=3), 4).block == 1
    assert not tppo.update_plan(dataclasses.replace(cfg, reshuffle_per_epoch=True), 4).frozen
    cfgs = tenv.LandingConfigs.default()
    ctrl = load_solved_controller("cpu")
    model, opt, state = tppo.landing_ppo_init(0, cfgs, cfg, 2, ctrl, device="cpu")
    assert isinstance(opt, type(make_optimizer(model, cfg)))
    step = tppo.make_landing_train_step(model, opt, cfgs, cfg, ctrl, 2)
    for _ in range(2):
        state, met = step(state)
    assert capsys.readouterr().out.count("frozen minibatch composition") == 1
    assert state.update_i == 2 and all(torch.isfinite(v) for v in met.values())


def test_conv_trunk_3d_matches_jax():
    """The stacked-frame trunk from flax's init on 5 selected frames of an
    `ImageHistory`: the JAX forward within atol 1e-5; `to_flax` gives the
    flax params back bit for bit; the history's push and select match
    JAX's per env."""
    rng = np.random.default_rng(0)
    frames = rng.random((2, 7, 84, 84, 3), np.float32)
    buf_j = [jnet.ImageHistory.init(7) for _ in range(2)]
    buf_t = tnet.ImageHistory.init(2, 7)
    for k in range(7):
        buf_j = [jnet.ImageHistory.push(b, frames[e, k]) for e, b in enumerate(buf_j)]
        buf_t = tnet.ImageHistory.push(buf_t, torch.from_numpy(
            frames[:, k].transpose(0, 3, 1, 2).copy()))
    sel_j = jnp.stack([jnet.ImageHistory.select(b) for b in buf_j])        # (2, 5, H, W, 3)
    sel_t = tnet.ImageHistory.select(buf_t)                                # (2, 5, 3, H, W)
    np.testing.assert_array_equal(n(sel_t), np.asarray(sel_j).transpose(0, 1, 4, 2, 3))
    trunk = jnet.ConvTrunk3D()
    params = trunk.init(jax.random.PRNGKey(4), sel_j[:1])
    want = trunk.apply(params, sel_j)
    port = tnet.ConvTrunk3D()
    port.load_flax(jax.device_get(params)["params"])
    with torch.no_grad():
        got = port(sel_t)
    assert got.shape == (2, 768)
    np.testing.assert_allclose(n(got), np.asarray(want), atol=1e-5, rtol=0)
    back = port.to_flax()
    for path, w in jax.tree_util.tree_leaves_with_path(jax.device_get(params)["params"]):
        got_leaf = dict(jax.tree_util.tree_leaves_with_path(back))[path]
        assert got_leaf.dtype == np.float32 and np.array_equal(got_leaf, np.asarray(w))
