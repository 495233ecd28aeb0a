"""Driver of the visual-landing CNN's PPO training: one train step of the
program's `landing.ppo.make_landing_train_step` closure is one unit of
work, B envs x T decisions.

The traffic file gives the envs, decisions per rollout and reset pool; the
configuration file the CNN, its compute dtype, the frozen controller's file
and the PPO hyperparameters. The driver makes the CNN's weights and the
first episodes from the seed, hands the same to the program and to the
reference, and drives the program's set-up steps through the window's own
call.
"""

from __future__ import annotations

import math
import os

import torch

from portbench import harness
from portbench.counts import landing as counts

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def leaf_spec(config: dict) -> list:
    """(name, shape, kind, scale) of each leaf in the program's parameter
    order: the learned log-std, two trunks (the first conv in the
    space-to-depth layout), the heads; weights normal with std gain / sqrt(fan
    in), biases zero."""
    m = config["model"]
    trunk_gain, (a1, a_out, c1, c_out) = m["trunk_gain"], m["head_gains"]
    c, h, w = counts.IMAGE
    s2d = [(c * 16, 64, 2, 1)] + list(counts.CONVS[1:])
    spec = [("log_std", (), "fill", math.log(config["ppo"]["action_std"]))]
    for t in ("conv_ac", "conv_ct"):
        for i, (cin, cout, k, _) in enumerate(s2d):
            spec.append((f"{t}.conv{i}.weight", (cout, cin, k, k), "normal",
                         trunk_gain / math.sqrt(cin * k * k)))
            spec.append((f"{t}.conv{i}.bias", (cout,), "zeros", 0.0))
        flat = counts.CONVS[-1][1] * 7 * 7
        spec.append((f"{t}.dense.weight", (counts.TRUNK_OUT, flat), "normal",
                     trunk_gain / math.sqrt(flat)))
        spec.append((f"{t}.dense.bias", (counts.TRUNK_OUT,), "zeros", 0.0))
    heads = (("actor_fc1", counts.TRUNK_OUT + counts.SENS, counts.TRUNK_OUT, a1),
             ("actor_out", counts.TRUNK_OUT, counts.ACT, a_out),
             ("critic_fc1", counts.TRUNK_OUT + counts.SENS + counts.ACT, counts.TRUNK_OUT, c1),
             ("critic_out", counts.TRUNK_OUT, 1, c_out))
    for name, fan_in, out, gain in heads:
        spec.append((f"{name}.weight", (out, fan_in), "normal", gain / math.sqrt(fan_in)))
        spec.append((f"{name}.bias", (out,), "zeros", 0.0))
    return spec


def _shape(traffic: dict) -> dict:
    return {k: traffic[k] for k in ("num_envs", "rollout_steps", "reset_pool")}


class Program:
    """The program's landing train step with its CNN, optimizer, frozen
    controller and envs, after the set-up steps; ``readings`` are theirs."""

    def __init__(self, run):
        from autonomous_quadrotor_environment_tpu_torch.agents.networks import ActorCritic
        from autonomous_quadrotor_environment_tpu_torch.agents.ppo import make_optimizer
        from autonomous_quadrotor_environment_tpu_torch.config import PPOConfig
        from autonomous_quadrotor_environment_tpu_torch.landing.env import (
            LandingConfigs, landing_reset)
        from autonomous_quadrotor_environment_tpu_torch.landing.networks import LandingActorCritic
        from autonomous_quadrotor_environment_tpu_torch.landing.ppo import (
            LandingTrainState, make_landing_train_step)
        from autonomous_quadrotor_environment_tpu_torch.utils.checkpoint import load_params

        c, t, dev = run.config, run.traffic, run.device
        p = c["ppo"]
        ppo_cfg = PPOConfig(
            lr=p["lr"], gamma=p["gamma"], gae_lambda=p["gae_lambda"], clip_eps=p["clip_eps"],
            entropy_coef=p["entropy_coef"], k_epochs=p["k_epochs"],
            minibatch_size=p["minibatch_size"], action_std=p["action_std"], learn_std=True,
            adam_b1=p["adam_b1"], adam_b2=p["adam_b2"], shuffle_block=1)
        ctrl = ActorCritic.from_flax(load_params(os.path.join(run.root, c["controller"])))
        ctrl = ctrl.to(dev).eval()
        cfgs = LandingConfigs.default(training=True)
        self.start = harness.make_leaves(leaf_spec(c), run.seed, dev)
        model = LandingActorCritic(action_std=p["action_std"], conv_s2d=True,
                                   conv_dtype=DTYPES[c["compute_dtype"]]).to(dev)
        harness.load_leaves(model, self.start)
        opt = make_optimizer(model, ppo_cfg)
        envs, obs = landing_reset(harness.generator(run, 1), cfgs, ctrl, t["num_envs"])
        self.state = LandingTrainState(model=model, optimizer=opt, env_states=envs, obs=obs,
                                       gen=harness.generator(run, 2))
        self._step = make_landing_train_step(model, opt, cfgs, ppo_cfg, ctrl, t["rollout_steps"],
                                             t["reset_pool"])
        self.work_per_step = float(t["num_envs"] * t["rollout_steps"])
        with first_rows() as rows:
            self.readings = harness.setup_steps(self, model, opt, t["setup_steps"])
        self.readings["first_rows"] = rows[0] if rows else None

    def step(self) -> dict:
        self.state, metrics = self._step(self.state)
        return metrics

    def env_x(self):
        """The envs' physics states (B, 13) the last step handed on."""
        return self.state.env_states.env.x

    def free(self) -> None:
        self.state = self._step = None


def _rows(model, images, sens, actions, old_lp, returns, advs, cfg) -> tuple:
    return tuple(x.detach().cpu() for x in (images, sens, actions, old_lp, returns, advs))


def first_rows():
    """While open, the rows `landing_loss` takes first are kept, on the
    host."""
    from autonomous_quadrotor_environment_tpu_torch.landing import ppo

    return harness.first_call(ppo, "landing_loss", _rows)


def program(run) -> Program:
    return Program(run)


def gaps(run, readings: dict, ref: dict) -> dict:
    """`compare.gaps`, and ``update_gap``: the first minibatch gradient
    against the reference's on the same rows, from the same leaves."""
    from portbench import compare
    from portbench.reference import landing_ppo

    c = run.config
    start = harness.make_leaves(leaf_spec(c), run.seed, run.device)

    def first_grad(rows):
        return landing_ppo.first_grad(start, tuple(x.to(run.device) for x in rows), c["ppo"],
                                      DTYPES[c["compute_dtype"]])

    return {**compare.gaps(readings, ref), "update_gap": compare.update_gap(readings, first_grad)}


def reference(run, control: bool = False) -> dict:
    from portbench.reference import landing_ppo
    from portbench.reference.plain.landing import env as lenv

    c, t = run.config, run.traffic
    cfgs = lenv.LandingConfigs.default(training=True)
    ctrl = landing_ppo.Controller(os.path.join(run.root, c["controller"]), run.device)
    start = harness.make_leaves(leaf_spec(c), run.seed, run.device)
    envs, obs = lenv.landing_reset(harness.generator(run, 1), cfgs, ctrl, t["num_envs"])
    ppo = {**c["ppo"]}
    return landing_ppo.train(start, envs, obs, harness.generator(run, 2), cfgs, ctrl, _shape(t),
                             ppo, DTYPES[c["compute_dtype"]], t["setup_steps"], control)


def half_batch():
    """A fault planted in the program: every minibatch loss taken over its
    first half of rows only, the mean over those."""
    from autonomous_quadrotor_environment_tpu_torch.landing import ppo

    loss = ppo.landing_loss

    def half_loss(model, images, sens, actions, old_lp, returns, advs, cfg):
        h = images.shape[0] // 2
        return loss(model, images[:h], sens[:h], actions[:h], old_lp[:h], returns[:h], advs[:h],
                    cfg)

    return harness.patched(ppo, landing_loss=half_loss)
