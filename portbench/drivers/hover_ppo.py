"""Driver of the hover controller's PPO training: one train step of the
program's `agents.ppo.make_train_step` closure is one unit of work, B x T
env-steps.

The traffic file gives the batch (envs, rollout steps, minibatch, shuffle
block, pools) and the branch's flags; the configuration file the model and
the PPO hyperparameters. The driver makes the weights and the envs from the
seed, hands the same to the program and to the reference, and drives the
program's set-up steps through the window's own call.
"""

from __future__ import annotations

import math

from portbench import harness


def leaf_spec(config: dict) -> list:
    """(name, shape, kind, scale) of each leaf, in the program's parameter
    order: weights normal with std gain / sqrt(fan in), biases zero."""
    m = config["model"]
    obs, h = m["obs_dim"], m["hidden"]
    spec = []
    for head, out, gains in (("actor", m["actions"], m["actor_gains"]),
                             ("critic", 1, m["critic_gains"])):
        for i, (fan_in, fan_out) in enumerate(((obs, h), (h, h), (h, out))):
            spec.append((f"{head}.{2 * i}.weight", (fan_out, fan_in), "normal",
                         gains[i] / math.sqrt(fan_in)))
            spec.append((f"{head}.{2 * i}.bias", (fan_out,), "zeros", 0.0))
    return spec


def _shape(traffic: dict) -> dict:
    out = {k: traffic[k] for k in ("num_envs", "rollout_steps", "fused_rollout", "fused_pool",
                                   "reset_pool")}
    out["tile"] = math.gcd(traffic["shuffle_block"], traffic["num_envs"])
    return out


def _ppo(config: dict, traffic: dict) -> dict:
    return {**config["ppo"], "minibatch_size": traffic["minibatch_size"]}


class Program:
    """The program's train step with its model, optimizer and envs, after
    the set-up steps; ``readings`` are theirs."""

    def __init__(self, run):
        from autonomous_quadrotor_environment_tpu_torch.agents.networks import ActorCritic
        from autonomous_quadrotor_environment_tpu_torch.agents.ppo import (
            PPOTrainState, make_optimizer, make_train_step)
        from autonomous_quadrotor_environment_tpu_torch.config import (
            EnvConfig, PPOConfig, TrainConfig)
        from autonomous_quadrotor_environment_tpu_torch.envs import hover

        c, t, dev = run.config, run.traffic, run.device
        ppo = _ppo(c, t)
        env_cfg = EnvConfig(n_steps=c["env"]["n_steps"])
        ppo_cfg = PPOConfig(
            lr=ppo["lr"], gamma=ppo["gamma"], gae_lambda=ppo["gae_lambda"],
            clip_eps=ppo["clip_eps"], entropy_coef=ppo["entropy_coef"],
            k_epochs=ppo["k_epochs"], minibatch_size=ppo["minibatch_size"],
            action_std=ppo["action_std"], learn_std=False, adam_b1=ppo["adam_b1"],
            adam_b2=ppo["adam_b2"], max_grad_norm=ppo["max_grad_norm"],
            shuffle_block=t["shuffle_block"], fused_update=t["fused_update"])
        train_cfg = TrainConfig(
            num_envs=t["num_envs"], rollout_steps=t["rollout_steps"],
            network_size=c["model"]["hidden"], reset_pool=t["reset_pool"],
            fused_rollout=t["fused_rollout"], fused_pool=t["fused_pool"])
        self.start = harness.make_leaves(leaf_spec(c), run.seed, dev)
        model = ActorCritic(hidden=c["model"]["hidden"], obs_dim=c["model"]["obs_dim"],
                            act_dim=c["model"]["actions"], action_std=ppo["action_std"]).to(dev)
        harness.load_leaves(model, self.start)
        opt = make_optimizer(model, ppo_cfg)
        envs = hover.reset(harness.generator(run, 1), env_cfg, n=t["num_envs"])
        self.state = PPOTrainState(model=model, optimizer=opt, env_states=envs,
                                   gen=harness.generator(run, 2))
        self._step = make_train_step(model, opt, env_cfg, ppo_cfg, train_cfg)
        self.work_per_step = float(t["num_envs"] * t["rollout_steps"])
        with first_rows(t["fused_update"]) as rows:
            self.readings = harness.setup_steps(self, model, opt, t["setup_steps"])
        self.readings["first_rows"] = rows[0] if rows else None

    def step(self) -> dict:
        self.state, metrics = self._step(self.state)
        return metrics

    def env_x(self):
        """The envs' physics states (B, 13) the last step handed on."""
        return self.state.env_states.x

    def free(self) -> None:
        self.state = self._step = None


def _rows_t(model, obs_t, aux_t, blocks, *, tile, **kw) -> tuple:
    """The rows of kernel B2's minibatch, from its (T, F, B) inputs and
    block ids (block k: step k // (B / tile), envs (k % (B / tile)) * tile
    on), as the reference's rows, on the host."""
    import torch

    per_t = obs_t.shape[2] // tile
    offs = torch.arange(tile, device=blocks.device)
    obs, aux = [], []
    for blk in blocks.long().split(max(65536 // tile, 1)):  # a few MB at a time on the device
        t = (blk // per_t)[:, None].expand(-1, tile).reshape(-1)
        env = ((blk % per_t) * tile)[:, None].add(offs).reshape(-1)
        obs.append(obs_t[t, :, env].detach().cpu())
        aux.append(aux_t[t, :, env].detach().cpu())
    obs, aux = torch.cat(obs), torch.cat(aux)
    return obs, aux[:, 0:4], aux[:, 4], aux[:, 5], aux[:, 6]


def _rows(model, obs, actions, old_lp, returns, advs, cfg) -> tuple:
    """The rows of `ppo_loss`'s minibatch as the reference's rows, on the
    host."""
    lp = old_lp.sum(-1) if old_lp.dim() > 1 else old_lp
    return tuple(x.detach().cpu() for x in (obs, actions, lp, returns, advs))


def first_rows(fused_update: bool):
    """While open, the first minibatch's rows are kept: those kernel B2 or
    `ppo_loss` takes first, whichever the branch calls."""
    from autonomous_quadrotor_environment_tpu_torch.agents import ppo

    if fused_update:
        return harness.first_call(ppo, "fused_ppo_grad_t", _rows_t)
    return harness.first_call(ppo, "ppo_loss", _rows)


def program(run) -> Program:
    return Program(run)


def gaps(run, readings: dict, ref: dict) -> dict:
    """`compare.gaps`, and ``update_gap``: the first minibatch gradient
    against the reference's on the same rows, from the same leaves."""
    from portbench import compare
    from portbench.reference import hover_ppo

    start = harness.make_leaves(leaf_spec(run.config), run.seed, run.device)
    ppo = _ppo(run.config, run.traffic)

    def first_grad(rows):
        return hover_ppo.first_grad(start, tuple(x.to(run.device) for x in rows), ppo)

    return {**compare.gaps(readings, ref), "update_gap": compare.update_gap(readings, first_grad)}


def reference(run, control: bool = False) -> dict:
    from portbench.reference import hover_ppo
    from portbench.reference.plain.config import EnvConfig
    from portbench.reference.plain.envs import hover

    c, t = run.config, run.traffic
    env_cfg = EnvConfig(n_steps=c["env"]["n_steps"])
    start = harness.make_leaves(leaf_spec(c), run.seed, run.device)
    envs = hover.reset(harness.generator(run, 1), env_cfg, n=t["num_envs"])
    return hover_ppo.train(start, envs, harness.generator(run, 2), env_cfg, _shape(t),
                           _ppo(c, t), t["setup_steps"], control)


def half_batch():
    """A fault planted in the program: every minibatch gradient taken over
    its first half of rows only, the mean over those."""
    from autonomous_quadrotor_environment_tpu_torch.agents import ppo

    grad_t, loss = ppo.fused_ppo_grad_t, ppo.ppo_loss

    def half_grad_t(model, obs_t, aux_t, blocks, **kw):
        return grad_t(model, obs_t, aux_t, blocks[: blocks.shape[0] // 2].contiguous(), **kw)

    def half_loss(model, obs, actions, old_lp, returns, advs, cfg):
        h = obs.shape[0] // 2
        return loss(model, obs[:h], actions[:h], old_lp[:h], returns[:h], advs[:h], cfg)

    return harness.patched(ppo, fused_ppo_grad_t=half_grad_t, ppo_loss=half_loss)


def bf16_update():
    """The program with kernel B2's products in bf16, its own
    ``compute_dtype="bf16"`` path: a lower precision in the update alone."""
    from autonomous_quadrotor_environment_tpu_torch.agents import ppo

    grad_t = ppo.fused_ppo_grad_t

    def bf16(*args, **kw):
        return grad_t(*args, **{**kw, "compute_dtype": "bf16"})

    return harness.patched(ppo, fused_ppo_grad_t=bf16)
