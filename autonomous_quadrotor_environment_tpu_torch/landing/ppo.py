"""The landing benchmark's eval.

Counterpart of `make_landing_eval_fn` and `landing_eval` in the JAX
package's `landing/ppo.py`: the 100-episode landing benchmark (reference
rl_eval_worker.py:43, :350-354) with the deterministic policy. The landing
trainer (`landing_rollout`, `landing_loss`, `landing_ppo_init`, the train
step and loop) is still to be ported (ROADMAP A13b).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..envs.sensors import SensorNoise
from .env import LandingConfigs, ResetDraws, landing_reset, landing_step


def make_landing_eval_fn(
    model, cfgs: LandingConfigs, ctrl_model, episodes: int,
    max_decisions: Optional[int] = None,
):
    """The eval as a function ``eval_fn(gen=None, *, draws=None, noise=None)``
    of a generator, or of injected reset ``draws`` and sensor ``noise``
    with leading axes ((1 + max_decisions) * task_interval, episodes): the
    warm-up interval's frames first, then each decision's.

    It runs ``total_steps // task_interval + 2`` decisions (152), as the
    JAX package's scan does, for every episode: an episode that has ended
    keeps stepping, and its rewards and solves no longer count. Returns
    0-d tensors: eval_reward, eval_solved, eval_time_s (decisions x
    task_interval x 0.01 s) and eval_finished."""
    lcfg = cfgs.landing
    max_decisions = max_decisions or (lcfg.total_steps // lcfg.task_interval + 2)
    ti = lcfg.task_interval

    @torch.no_grad()
    def eval_fn(gen: Optional[torch.Generator] = None, *, draws: Optional[ResetDraws] = None,
                noise: Optional[SensorNoise] = None) -> dict:
        frames = lambda k: None if noise is None else SensorNoise(
            noise.normal[k * ti:(k + 1) * ti], noise.uniform[k * ti:(k + 1) * ti])
        state, obs = landing_reset(gen, cfgs, ctrl_model, episodes, draws=draws, noise=frames(0))
        device = state.hist.device
        finished = torch.zeros(episodes, dtype=torch.bool, device=device)
        solved = torch.zeros_like(finished)
        reward_sum = torch.zeros(episodes, dtype=torch.float32, device=device)
        decisions = torch.zeros(episodes, dtype=torch.int32, device=device)
        for d in range(max_decisions):
            mean = model.actor(obs.image, obs.control_in)
            state, out = landing_step(state, mean, cfgs, ctrl_model, gen, noise=frames(d + 1))
            active = ~finished
            reward_sum = reward_sum + out.reward * active
            solved = solved | (out.solved & active)
            decisions = decisions + active.to(torch.int32)
            finished = finished | out.done
            obs = out.obs
        return {
            "eval_reward": reward_sum.mean(),
            "eval_solved": solved.float().mean(),
            "eval_time_s": (decisions.float() * ti * 0.01).mean(),
            "eval_finished": finished.float().mean(),
        }

    return eval_fn


def landing_eval(model, cfgs, ctrl_model, episodes, gen) -> dict:
    """`make_landing_eval_fn` at its default depth, as Python floats."""
    fn = make_landing_eval_fn(model, cfgs, ctrl_model, episodes)
    return {k: float(v) for k, v in fn(gen).items()}
