"""`hover.reset_replayed`, the training loops' fresh-episode reset, against
`hover.reset` on the CPU, where its graph runs eagerly: the same `EnvState`
to the bit, the generator left where `reset` leaves it, and `fused_inputs`
and `rollout_batch` returning what they return with `hover.reset` in its
place. Over the default env, the randomized env of ``train_control
--robust`` and a velocity-target env, at a reset pool's size and at a
rollout's T x B. The card's replays are held to the eager reset in
tests/test_torch_cuda.py."""

import dataclasses

import pytest
import torch

from autonomous_quadrotor_environment_tpu_torch.agents import ppo
from autonomous_quadrotor_environment_tpu_torch.agents.networks import ActorCritic
from autonomous_quadrotor_environment_tpu_torch.config import EnvConfig, RandomizationConfig
from autonomous_quadrotor_environment_tpu_torch.envs import hover
from autonomous_quadrotor_environment_tpu_torch.utils import graphs
from torch_parity import one_torch_thread  # noqa: F401 (the fixture below)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

B, STEPS = 8, 16
# A tight box ends episodes within the rollout, so its fresh episodes are used.
ENVS = {
    "default": EnvConfig(bb_scale=0.15),
    "robust": EnvConfig(bb_scale=0.15, randomization=RandomizationConfig(
        enabled=True, severity_sample=True)),
    "velocity": EnvConfig(bb_scale=0.15, vel_target_max=(1.0, 0.5, 0.8)),
}
# fresh episodes per env: a reset pool of 4, or one per step of the rollout
LEADS = {"pool": 4, "TxB": STEPS}


def _same(a, b) -> bool:
    la, lb = graphs.leaves(a), graphs.leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def _gen(seed: int = 7) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("lead", LEADS.values(), ids=LEADS.keys())
@pytest.mark.parametrize("env", ENVS.keys())
def test_the_replayed_reset_is_the_eager_reset(env, lead, monkeypatch):
    cfg, n = ENVS[env], lead * B
    gen_a, gen_b = _gen(), _gen()
    got = hover.reset_replayed(gen_a, cfg, n)
    want = hover.reset(gen_b, cfg, n)
    assert _same(got, want)
    if cfg.randomization.enabled:
        assert got.dom.mass_factor.std() > 0
    if cfg.has_vel_target:
        assert got.vel_target.abs().sum() > 0
    # the generator is left where `reset` leaves it: every later draw is unchanged
    assert torch.equal(gen_a.get_state(), gen_b.get_state())
    assert torch.equal(torch.rand(5, generator=gen_a), torch.rand(5, generator=gen_b))

    torch.manual_seed(0)
    model = ActorCritic(hidden=16)
    states = hover.reset(_gen(3), cfg, n=B)
    pool = lead if lead != STEPS else 0
    fused = lambda: ppo.fused_inputs(model, states, _gen(), cfg, STEPS, lead)
    roll = lambda: ppo.rollout_batch(model, states, _gen(), cfg, STEPS, pool)
    got = fused(), roll()
    # the training loops before the replay: `hover.reset` in its place
    monkeypatch.setattr(hover, "reset_replayed", hover.reset)
    want = fused(), roll()
    assert _same(got, want)
    assert int(want[1][1].dones.sum()) > 0


def test_given_draws_are_used_and_nothing_is_drawn():
    """The stacked-seed studies give every draw and no generator."""
    cfg = ENVS["robust"]
    d = hover.reset_draws(_gen(), cfg, 3 * B)
    got = hover.reset_replayed(None, cfg, det_state=d.x0, dom_draws=d.dom,
                               warmup_gust=d.warmup_gust)
    assert _same(got, hover.reset(_gen(), cfg, 3 * B))
    with pytest.raises(ValueError):
        hover.reset_replayed(None, cfg, det_state=d.x0)


def test_the_reset_graph_is_keyed_on_the_config_and_dtype(monkeypatch):
    """On the card the key of `graphs.run` (to which it adds the shapes and
    the device) names the config and dtype; the function it is given is
    `reset` of the drawn inputs."""
    seen = []

    def run(key, fn, args, params=()):
        seen.append(key)
        return fn(*args)

    monkeypatch.setattr(graphs, "run", run)
    cfg = dataclasses.replace(ENVS["velocity"], warmup=3)
    got = hover.reset_replayed(_gen(), cfg, 2 * B, dtype=torch.float64)
    assert seen == [("hover.reset", cfg, torch.float64)]
    assert got.x.dtype == torch.float64
    assert _same(got, hover.reset(_gen(), cfg, 2 * B, dtype=torch.float64))
