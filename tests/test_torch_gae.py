"""The port's GAE (`agents/gae.py`) against the JAX package's
`gae_advantages` and against the reference loop of tests/test_ppo.py, on
seeded numpy inputs. Tolerance rtol 2e-5 / atol 2e-5 (the port's log-step
scan, XLA's associative scan and the sequential loop associate the same
float32 products differently, about 1e-6 relative at these lengths)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autonomous_quadrotor_environment_tpu.agents.gae import gae_advantages as jgae
from autonomous_quadrotor_environment_tpu_torch.agents.gae import gae_advantages
from test_ppo import reference_gae
from torch_parity import n, t

TOL = dict(rtol=2e-5, atol=2e-5)


def _inputs(steps, b, seed=0, p_done=0.1):
    rng = np.random.default_rng(seed)
    rewards = rng.normal(size=(steps, b)).astype(np.float32)
    values = rng.normal(size=(steps, b)).astype(np.float32)
    dones = rng.random((steps, b)) < p_done
    boot = rng.normal(size=(b,)).astype(np.float32)
    return rewards, values, dones, boot


@pytest.mark.parametrize("steps,b", [(256, 8), (57, 3), (1, 4), (5, 1)])
@pytest.mark.parametrize("normalize", [True, False])
def test_matches_jax(steps, b, normalize):
    r, v, d, boot = _inputs(steps, b, seed=steps)
    rj, aj = jgae(jnp.asarray(r), jnp.asarray(v), jnp.asarray(d), jnp.asarray(boot),
                  0.99, 0.95, normalize=normalize)
    rt, at = gae_advantages(t(r), t(v), t(d), t(boot), 0.99, 0.95, normalize=normalize)
    np.testing.assert_allclose(n(rt), np.asarray(rj), **TOL)
    if steps * b > 1 or not normalize:
        np.testing.assert_allclose(n(at), np.asarray(aj), **TOL)


def test_matches_the_reference_loop():
    """tests/test_ppo.py::reference_gae is the literal reference loop, whose
    values carry the bootstrap as their last entry."""
    rng = np.random.default_rng(0)
    steps = 57
    rewards = rng.normal(size=steps).astype(np.float32)
    values = rng.normal(size=steps + 1).astype(np.float32)
    dones = (rng.random(steps) < 0.1).astype(np.float32)
    ref_returns, ref_adv = reference_gae(values, 1.0 - dones, rewards)
    returns, adv = gae_advantages(t(rewards), t(values[:-1]), t(dones), t(values[-1]))
    np.testing.assert_allclose(n(returns), ref_returns, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(n(adv), ref_adv, rtol=1e-4, atol=1e-4)


def test_normalization_uses_the_population_std():
    """ddof=0, as `jnp.std`: the normalized advantages have population std 1
    (a sample std, ddof=1, would give sqrt((n-1)/n) at n=6)."""
    r, v, d, boot = _inputs(3, 2, seed=5)
    _, adv = gae_advantages(t(r), t(v), t(d), t(boot))
    assert abs(float(adv.std(correction=0)) - 1.0) < 1e-5
    assert abs(float(adv.mean())) < 1e-6
    _, raw = gae_advantages(t(r), t(v), t(d), t(boot), normalize=False)
    want = (raw - raw.mean()) / (np.std(n(raw)) + 1e-10)
    np.testing.assert_allclose(n(adv), n(want), rtol=1e-6, atol=1e-6)


def test_done_cuts_the_bootstrap():
    """A terminal step takes neither the next value nor the later advantage."""
    r = torch.tensor([[1.0], [2.0]])
    v = torch.tensor([[0.5], [0.25]])
    d = torch.tensor([[True], [True]])
    returns, _ = gae_advantages(r, v, d, torch.tensor([100.0]), normalize=False)
    assert torch.allclose(returns, r)
