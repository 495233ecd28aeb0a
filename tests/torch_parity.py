"""Helpers for the tests that hold the PyTorch port against the JAX package:
arrays cross as numpy, configs as dataclass fields, env states field by
field."""

import dataclasses

import numpy as np
import torch

from autonomous_quadrotor_environment_tpu_torch import config as tcfg
from autonomous_quadrotor_environment_tpu_torch.core.randomization import zeros_domain
from autonomous_quadrotor_environment_tpu_torch.envs.hover import EnvState

# The step-math tolerance of tests/test_rollout_fused.py, which ROADMAP.md
# fixes for the port's parity tests.
RTOL, ATOL = 2e-4, 2e-5


def t(x, dtype=None) -> torch.Tensor:
    """JAX or numpy array -> CPU tensor (a copy)."""
    a = np.array(x)
    return torch.from_numpy(a if dtype is None else a.astype(dtype))


def n(x) -> np.ndarray:
    """Tensor or JAX array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def port_env_config(jcfg) -> tcfg.EnvConfig:
    """The port's EnvConfig with the same field values as a JAX one."""
    d = dataclasses.asdict(jcfg)
    return tcfg.EnvConfig(
        **{k: v for k, v in d.items() if k not in ("physics", "reward", "randomization")},
        physics=tcfg.PhysicsConfig(**d["physics"]),
        reward=tcfg.RewardConfig(**d["reward"]),
        randomization=tcfg.RandomizationConfig(**d["randomization"]),
    )


def port_states(js) -> EnvState:
    """A batched JAX EnvState (randomization off) as the port's EnvState."""
    b = np.asarray(js.x).shape[0]
    return EnvState(
        x=t(js.x), i=t(js.i), prev_shaping=t(js.prev_shaping),
        has_shaping=t(js.has_shaping), prev_ang=t(js.prev_ang), ang=t(js.ang),
        ang_vel=t(js.ang_vel), done=t(js.done), solved=t(js.solved),
        abs_sum=t(js.abs_sum), hist=t(js.hist), last_action=t(js.last_action),
        vel_target=t(js.vel_target), dom=zeros_domain(b),
    )


STATE_FIELDS = (
    "x", "i", "prev_shaping", "has_shaping", "prev_ang", "ang", "ang_vel",
    "done", "solved", "abs_sum", "hist", "last_action", "vel_target",
)


def assert_states_close(ps: EnvState, js, rtol=RTOL, atol=ATOL) -> None:
    for name in STATE_FIELDS:
        np.testing.assert_allclose(
            n(getattr(ps, name)).astype(np.float32),
            np.asarray(getattr(js, name)).astype(np.float32),
            rtol=rtol, atol=atol, err_msg=name,
        )


def assert_params_close(model, jparams, atol):
    """The port's model against a flax param tree, leaf by leaf, within
    ``atol`` (rtol 0)."""
    from autonomous_quadrotor_environment_tpu_torch.agents.networks import LEAVES, to_flax

    got = to_flax(model)["params"]
    want = jparams["params"]
    for head, name, kind in LEAVES:
        np.testing.assert_allclose(
            got[head][name][kind], np.asarray(want[head][name][kind]),
            atol=atol, rtol=0, err_msg=f"{head}/{name}/{kind}",
        )


def jax_perms(key, k_epochs, n_blocks, n_mb, per_mb=None):
    """The block permutations the JAX package's `ppo_update_t` and
    `ppo_update` draw from ``key``: (k_epochs, n_mb, per_mb), ``per_mb``
    blocks per minibatch (default n_blocks // n_mb)."""
    import jax

    per_mb = per_mb or n_blocks // n_mb
    keys = jax.random.split(key, k_epochs)
    perms = [np.asarray(jax.random.permutation(k, n_blocks)) for k in keys]
    return np.stack([p[: n_mb * per_mb].reshape(n_mb, per_mb) for p in perms])


def jax_rollout_draws(jmodel, jparams, jstates, key, jenv_cfg, steps, reset_pool):
    """The randomness of the JAX package's `rollout_batch` from ``key``, in
    the port's `rollout_batch` form: the action noise (T, B, 4) and the
    fresh episodes' initial states, (P, B, 13) from the reset pool or, with
    ``reset_pool=0``, (T, B, 13): each env's fresh reset at each step, which
    follows the env's key chain through JAX's own done flags. Also returns
    JAX's ``(new_states, rollout, bootstrap)``."""
    import jax

    from autonomous_quadrotor_environment_tpu.agents.ppo import rollout_batch
    from autonomous_quadrotor_environment_tpu.envs import hover as jhover

    out = jax.jit(lambda p, s, k: rollout_batch(jmodel, p, s, k, jenv_cfg, steps,
                                                reset_pool=reset_pool))(jparams, jstates, key)
    b = np.asarray(jstates.x).shape[0]
    init = jax.vmap(lambda k: jhover.random_initial_state(jax.random.split(k, 3)[1]))
    split2 = jax.vmap(jax.random.split)
    if reset_pool > 0:
        k_pool, k_steps = jax.random.split(key)
        fresh = init(jax.random.split(k_pool, reset_pool * b)).reshape(reset_pool, b, 13)
    else:
        k_steps = key
        dones = np.asarray(out[1].dones)
        reset = jax.jit(jax.vmap(lambda k: jhover.reset(k, jenv_cfg)))
        keys, fresh = jstates.key, []
        for step_i in range(steps):
            k_env, k_reset = jax.numpy.moveaxis(split2(split2(keys)[:, 0]), 1, 0)
            fresh.append(np.asarray(init(k_reset)))
            keys = jax.numpy.where(dones[step_i][:, None], reset(k_reset).key, k_env)
        fresh = np.stack(fresh)
    noise = np.stack([np.asarray(jax.random.normal(k, (b, 4)))
                      for k in jax.random.split(k_steps, steps)])
    return noise, np.asarray(fresh), out
