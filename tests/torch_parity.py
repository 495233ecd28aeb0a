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


def jax_perms(key, k_epochs, n_blocks, n_mb):
    """The block permutations the JAX package's `ppo_update_t` draws from
    ``key``: (k_epochs, n_mb, n_blocks // n_mb)."""
    import jax

    keys = jax.random.split(key, k_epochs)
    perms = [np.asarray(jax.random.permutation(k, n_blocks)) for k in keys]
    return np.stack([p[: n_mb * (n_blocks // n_mb)].reshape(n_mb, -1) for p in perms])
