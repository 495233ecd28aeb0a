"""Helpers for the tests that hold the PyTorch port against the JAX package:
arrays cross as numpy, configs as dataclass fields, env states field by
field."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from autonomous_quadrotor_environment_tpu_torch import config as tcfg
from autonomous_quadrotor_environment_tpu_torch.core.randomization import (
    DomainDraws,
    DomainParams,
)
from autonomous_quadrotor_environment_tpu_torch.envs.hover import EnvState

# The step-math tolerance of tests/test_rollout_fused.py, which ROADMAP.md
# fixes for the port's parity tests.
RTOL, ATOL = 2e-4, 2e-5


@pytest.fixture(scope="module")
def one_torch_thread():
    """One torch thread for a module's tests: the port's small eager ops run
    fastest on one, and the test workers already share the cores. A module
    takes it with ``pytestmark = pytest.mark.usefixtures("one_torch_thread")``
    after importing it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


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


DOM_FIELDS = ("kf_degrade", "mass_factor", "ir_factor", "j_factor", "gust_last", "gust_next",
              "gust_scale")


def port_dom(jd) -> DomainParams:
    """A batched JAX DomainParams as the port's."""
    return DomainParams(**{f: t(getattr(jd, f)) for f in DOM_FIELDS})


def port_states(js) -> EnvState:
    """A batched JAX EnvState as the port's EnvState, its domain too."""
    return EnvState(
        x=t(js.x), i=t(js.i), prev_shaping=t(js.prev_shaping),
        has_shaping=t(js.has_shaping), prev_ang=t(js.prev_ang), ang=t(js.ang),
        ang_vel=t(js.ang_vel), done=t(js.done), solved=t(js.solved),
        abs_sum=t(js.abs_sum), hist=t(js.hist), last_action=t(js.last_action),
        vel_target=t(js.vel_target), dom=port_dom(js.dom),
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
    for name in DOM_FIELDS:
        np.testing.assert_allclose(
            n(getattr(ps.dom, name)), np.asarray(getattr(js.dom, name)),
            rtol=rtol, atol=atol, err_msg="dom." + name,
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
    draws, out = jax_robust_rollout_draws(jmodel, jparams, jstates, key, jenv_cfg, steps,
                                          reset_pool)
    return n(draws["noise"]), n(draws["fresh_x0"]), out


@functools.lru_cache(maxsize=None)
def _domain_draw_fn(severity_sample):
    import jax
    import jax.numpy as jnp

    def one(key):
        k1, k2, k3, k4, k5 = jax.random.split(key, 5)
        if severity_sample:
            k5, k_sev = jax.random.split(k5)
            sev = jax.random.uniform(k_sev, (), jnp.float32)
        else:
            sev = jnp.ones((), jnp.float32)
        return (jax.random.uniform(k1, (4,), jnp.float32), jax.random.normal(k2, (), jnp.float32),
                jax.random.uniform(k3, (4,), jnp.float32), jax.random.normal(k4, (3,), jnp.float32),
                jax.random.normal(k5, (3,), jnp.float32), sev)

    return jax.jit(jax.vmap(one))


def jax_domain_draws(keys, severity_sample=False) -> DomainDraws:
    """The draws the JAX package's `sample_domain` takes from each key
    (..., 2), walking its splits, as a port `DomainDraws` of CPU tensors
    with the keys' leading axes."""
    keys = np.asarray(keys)
    lead = keys.shape[:-1]
    out = _domain_draw_fn(bool(severity_sample))(keys.reshape(-1, keys.shape[-1]))
    return DomainDraws(*(t(np.asarray(x).reshape(lead + np.asarray(x).shape[1:])) for x in out))


@functools.lru_cache(maxsize=None)
def _gust_fn():
    import jax
    import jax.numpy as jnp

    def one(key):
        key, k_wind = jax.random.split(key)
        return key, jax.random.normal(k_wind, (3,), jnp.float32)

    return jax.jit(jax.vmap(one))


def jax_step_gusts(keys, steps):
    """The gust draws of ``steps`` `hover.step` calls from each env's state
    key (B, 2), which each step splits ``key, k_wind`` (JAX hover.py:150):
    (steps, B, 3) numpy, and the keys after them."""
    out = []
    for _ in range(steps):
        keys, g = _gust_fn()(keys)
        out.append(np.asarray(g))
    return np.stack(out) if out else np.zeros((0,) + np.asarray(keys).shape[:1] + (3,),
                                              np.float32), keys


@functools.lru_cache(maxsize=None)
def _reset_split_fn():
    import jax

    from autonomous_quadrotor_environment_tpu.envs import hover as jhover

    def one(key):
        k_dom, k_init, k_state = jax.random.split(key, 3)
        return k_dom, jhover.random_initial_state(k_init), k_state

    return jax.jit(jax.vmap(one))


def jax_reset_draws(keys, jenv_cfg):
    """What the JAX package's `hover.reset` draws from each key (N, 2) of a
    hover task (JAX hover.py:245-281): the initial states (N, 13), the
    domains' draws (`DomainDraws`), the warmup steps' gust draws (warmup,
    N, 3), and each episode's key after its warmup (its `state.key`)."""
    assert not jenv_cfg.has_vel_target
    k_dom, x0, k_state = _reset_split_fn()(np.asarray(keys))
    x0 = np.asarray(x0)
    dom = jax_domain_draws(k_dom, jenv_cfg.randomization.severity_sample)
    gust, k_after = jax_step_gusts(k_state, jenv_cfg.warmup)
    return x0, dom, gust, np.asarray(k_after)


_ROLLOUT_FNS: dict = {}


def _jax_rollout_fn(jmodel, jenv_cfg, steps, reset_pool):
    """The JAX package's `rollout_batch` jitted once per model, config and
    shape (a test's calls then share one compile)."""
    import jax

    from autonomous_quadrotor_environment_tpu.agents.ppo import rollout_batch

    key = (id(jmodel), jenv_cfg, steps, reset_pool)
    if key not in _ROLLOUT_FNS:
        _ROLLOUT_FNS[key] = (jmodel, jax.jit(lambda p, s, k: rollout_batch(
            jmodel, p, s, k, jenv_cfg, steps, reset_pool=reset_pool)))
    return _ROLLOUT_FNS[key][1]


def jax_robust_rollout_draws(jmodel, jparams, jstates, key, jenv_cfg, steps, reset_pool):
    """Every draw of the JAX package's `rollout_batch` from ``key``, as the
    port's `rollout_batch` takes them: a dict of CPU tensors ``noise`` (T,
    B, 4); the fresh episodes' ``fresh_x0`` ((P | T, B, 13)), and under
    randomization their ``fresh_dom`` (`DomainDraws` over the P x B or T x
    B fresh episodes, pool or step major) and ``fresh_gust`` (warmup,
    P | T, B, 3) or (warmup, P x B, 3); and each step's ``gust_eps`` (T,
    B, 3). Each env's key chain is followed through JAX's own done flags:
    a step splits ``key, k_wind``, then the auto-reset splits ``key,
    k_reset``, a done env carrying on with its fresh episode's key (the
    post-warmup key of ``reset(k_reset)``, or with a pool the second half of
    that split). Also returns JAX's ``(new_states, rollout, bootstrap)``."""
    import jax

    out = _jax_rollout_fn(jmodel, jenv_cfg, steps, reset_pool)(jparams, jstates, key)
    b = np.asarray(jstates.x).shape[0]
    dones = np.asarray(out[1].dones)
    split2 = _split_fn()
    keys = np.asarray(jstates.key)
    gusts = []
    if reset_pool > 0:
        k_pool, k_steps = jax.random.split(key)
        pool_keys = np.asarray(jax.random.split(k_pool, reset_pool * b))
        x0, dom, fresh_gust, _ = jax_reset_draws(pool_keys, jenv_cfg)
        for step_i in range(steps):
            (g,), keys = jax_step_gusts(keys, 1)
            gusts.append(g)
            pair = np.asarray(split2(keys))
            keys = np.where(dones[step_i][:, None], pair[:, 1], pair[:, 0])
        fresh = [x0.reshape(reset_pool, b, 13), dom, fresh_gust]
        lead = (reset_pool, b)
    else:
        k_steps = key
        fresh = []
        for step_i in range(steps):
            (g,), keys = jax_step_gusts(keys, 1)
            gusts.append(g)
            pair = np.asarray(split2(keys))
            k_env, k_reset = pair[:, 0], pair[:, 1]
            fresh.append(jax_reset_draws(k_reset, jenv_cfg))
            keys = np.where(dones[step_i][:, None], fresh[-1][3], k_env)
        x0 = np.stack([f[0] for f in fresh])
        dom = DomainDraws(*(torch.stack([getattr(f[1], name) for f in fresh]) for name in (
            "kf", "mass", "ir", "j", "gust", "severity")))
        fresh = [x0, dom, np.stack([f[2] for f in fresh], axis=1)]
        lead = (steps, b)
    noise = np.stack([np.asarray(jax.random.normal(k, (b, 4)))
                      for k in jax.random.split(k_steps, steps)])
    x0, dom, fresh_gust = fresh
    draws = {"noise": t(noise), "fresh_x0": t(x0.reshape(lead + (13,)))}
    if jenv_cfg.randomization.enabled:
        draws.update(fresh_dom=dom, fresh_gust=t(fresh_gust), gust_eps=t(np.stack(gusts)))
    return draws, out


@functools.lru_cache(maxsize=None)
def _sensor_draw_fn(primary):
    import jax
    import jax.numpy as jnp

    normal = lambda k: jax.random.normal(k, (3,), jnp.float32)
    uniform = lambda k: jax.random.uniform(k, (3,), jnp.float32)
    zero = jnp.zeros(3, jnp.float32)

    def triad(k):
        if primary:
            k_acc, k_mag = jax.random.split(k)
            return zero, normal(k_acc), zero, normal(k_mag)
        k1, k2, k3, k4 = jax.random.split(k, 4)
        return uniform(k1), normal(k2), uniform(k3), normal(k4)

    def one(key):
        k1, k2, k3, k4, k5 = jax.random.split(key, 5)
        k_acc, k_triad = jax.random.split(k1)
        ug1, ng1, um1, nm1 = triad(k_triad)
        kp, kv = jax.random.split(k4)
        ug2, ng2, um2, nm2 = triad(k5)
        normals = jnp.stack([normal(k_acc), ng1, nm1, normal(k2), normal(k3),
                             normal(kp), normal(kv), ng2, nm2])
        return normals, jnp.stack([ug1, um1, ug2, um2])

    return jax.jit(jax.vmap(one))


def jax_sensor_draws(keys, primary=False):
    """The draws the JAX package's `sensor_fused` takes from each env's key
    (keys (..., 2)), walking the same splits, in the port's `SensorNoise`
    slots: normal (..., 9, 3) and uniform (..., 4, 3), numpy. The opt
    triad draws U, N, U, N from a 4-way split; the primary one its
    accelerometer and magnet normals from a 2-way split (no uniforms)."""
    keys = np.asarray(keys)
    normals, uniforms = _sensor_draw_fn(primary)(keys.reshape(-1, keys.shape[-1]))
    lead = keys.shape[:-1]
    return (np.asarray(normals).reshape(lead + (9, 3)),
            np.asarray(uniforms).reshape(lead + (4, 3)))


@functools.lru_cache(maxsize=None)
def _split_fn():
    import jax

    return jax.jit(jax.vmap(jax.random.split))


def jax_landing_frame_keys(state_keys, frames):
    """The per-frame sensor keys of the JAX package's landing env from each
    env's state key (B, 2): each frame splits ``key, k_sens`` (JAX
    landing/env.py:93). Returns (frames, B, 2) sensor keys and the keys
    left after them."""
    split = _split_fn()
    keys, out = state_keys, []
    for _ in range(frames):
        pair = split(keys)
        keys, k_sens = pair[:, 0], pair[:, 1]
        out.append(np.asarray(k_sens))
    return np.stack(out), keys


def jax_landing_reset_draws(keys, primary=False):
    """The draws of the JAX package's `landing_reset` from each episode's
    key (B, 2), in the port's form: a `ResetDraws` of CPU tensors and each
    episode's state key (B, 2) that its frames then split."""
    import jax
    import jax.numpy as jnp

    from autonomous_quadrotor_environment_tpu_torch.landing.env import ResetDraws

    def one(key):
        k_marker, k_z, k_xy, _k_env, k_sens, k_state = jax.random.split(key, 6)
        drift = jnp.stack([jax.random.uniform(k, (), jnp.float32)
                           for k in jax.random.split(k_sens, 3)])
        return (jax.random.normal(k_marker, (2,), jnp.float32),
                jax.random.uniform(k_z, (), jnp.float32),
                jax.random.uniform(k_xy, (2,), jnp.float32), drift, k_state)

    marker, z_u, xy_u, drift_u, k_state = jax.jit(jax.vmap(one))(jnp.asarray(keys))
    return ResetDraws(t(marker), t(z_u), t(xy_u), t(drift_u)), np.asarray(k_state)


def jax_landing_noise(state_keys, frames, primary=False):
    """The sensor noise of ``frames`` landing frames from each env's state
    key, as a port `SensorNoise` of CPU tensors with leading axes (frames,
    B), and the keys left after them."""
    from autonomous_quadrotor_environment_tpu_torch.envs.sensors import SensorNoise

    frame_keys, keys = jax_landing_frame_keys(state_keys, frames)
    normal, uniform = jax_sensor_draws(frame_keys, primary)
    return SensorNoise(t(normal), t(uniform)), keys


def jax_landing_rollout_draws(state_keys, key, steps, reset_pool, dones, frames=10):
    """The randomness of the JAX package's `landing_rollout` from ``key``
    and the envs' state keys (B, 2), in the port's `RolloutDraws` form (CPU
    tensors), walking JAX's key chains (landing/ppo.py:132-177): the reset
    pool's keys split from ``key`` ((P, B) episodes, flattened slot-major)
    and their warm-up frames; each decision's action noise, one (B, 3)
    normal from that decision's key; each env's per-frame sensor keys; and
    after each decision every env's key split in two, the first kept and
    the second given to a pool episode where JAX's own ``dones`` (T, B)
    say it ended. With ``reset_pool=0`` the second key resets the episode
    instead (`landing_step_autoreset`), whose warm-up frames then run on.
    Also returns the envs' keys after the rollout."""
    import jax
    import jax.numpy as jnp

    from autonomous_quadrotor_environment_tpu_torch.landing.ppo import RolloutDraws
    from autonomous_quadrotor_environment_tpu_torch.landing.env import ResetDraws
    from autonomous_quadrotor_environment_tpu_torch.envs.sensors import SensorNoise

    stack = lambda items, cls: cls(*(torch.stack(x) for x in zip(*items)))
    state_keys = np.asarray(state_keys)
    b = state_keys.shape[0]
    dones = np.asarray(dones)
    pool = pool_noise = reset = reset_noise = None
    if reset_pool > 0:
        k_pool, key = jax.random.split(key)
        pool_keys = np.asarray(jax.random.split(k_pool, (reset_pool, b))).reshape(-1, 2)
        pool, pool_state = jax_landing_reset_draws(pool_keys)
        pool_noise, _ = jax_landing_noise(pool_state, frames)
    keys = jax.random.split(key, steps)
    eps = t(np.stack([np.asarray(jax.random.normal(k, (b, 3), jnp.float32)) for k in keys]))
    noise, resets, warm = [], [], []
    for step in range(steps):
        nz, state_keys = jax_landing_noise(state_keys, frames)
        noise.append(nz)
        pair = np.asarray(_split_fn()(state_keys))
        keep, other = pair[:, 0], pair[:, 1]
        if reset_pool == 0:
            draws, fresh = jax_landing_reset_draws(other)
            wn, other = jax_landing_noise(fresh, frames)
            resets.append(draws)
            warm.append(wn)
        state_keys = np.where(dones[step][:, None], other, keep)
    if reset_pool == 0:
        reset, reset_noise = stack(resets, ResetDraws), stack(warm, SensorNoise)
    return RolloutDraws(pool, pool_noise, eps, stack(noise, SensorNoise), reset,
                        reset_noise), state_keys


def jax_landing_update_draws(key, plan, k_epochs):
    """The permutations the JAX package's landing update draws from its key
    (landing/ppo.py:317-352) for a port `UpdatePlan`, as a port
    `UpdateDraws` of CPU tensors."""
    import jax

    from autonomous_quadrotor_environment_tpu_torch.landing.ppo import UpdateDraws

    update_rows = None
    if plan.reshuffle:
        key, k_shuf = jax.random.split(key)
        update_rows = t(jax.random.permutation(k_shuf, plan.n))
    perms, epoch_rows = [], []
    per = plan.mb // plan.block
    for epoch_key in jax.random.split(key, k_epochs):
        if plan.reshuffle_epoch:
            k_perm, epoch_key = jax.random.split(epoch_key)
            epoch_rows.append(t(jax.random.permutation(k_perm, plan.n)))
        perm = np.asarray(jax.random.permutation(epoch_key, plan.n // plan.block))
        perms.append(t(perm[: plan.n_mb * per].reshape(plan.n_mb, per)))
    return UpdateDraws(None if plan.full_batch else torch.stack(perms), update_rows,
                       torch.stack(epoch_rows) if epoch_rows else None)


def jax_landing_init(seed, jcfgs, jppo_cfg, num_envs, conv_s2d, conv_dtype=None):
    """The JAX package's `landing_ppo_init` with the shipped controller, its
    model, optimizer and state, and the same envs in the port: the port's
    `LandingState` and observation from JAX's reset draws and warm-up noise
    (the port's own reset arithmetic, held to JAX's by
    tests/test_torch_landing_step.py)."""
    import jax
    import jax.numpy as jnp

    from autonomous_quadrotor_environment_tpu.fixtures import load_solved_controller as jload
    from autonomous_quadrotor_environment_tpu.landing import ppo as jppo
    from autonomous_quadrotor_environment_tpu_torch.fixtures import load_solved_controller
    from autonomous_quadrotor_environment_tpu_torch.landing import env as tenv

    cm, cp = jload()
    key = jax.random.PRNGKey(seed)
    jmodel, tx, jstate = jppo.landing_ppo_init(
        key, jcfgs, jppo_cfg, num_envs, cm, cp, conv_s2d=conv_s2d,
        conv_dtype=jnp.float32 if conv_dtype is None else conv_dtype)
    _k_model, k_envs, _k_state = jax.random.split(key, 3)
    draws, state_keys = jax_landing_reset_draws(jax.random.split(k_envs, num_envs))
    noise, state_keys = jax_landing_noise(state_keys, jcfgs.landing.task_interval)
    np.testing.assert_array_equal(np.asarray(jstate.env_states.key), state_keys)
    ctrl = load_solved_controller(device="cpu")
    tcfgs = tenv.LandingConfigs(*(type(tc)(**dataclasses.asdict(jc)) if k != "env"
                                  else port_env_config(jc)
                                  for k, jc, tc in zip(jcfgs._fields, jcfgs,
                                                       tenv.LandingConfigs.default())))
    states, obs = tenv.landing_reset(None, tcfgs, ctrl, draws=draws, noise=noise)
    return (cm, cp, jmodel, tx, jstate), (ctrl, tcfgs, states, obs)


def jax_mission_sensor_draws(seed, episodes, steps):
    """The sensor draws of the JAX package's `missions_eval --sensors` run
    at ``seed`` (apps/missions_eval.py:188-213), in the port's
    `missions_eval.SensorDraws` form (CPU tensors): each episode's key
    ``fold_in(PRNGKey(seed), ep)`` gives `sensor_reset` its three drift
    uniforms from a 3-way split, then each step splits the carried key in
    two and `sensor_fused` draws from the second half (``jax_sensor_draws``),
    leading axes (steps, episodes)."""
    import jax
    import jax.numpy as jnp

    from autonomous_quadrotor_environment_tpu_torch.apps.missions_eval import SensorDraws
    from autonomous_quadrotor_environment_tpu_torch.envs.sensors import SensorNoise

    keys = jnp.stack([jax.random.fold_in(jax.random.PRNGKey(seed), ep)
                      for ep in range(episodes)])
    drift = jax.vmap(lambda k: jnp.stack([jax.random.uniform(s, (), jnp.float32)
                                          for s in jax.random.split(k, 3)]))(keys)

    def walk(k, _):
        k, k_s = jax.random.split(k)
        return k, k_s

    _, step_keys = jax.vmap(lambda k: jax.lax.scan(walk, k, None, length=steps))(keys)
    normal, uniform = jax_sensor_draws(np.asarray(step_keys).transpose(1, 0, 2))
    return SensorDraws(t(drift), SensorNoise(t(normal), t(uniform)))
