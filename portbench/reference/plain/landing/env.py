"""Hierarchical visual-landing environment, batched over envs.

Counterpart of `landing/env.py` in the JAX package (the reference's
`quad_worker`, visual_landing/rl_worker.py:69-497): one `landing_step` is
one CNN policy decision = TASK_INTERVAL_STEPS=10 physics frames, each
running the sensor fusion, the rolling featurizer fed with
sensor-state-minus-velocity-command and the FROZEN low-level MLP
controller before the physics step; then the reward on the true state and
one nadir camera frame, rendered by the B5 kernel
(`ops/render_kernel.py:render_nadir_batch`) into NCHW images (B, 3, 84, 84).

Randomness is explicit. The JAX package carries a PRNG key per env; here a
reset takes its draws (`ResetDraws`) and every interval its per-frame
sensor noise (`SensorNoise` with leading axes (frames, B)), each drawn from
a `torch.Generator` unless the caller hands them in, as parity tests do
with the JAX package's own draws.

As in the JAX package, `landing_reset` runs the reference's warm-up
decision interval (zero velocity command) whose reward only seeds the
shaping carry, so every observation already has a rendered image.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch

from ..config import CameraConfig, EnvConfig, LandingConfig, MarkerConfig, SensorConfig
from ..core.dynamics import aux_at_state
from ..core.randomization import zeros_domain
from ..device import const
from ..envs import hover
from ..envs.featurizer import feat_size, push_hist
from ..envs.sensors import (
    SensorNoise,
    SensorState,
    draw_sensor_noise,
    reads_from_env,
    sensor_fused,
    sensor_reset,
)
from ..render.camera import make_camera
from ..render.scene import render_nadir
from .reward import visual_reward


class LandingConfigs(NamedTuple):
    """Static bundle for the landing task."""

    landing: LandingConfig
    env: EnvConfig
    sensor: SensorConfig
    camera: CameraConfig
    marker: MarkerConfig

    @staticmethod
    def default(training: bool = True) -> "LandingConfigs":
        return LandingConfigs(
            landing=LandingConfig(),
            env=EnvConfig.landing_variant(training=training),
            sensor=SensorConfig(),
            camera=CameraConfig(),
            marker=MarkerConfig(),
        )


@dataclasses.dataclass
class LandingState:
    """Per-env landing state, batched along the first axis."""

    env: hover.EnvState          # inner physics env (opt variant config)
    sens: SensorState
    marker_world: torch.Tensor   # (B, 3) marker in WORLD frame (z ~ 0.001)
    hist: torch.Tensor           # (B, 75) low-level controller input window
    crtl_action: torch.Tensor    # (B, 4) last low-level action
    vel_error: torch.Tensor      # (B, 3) current velocity command
    last_shaping: torch.Tensor   # (B,)
    has_shaping: torch.Tensor    # (B,) bool
    internal_frame: torch.Tensor  # (B,) int32 physics-frame counter
    done: torch.Tensor           # (B,) bool

    def replace(self, **changes) -> "LandingState":
        return dataclasses.replace(self, **changes)


class LandingObs(NamedTuple):
    image: torch.Tensor       # (B, 3, 84, 84) in [0, 1]
    control_in: torch.Tensor  # (B, 75) the low-level controller's current input


class LandingStepOut(NamedTuple):
    obs: LandingObs
    reward: torch.Tensor  # (B,)
    done: torch.Tensor    # (B,) bool
    solved: torch.Tensor  # (B,) bool


class ResetDraws(NamedTuple):
    """The draws of `landing_reset` (JAX landing/env.py:155-162)."""

    marker: torch.Tensor   # (B, 2) standard normals: marker xy / marker_std
    z_u: torch.Tensor      # (B,) U[0, 1): start height
    xy_u: torch.Tensor     # (B, 2) U[0, 1): start xy inside the cone
    drift_u: torch.Tensor  # (B, 3) U[0, 1): sensor bias drift rates


def draw_reset(gen: torch.Generator, n: int, dtype=torch.float32) -> ResetDraws:
    kw = dict(generator=gen, dtype=dtype, device=gen.device)
    return ResetDraws(
        marker=torch.randn(n, 2, **kw), z_u=torch.rand(n, **kw),
        xy_u=torch.rand(n, 2, **kw), drift_u=torch.rand(n, 3, **kw),
    )


def draw_interval(gen: torch.Generator, cfgs: LandingConfigs, n: int,
                  dtype=torch.float32) -> SensorNoise:
    """Sensor noise for one decision interval: leading axes (frames, B)."""
    return draw_sensor_noise(gen, (cfgs.landing.task_interval, n), dtype)


def start_geometry(draws: ResetDraws, cfgs: LandingConfigs) -> tuple[torch.Tensor, torch.Tensor]:
    """Random marker N(0, marker_std) and cone-constrained start (reference
    rl_worker.py:153-162): (marker_world (B, 3), x0 (B, 13))."""
    dtype = draws.marker.dtype
    marker_xy = draws.marker * cfgs.landing.marker_std
    marker_world = torch.cat([marker_xy, torch.full_like(marker_xy[:, :1], 0.001)], dim=-1)
    quad_z = -5.0 * draws.z_u + 1.0
    spread = torch.abs(-5.0 - quad_z) / 7.0 * 4.0
    quad_xy = marker_xy + (draws.xy_u - 0.5) * spread[:, None]
    x0 = torch.zeros(marker_xy.shape[0], 13, dtype=dtype, device=marker_xy.device)
    x0[:, 0] = quad_xy[:, 0]
    x0[:, 2] = quad_xy[:, 1]
    x0[:, 4] = quad_z
    x0[:, 6] = 1.0
    return marker_world, x0


def _frames(env_s: hover.EnvState, sens_s: SensorState, hist: torch.Tensor,
            crtl_action: torch.Tensor, vel_error: torch.Tensor, noise: SensorNoise,
            cfgs: LandingConfigs, ctrl_model: Any):
    """The interval's frames on tensors: what `_inner_interval` runs and a
    CUDA graph captures."""
    env_cfg = cfgs.env
    phys = env_cfg.physics
    # The velocity command sits in the velocity slots 1, 3, 5 of the 14-dim
    # sensor state (JAX landing/env.py:101-103).
    err14 = torch.zeros(vel_error.shape[0], 14, dtype=vel_error.dtype, device=vel_error.device)
    err14[:, 1:6:2] = vel_error
    for f in range(cfgs.landing.task_interval):
        # The fusion reads the diagnostics of the pre-step state under the
        # last action (one RHS evaluation, core/dynamics.aux_at_state).
        aux = aux_at_state(env_s.x, crtl_action, phys, env_s.dom, direct_control=True)
        sens_s, fused = sensor_fused(
            sens_s, reads_from_env(env_s.x, aux),
            SensorNoise(noise.normal[f], noise.uniform[f]), cfgs.sensor, phys, env_cfg.dt,
        )
        hist = push_hist(hist, fused.states_sens - err14, crtl_action)
        crtl_action = ctrl_model.actor_mean(hist)
        env_s, _out = hover.step(env_s, crtl_action, env_cfg)  # done flag ignored
    return env_s, sens_s, hist, crtl_action


def _inner_interval(
    state: LandingState, cfgs: LandingConfigs, ctrl_model: Any, noise: SensorNoise
) -> LandingState:
    """TASK_INTERVAL_STEPS physics frames under the frozen controller
    (reference rl_worker.py:402-416), eagerly; ``noise`` holds one fused
    read's draws per frame, leading axes (frames, B)."""
    env_s, sens_s, hist, crtl_action = _frames(
        state.env, state.sens, state.hist, state.crtl_action, state.vel_error, noise, cfgs,
        ctrl_model)
    return state.replace(
        env=env_s, sens=sens_s, hist=hist, crtl_action=crtl_action,
        internal_frame=state.internal_frame + cfgs.landing.task_interval,
    )


def interval(state: LandingState, cfgs: LandingConfigs, ctrl_model: Any,
             noise: SensorNoise) -> LandingState:
    """The decision interval, eagerly."""
    return _inner_interval(state, cfgs, ctrl_model, noise)


def _observe(state: LandingState, cfgs: LandingConfigs) -> LandingObs:
    img = render_nadir(make_camera(cfgs.camera), state.env.x[:, 0:5:2],
                       state.marker_world[:, 0:2], cfgs.marker, cfgs.landing.ground_z, 1.0)
    return LandingObs(image=img, control_in=state.hist)


def _reward(state: LandingState, cfgs: LandingConfigs, control: torch.Tensor):
    x = state.env.x
    return visual_reward(
        cfgs.landing.total_steps, state.marker_world, x[:, 0:5:2], x[:, 1:6:2], control,
        state.last_shaping, state.has_shaping, state.internal_frame, state.env.ang,
        x[:, 10:13],
    )


@torch.no_grad()
def landing_reset(
    gen: Optional[torch.Generator],
    cfgs: LandingConfigs,
    ctrl_model: Any,
    n: Optional[int] = None,
    *,
    draws: Optional[ResetDraws] = None,
    noise: Optional[SensorNoise] = None,
    dtype=torch.float32,
) -> tuple[LandingState, LandingObs]:
    """Start ``n`` episodes (or one per row of ``draws``): random marker and
    cone-constrained start, then the warm-up decision interval with a zero
    velocity command. ``draws`` and the warm-up's ``noise`` come from
    ``gen`` unless given."""
    if draws is None:
        draws = draw_reset(gen, n, dtype)
    b = draws.marker.shape[0]
    if noise is None:
        noise = draw_interval(gen, cfgs, b, dtype)
    marker_world, x0 = start_geometry(draws, cfgs)
    device = x0.device
    env_s = hover.reset(None, cfgs.env, det_state=x0, dtype=dtype)
    zeros = lambda *shape: torch.zeros(b, *shape, dtype=dtype, device=device)
    aux0 = aux_at_state(env_s.x, zeros(4), cfgs.env.physics, zeros_domain(b, dtype, device),
                        direct_control=True)
    sens_s = sensor_reset(draws.drift_u, reads_from_env(env_s.x, aux0), cfgs.sensor)
    falses = torch.zeros(b, dtype=torch.bool, device=device)
    state = LandingState(
        env=env_s,
        sens=sens_s,
        marker_world=marker_world,
        hist=zeros(feat_size(5)),
        crtl_action=zeros(4),
        vel_error=zeros(3),
        last_shaping=zeros(),
        has_shaping=falses,
        internal_frame=torch.zeros(b, dtype=torch.int32, device=device),
        done=falses,
    )
    # Warm-up interval (reference ppo_calls=0 tick with vel_error = 0).
    state = interval(state, cfgs, ctrl_model, noise)
    rew = _reward(state, cfgs, zeros(3))
    state = state.replace(last_shaping=rew.shaping, has_shaping=torch.ones_like(falses))
    return state, _observe(state, cfgs)


@torch.no_grad()
def landing_step(
    state: LandingState,
    visual_action: torch.Tensor,  # (B, 3) CNN action in [-1, 1]
    cfgs: LandingConfigs,
    ctrl_model: Any,
    gen: Optional[torch.Generator] = None,
    *,
    noise: Optional[SensorNoise] = None,
) -> tuple[LandingState, LandingStepOut]:
    """One policy decision: velocity command -> 10 physics frames -> reward
    + fresh observation (reference rl_worker.py:368-424). The frames'
    sensor ``noise`` comes from ``gen`` unless given."""
    lcfg = cfgs.landing
    dtype, device = state.hist.dtype, state.hist.device
    if noise is None:
        noise = draw_interval(gen, cfgs, state.hist.shape[0], dtype)
    action = visual_action.to(dtype)
    vel_error = (action * const(tuple(lcfg.velocity_scale), dtype, device)
                 + const(tuple(lcfg.velocity_d), dtype, device))
    state = interval(state.replace(vel_error=vel_error), cfgs, ctrl_model, noise)
    rew = _reward(state, cfgs, action)
    state = state.replace(
        last_shaping=rew.shaping, has_shaping=torch.ones_like(state.has_shaping), done=rew.done
    )
    return state, LandingStepOut(
        obs=_observe(state, cfgs), reward=rew.reward, done=rew.done, solved=rew.solved
    )


def _where_done(done: torch.Tensor, fresh: torch.Tensor, stepped: torch.Tensor) -> torch.Tensor:
    return torch.where(done.reshape(done.shape + (1,) * (stepped.dim() - 1)), fresh, stepped)


@torch.no_grad()
def landing_step_autoreset(
    state: LandingState,
    visual_action: torch.Tensor,
    cfgs: LandingConfigs,
    ctrl_model: Any,
    gen: Optional[torch.Generator] = None,
    *,
    noise: Optional[SensorNoise] = None,
    reset_draws: Optional[ResetDraws] = None,
    reset_noise: Optional[SensorNoise] = None,
) -> tuple[LandingState, LandingStepOut]:
    """Step; where the episode ends, start a fresh one (JAX
    landing/env.py:235-253; the batched-RL convention in place of the
    reference's reset inside the task, rl_worker.py:493). As `jax.vmap`
    does, every env gets a fresh episode, from ``reset_draws`` and its
    warm-up's ``reset_noise`` (drawn from ``gen`` after the step's noise
    unless given), and a `torch.where` keeps it where done, so the step
    never waits on the host. Reward, done and solved are the finished
    episode's; the observation is the fresh one's where done."""
    stepped, out = landing_step(state, visual_action, cfgs, ctrl_model, gen, noise=noise)
    fresh, fresh_obs = landing_reset(gen, cfgs, ctrl_model, state.hist.shape[0],
                                     draws=reset_draws, noise=reset_noise,
                                     dtype=state.hist.dtype)
    obs = LandingObs(*(_where_done(out.done, a, b) for a, b in zip(fresh_obs, out.obs)))
    return hover.where_done(out.done, fresh, stepped), out._replace(obs=obs)
