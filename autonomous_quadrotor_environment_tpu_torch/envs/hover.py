"""Batched hover/position-stabilization environment.

Counterpart of `envs/hover.py` in the JAX package. The env is a pair of
functions on a batch of envs,

    reset(gen, cfg, n | det_state)             -> EnvState
    reset_replayed(gen, cfg, n | det_state)    -> EnvState  (the warmup as a CUDA graph)
    step(state, action, cfg)                   -> (EnvState, StepOut)
    step_autoreset(state, action, cfg, fresh)  -> (EnvState, StepOut)

with every per-env quantity a tensor whose first axis is the env. Randomness
comes from an explicit ``torch.Generator``; the JAX package's per-env PRNG
keys have no counterpart, so every draw can also be given as a tensor: the
initial states, the randomized domains (`DomainDraws`) and each step's gust
draw (B, 3).

State layout (B, 13): [x, vx, y, vy, z, vz, q0, q1, q2, q3, wx, wy, wz]
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from ..config import BB_POS, BB_VEL, EnvConfig
from ..core.dynamics import physics_step
from ..core.quaternion import euler_quat, quat_euler, quat_normalize
from ..device import const
from ..core.randomization import (
    DomainDraws,
    DomainParams,
    sample_domain,
    wind_update,
    zeros_domain,
)
from ..utils import graphs
from .featurizer import init_hist, push_hist
from .rewards import hover_reward


@dataclasses.dataclass
class EnvState:
    """Per-env episode state, batched along the first axis."""

    x: torch.Tensor             # (B, 13) physics state
    i: torch.Tensor             # (B,) int32 step counter (includes warmup)
    prev_shaping: torch.Tensor  # (B,)
    has_shaping: torch.Tensor   # (B,) bool
    prev_ang: torch.Tensor      # (B, 3) for the Euler-rate estimate
    ang: torch.Tensor           # (B, 3) current Euler angles
    ang_vel: torch.Tensor       # (B, 3) Euler-rate estimate
    done: torch.Tensor          # (B,) bool
    solved: torch.Tensor        # (B,) bool
    abs_sum: torch.Tensor       # (B,) cumulative control effort
    hist: torch.Tensor          # (B, T*15) featurizer window
    last_action: torch.Tensor   # (B, 4) previous clipped action
    vel_target: torch.Tensor    # (B, 3) per-episode velocity target (zeros = hover)
    dom: DomainParams

    def replace(self, **changes) -> "EnvState":
        return dataclasses.replace(self, **changes)


class StepOut(NamedTuple):
    obs: torch.Tensor         # (B, T*15) network input
    quat_state: torch.Tensor  # (B, 14)
    reward: torch.Tensor      # (B,)
    done: torch.Tensor        # (B,) bool
    solved: torch.Tensor      # (B,) bool


def zero_control(cfg: EnvConfig, dtype=torch.float32, device=None) -> torch.Tensor:
    """Neutral action (4,)."""
    p = cfg.physics
    if cfg.direct_control:
        return torch.full((4,), p.hover_action_direct, dtype=dtype, device=device)
    return const((p.mass * p.gravity, 0.0, 0.0, 0.0), dtype, device)


def _bb_limits(cfg: EnvConfig, dtype, device) -> torch.Tensor:
    """Bounding box over [|vel|(3), |euler|(3), |ang_vel|(3)]."""
    lim = (cfg.bb_vel, cfg.bb_vel, cfg.bb_vel, cfg.bb_ang_rp, cfg.bb_ang_rp, cfg.bb_ang_psi,
           cfg.bb_ang_vel, cfg.bb_ang_vel, cfg.bb_ang_vel)
    return const(lim, dtype, device) * cfg.bb_scale


def random_initial_state(gen: torch.Generator, n: int, dtype=torch.float32) -> torch.Tensor:
    """The reference reset distribution for ``n`` envs, on ``gen``'s device:
    uniform attitude in [-0.5, 0.5) rad, clipped normals for pos/vel/rates
    (the asymmetric rate clip is the reference's)."""
    kw = dict(generator=gen, dtype=dtype, device=gen.device)
    ang = torch.rand(n, 3, **kw) - 0.5
    q = euler_quat(ang)
    pos = torch.clamp(torch.randn(n, 3, **kw) * 2.0, -BB_POS / 2, BB_POS / 2)
    vel = torch.clamp(torch.randn(n, 3, **kw) * 2.0, -BB_VEL / 2, BB_VEL / 2)
    omega = torch.clamp(torch.randn(n, 3, **kw) * 2.0, -BB_VEL * 1.5, BB_POS * 1.5)
    interleaved = torch.stack([pos, vel], dim=-1).reshape(n, 6)
    return torch.cat([interleaved, q, omega], dim=-1)


def _raw_state(x: torch.Tensor, t: int, vel_target: Optional[torch.Tensor],
               dom: Optional[DomainParams] = None) -> EnvState:
    n, dtype, device = x.shape[0], x.dtype, x.device
    ang = quat_euler(quat_normalize(x[:, 6:10]))
    if vel_target is None:
        vel_target = torch.zeros(n, 3, dtype=dtype, device=device)
    falses = torch.zeros(n, dtype=torch.bool, device=device)
    zeros = torch.zeros(n, dtype=dtype, device=device)
    return EnvState(
        x=x,
        i=torch.zeros(n, dtype=torch.int32, device=device),
        prev_shaping=zeros,
        has_shaping=falses,
        prev_ang=ang,
        ang=ang,
        ang_vel=torch.zeros(n, 3, dtype=dtype, device=device),
        done=falses,
        solved=falses,
        abs_sum=zeros,
        hist=init_hist(n, t, dtype, device),
        last_action=torch.zeros(n, 4, dtype=dtype, device=device),
        vel_target=vel_target.to(dtype),
        dom=zeros_domain(n, dtype, device) if dom is None else dom,
    )


def step(state: EnvState, action: torch.Tensor, cfg: EnvConfig,
         gust_eps: Optional[torch.Tensor] = None,
         gen: Optional[torch.Generator] = None) -> tuple[EnvState, StepOut]:
    """One environment step for every env of the batch. Under randomization
    the wind comes from `wind_update` with the step's gust draw
    ``gust_eps`` (B, 3), drawn from ``gen`` when not given."""
    x = state.x
    dtype, device = x.dtype, x.device
    phys = cfg.physics
    action = action.to(dtype)

    i = state.i + 1
    if cfg.randomization.enabled and gust_eps is None:
        if gen is None:
            raise ValueError("a randomized step needs gust_eps or a generator to draw it from")
        gust_eps = torch.randn(x.shape[0], 3, generator=gen, dtype=dtype, device=gen.device)
    dom, wind = wind_update(state.dom, gust_eps, i, cfg.randomization)
    x_new, aux = physics_step(
        x,
        action,
        wind,
        phys,
        dom,
        dt=cfg.dt,
        substeps=cfg.rk_substeps,
        direct_control=cfg.direct_control,
        clipped=cfg.clipped,
        randomize=cfg.randomization.enabled,
        compute_accel_aux=False,
    )

    ang = quat_euler(quat_normalize(x_new[:, 6:10]))
    ang_vel = (ang - state.prev_ang) / cfg.dt

    cond = torch.cat([x_new[:, 1:6:2], ang, x_new[:, 10:13]], dim=-1)
    bb_done = torch.any(torch.abs(cond) >= _bb_limits(cfg, dtype, device), dim=-1)

    # The reward sees the clipped action in direct mode, the raw one otherwise.
    reward_action = aux.motor.clipped_action if cfg.direct_control else action

    # The reward and the solve test act on the velocity error; the bounding
    # box above stays on the absolute velocity.
    vel_err = x_new[:, 1:6:2] - state.vel_target

    rew = hover_reward(
        cfg.reward,
        vel=vel_err,
        ang=ang,
        ang_vel=x_new[:, 10:13],
        action=reward_action,
        zero_control=zero_control(cfg, dtype, device),
        prev_shaping=state.prev_shaping,
        has_prev=state.has_shaping,
        step_i=i,
        max_steps=cfg.max_steps,
        bb_done=bb_done,
        training=cfg.training,
    )

    effort = aux.motor.step_effort
    if cfg.direct_control and cfg.effort_is_force:
        effort = (effort + 1.0) * phys.t2wr * phys.mass * phys.gravity / 8.0
    abs_sum = state.abs_sum + torch.linalg.vector_norm(effort, dim=-1)

    quat_state = torch.cat([x_new[:, 0:10], aux.v_q], dim=-1)
    # The window records the raw policy action and observes
    # state-minus-target in the velocity slots.
    obs_state = quat_state.clone()
    obs_state[:, 1:6:2] -= state.vel_target
    hist = push_hist(state.hist, obs_state, action[:, :4])

    new_state = EnvState(
        x=x_new,
        i=i,
        prev_shaping=rew.shaping,
        has_shaping=torch.ones_like(state.has_shaping),
        prev_ang=ang,
        ang=ang,
        ang_vel=ang_vel,
        done=rew.done,
        solved=rew.solved,
        abs_sum=abs_sum,
        hist=hist,
        last_action=reward_action,
        vel_target=state.vel_target,
        dom=dom,
    )
    out = StepOut(
        obs=hist, quat_state=quat_state, reward=rew.reward, done=rew.done, solved=rew.solved
    )
    return new_state, out


class ResetDraws(NamedTuple):
    """Everything `reset` takes for ``n`` fresh episodes, in the order it
    draws them: ``x0`` (n, 13), a velocity task's ``vel_u`` (n, 3) ~ U[0,
    1), and under randomization ``dom`` (`DomainDraws`) and ``warmup_gust``
    (warmup, n, 3); None where the config takes nothing."""

    x0: torch.Tensor
    vel_u: Optional[torch.Tensor]
    dom: Optional[DomainDraws]
    warmup_gust: Optional[torch.Tensor]


def reset_draws(gen: Optional[torch.Generator], cfg: EnvConfig, n: Optional[int] = None,
                dtype=torch.float32, x0: Optional[torch.Tensor] = None,
                vel_u: Optional[torch.Tensor] = None, dom: Optional[DomainDraws] = None,
                warmup_gust: Optional[torch.Tensor] = None) -> ResetDraws:
    """`reset`'s draws for ``n`` episodes (or one per row of ``x0``): each
    one given, else drawn from ``gen`` in this order: the initial states, a
    velocity task's target draws, under randomization the domains and the
    warmup steps' gusts."""
    if x0 is None:
        x0 = random_initial_state(gen, n, dtype)
    n = x0.shape[0]
    if cfg.has_vel_target and vel_u is None:
        vel_u = torch.rand(n, 3, generator=gen, dtype=dtype, device=x0.device)
    if cfg.randomization.enabled:
        if gen is None and (dom is None or (cfg.warmup > 0 and warmup_gust is None)):
            raise ValueError("a randomized reset needs its domain and warmup gust draws "
                             "or a generator")
        if dom is None:
            dom = DomainDraws.draw(gen, n, cfg.randomization.severity_sample, dtype)
        if cfg.warmup > 0 and warmup_gust is None:
            warmup_gust = torch.randn(cfg.warmup, n, 3, generator=gen, dtype=dtype,
                                      device=gen.device)
    return ResetDraws(x0, vel_u, dom, warmup_gust)


def reset(
    gen: Optional[torch.Generator],
    cfg: EnvConfig,
    n: Optional[int] = None,
    det_state: Optional[torch.Tensor] = None,
    dtype=torch.float32,
    dom_draws: Optional[DomainDraws] = None,
    warmup_gust: Optional[torch.Tensor] = None,
    vel_u: Optional[torch.Tensor] = None,
) -> EnvState:
    """Start ``n`` new episodes (or one per row of ``det_state`` (B, 13)) and
    run the warmup steps with the neutral action, from `reset_draws`: the
    initial states, a velocity task's target draws ``vel_u`` (B, 3), under
    randomization the domains' draws ``dom_draws`` (`sample_domain`) and
    the warmup steps' gust draws ``warmup_gust`` (warmup, B, 3), each drawn
    from ``gen`` where it is not given. The first warmup step (i = 1)
    resamples the gust, so a fresh episode's wind depends on its warmup
    draw."""
    d = reset_draws(gen, cfg, n, dtype, None if det_state is None else det_state.to(dtype),
                    vel_u, dom_draws, warmup_gust)
    x0, n = d.x0, d.x0.shape[0]
    vel_target = None
    if cfg.has_vel_target:
        vmax = const(tuple(cfg.vel_target_max), dtype, x0.device)
        vel_target = (d.vel_u.to(dtype) * 2.0 - 1.0) * vmax
    dom = sample_domain(cfg.randomization, n, None, d.dom, dtype, x0.device)
    state = _raw_state(x0, cfg.hist_t, vel_target, dom)

    if cfg.warmup > 0:
        zc = zero_control(cfg, dtype, x0.device).expand(n, 4)
        for w in range(cfg.warmup):
            state, _out = step(state, zc, cfg,
                               gust_eps=None if d.warmup_gust is None else d.warmup_gust[w])
        # Warmup must not leave terminal flags set for the agent's episode.
        falses = torch.zeros_like(state.done)
        state = state.replace(done=falses, solved=falses)
    return state


def reset_replayed(
    gen: Optional[torch.Generator],
    cfg: EnvConfig,
    n: Optional[int] = None,
    det_state: Optional[torch.Tensor] = None,
    dtype=torch.float32,
    dom_draws: Optional[DomainDraws] = None,
    warmup_gust: Optional[torch.Tensor] = None,
    vel_u: Optional[torch.Tensor] = None,
) -> EnvState:
    """`reset`, with the same arguments and result: the draws are taken
    eagerly, from ``gen`` and in `reset`'s order (`reset_draws`), and the
    rest, the warmup steps above all, runs as the replay of one CUDA graph
    per config, dtype and shapes (`utils.graphs.run`; eagerly on the CPU
    and under `graphs.eager`). Eagerly, the warmup of a large batch is a
    few thousand small launches, which leave the card waiting on the
    host."""
    d = reset_draws(gen, cfg, n, dtype, None if det_state is None else det_state.to(dtype),
                    vel_u, dom_draws, warmup_gust)

    def warm(d: ResetDraws) -> EnvState:
        return reset(None, cfg, det_state=d.x0, dtype=dtype, dom_draws=d.dom,
                     warmup_gust=d.warmup_gust, vel_u=d.vel_u)

    return graphs.run(("hover.reset", cfg, dtype), warm, (d,))


def take_envs(state: EnvState, idx) -> EnvState:
    """The envs ``idx`` (an index tensor or a slice) of a batched state."""

    def take(x):
        if dataclasses.is_dataclass(x):
            return type(x)(**{f.name: take(getattr(x, f.name)) for f in dataclasses.fields(x)})
        return x[idx]

    return take(state)


def where_done(done: torch.Tensor, fresh: EnvState, stepped: EnvState) -> EnvState:
    """Per env, ``fresh`` where ``done`` (B,) else ``stepped``, field by field
    (the domain's fields too)."""

    def pick(a, b):
        if dataclasses.is_dataclass(b):
            return type(b)(**{f.name: pick(getattr(a, f.name), getattr(b, f.name))
                              for f in dataclasses.fields(b)})
        return torch.where(done.reshape(done.shape + (1,) * (b.dim() - 1)), a, b)

    return pick(fresh, stepped)


def step_autoreset(
    state: EnvState,
    action: torch.Tensor,
    cfg: EnvConfig,
    fresh: Optional[EnvState] = None,
    gen: Optional[torch.Generator] = None,
    gust_eps: Optional[torch.Tensor] = None,
) -> tuple[EnvState, StepOut]:
    """Step; where the episode ends, start a fresh one at once (JAX
    hover.py:283). The returned `StepOut` reports the terminal transition
    (reward and done of the finished episode); the carried state is the new
    episode's.

    ``fresh`` is a batch of B freshly reset states (`reset` with warmup,
    their randomized domains too); without it one is drawn from ``gen``
    after the step's gust draw (``gust_eps``, drawn from ``gen`` when not
    given). As `jax.vmap` does, every env gets a fresh state and a
    `torch.where` keeps it where done, so the step never waits on the
    host."""
    stepped, out = step(state, action, cfg, gust_eps=gust_eps, gen=gen)
    if fresh is None:
        fresh = reset(gen, cfg, n=state.x.shape[0], dtype=state.x.dtype)
    return where_done(out.done, fresh, stepped), out
