"""Per-episode domain randomization and the wind-gust model.

Counterpart of `core/randomization.py` in the JAX package (the reference's
`robust_control`, quadrotor_env.py:84-109): the randomized physics are
sampled at reset and carried in the env state, one row per env, and the
wind ramps between gusts resampled every ``gust_period`` steps.

The JAX package draws from per-env PRNG keys, which the port cannot
reproduce; so `sample_domain` takes its draws as a `DomainDraws` (or draws
them from a ``torch.Generator``) and `wind_update` takes each step's gust
draw as a tensor.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..config import RandomizationConfig
from ..device import const


@dataclasses.dataclass
class DomainParams:
    """Episode-constant physics perturbations + wind-gust state, batched
    over envs along the first axis."""

    kf_degrade: torch.Tensor   # (B, 4) motor force loss factor, U[0, d_kf)
    mass_factor: torch.Tensor  # (B,)   mass multiplier offset, N(0, d_m)
    ir_factor: torch.Tensor    # (B, 4) rotor inertia factor, U[0, d_ir)
    j_factor: torch.Tensor     # (B, 3) inertia diagonal factor, N(0, d_j)
    gust_last: torch.Tensor    # (B, 3) previous wind gust [m/s]
    gust_next: torch.Tensor    # (B, 3) current wind gust target [m/s]
    gust_scale: torch.Tensor   # (B,)   per-episode wind severity multiplier


@dataclasses.dataclass
class DomainDraws:
    """The standard draws one `sample_domain` call takes for B envs, in the
    order it draws them from a generator: U[0, 1) and N(0, 1). Leading
    axes other than (B,) are allowed where the draws are later flattened
    (`reshape`)."""

    kf: torch.Tensor        # (B, 4) uniform
    mass: torch.Tensor      # (B,)   normal
    ir: torch.Tensor        # (B, 4) uniform
    j: torch.Tensor         # (B, 3) normal
    gust: torch.Tensor      # (B, 3) normal
    severity: torch.Tensor  # (B,)   uniform; drawn only with severity_sample

    @staticmethod
    def draw(gen: torch.Generator, n: int, severity_sample: bool,
             dtype=torch.float32) -> "DomainDraws":
        kw = dict(generator=gen, dtype=dtype, device=gen.device)
        kf = torch.rand(n, 4, **kw)
        mass = torch.randn(n, **kw)
        ir = torch.rand(n, 4, **kw)
        j = torch.randn(n, 3, **kw)
        gust = torch.randn(n, 3, **kw)
        sev = torch.rand(n, **kw) if severity_sample else torch.ones(n, dtype=dtype,
                                                                     device=gen.device)
        return DomainDraws(kf, mass, ir, j, gust, sev)

    def reshape(self, n: int) -> "DomainDraws":
        """The draws with their leading axes flattened to ``n`` envs."""
        trail = {"kf": (4,), "mass": (), "ir": (4,), "j": (3,), "gust": (3,), "severity": ()}
        return DomainDraws(**{k: getattr(self, k).reshape((n,) + v) for k, v in trail.items()})


def zeros_domain(n: int, dtype=torch.float32, device=None) -> DomainParams:
    """Identity (non-randomized) domain parameters for ``n`` envs."""

    def z(*shape):
        return torch.zeros((n,) + shape, dtype=dtype, device=device)

    return DomainParams(
        kf_degrade=z(4),
        mass_factor=z(),
        ir_factor=z(4),
        j_factor=z(3),
        gust_last=z(3),
        gust_next=z(3),
        gust_scale=torch.ones(n, dtype=dtype, device=device),
    )


def sample_domain(cfg: RandomizationConfig, n: int, gen: Optional[torch.Generator] = None,
                  draws: Optional[DomainDraws] = None, dtype=torch.float32,
                  device=None) -> DomainParams:
    """Per-episode perturbations for ``n`` envs (JAX
    core/randomization.py:49-86) from ``draws``, or drawn from ``gen``.
    A disabled config gives the identity domain and draws nothing.

    With ``cfg.severity_sample`` each env's severity s ~ U[0, 1) scales
    every magnitude and becomes its ``gust_scale``. The normal factors are
    clipped to +/-2 sigma, as in the JAX package (an unclipped mass factor
    <= -1 would make the mass non-positive)."""
    if not cfg.enabled:
        return zeros_domain(n, dtype, device)
    if draws is None:
        if gen is None:
            raise ValueError("a randomized domain needs its draws or a generator")
        draws = DomainDraws.draw(gen, n, cfg.severity_sample, dtype)
    sev = draws.severity if cfg.severity_sample else torch.ones_like(draws.mass)
    gust_std = const(cfg.gust_std, dtype, draws.gust.device)
    return DomainParams(
        kf_degrade=draws.kf * cfg.d_kf * sev[:, None],
        mass_factor=sev * torch.clamp(draws.mass * cfg.d_m, -2.0 * cfg.d_m, 2.0 * cfg.d_m),
        ir_factor=draws.ir * cfg.d_ir * sev[:, None],
        j_factor=sev[:, None] * torch.clamp(draws.j * cfg.d_j, -2.0 * cfg.d_j, 2.0 * cfg.d_j),
        gust_last=torch.zeros_like(draws.gust),
        gust_next=draws.gust * gust_std * sev[:, None],
        gust_scale=sev,
    )


def wind_update(dom: DomainParams, gust_eps: torch.Tensor, i: torch.Tensor,
                cfg: RandomizationConfig) -> tuple[DomainParams, torch.Tensor]:
    """Advance the gust state and return the wind (B, 3) for step ``i``
    (B,) (JAX core/randomization.py:89-115): the wind ramps linearly from
    the previous gust to the next over the period, in closed form,
    ``w = last + (next - last) * idx / (period - 1)`` with ``idx = (i %
    period) - 1``; where ``idx == 0`` the next gust becomes the last and a
    new one, ``gust_eps`` (B, 3) ~ N(0, 1) scaled by ``gust_std *
    gust_scale``, the next. Every env takes a draw every step, resampled or
    not, so the step never waits on the host."""
    if not cfg.enabled:
        return dom, torch.zeros_like(dom.gust_last)
    period = cfg.gust_period
    idx = torch.remainder(i, period) - 1
    resample = (idx == 0)[:, None]
    gust_std = const(cfg.gust_std, dom.gust_next.dtype, gust_eps.device)
    new_gust = gust_eps.to(dom.gust_next.dtype) * gust_std * dom.gust_scale[:, None]
    gust_last = torch.where(resample, dom.gust_next, dom.gust_last)
    gust_next = torch.where(resample, new_gust, dom.gust_next)
    frac = torch.clamp(idx, 0, period - 1).to(dom.gust_next.dtype) / (period - 1)
    wind = gust_last + (gust_next - gust_last) * frac[:, None]
    return dataclasses.replace(dom, gust_last=gust_last, gust_next=gust_next), wind
