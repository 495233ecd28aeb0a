"""Per-axis velocity step/ramp response of the trained controller.

Counterpart of `apps/step_response.py` in the JAX package (the reference's
vel_control_ppo.py eval, environment/controller/vel_control_ppo.py:65-150:
command a step or ramp velocity target on one axis and record the
response). The six cases (step/ramp x x/y/z) fly as one batch of 6 from the
same deterministic start, which is what the JAX package's six runs from
PRNGKey(0) are. It runs on the CUDA card unless given ``--device cpu``;
there the step loop replays CUDA graphs of 100 steps.

    python -m autonomous_quadrotor_environment_tpu_torch.apps.step_response \\
        --policy autonomous_quadrotor_environment_tpu/fixtures/nn_solved_128_0.msgpack
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..agents.networks import ActorCritic
from ..config import EnvConfig
from ..core.quaternion import deriv_quat, quat_normalize
from ..device import resolve_device
from ..envs import hover
from ..envs.featurizer import feat_size, push_hist
from ..utils import graphs
from ..utils.cache import enable_compilation_cache
from .robust_eval import load_policy

CHUNK = 100  # steps per graph replay on the card
CASES = [(kind, axis) for kind in ("step", "ramp") for axis in range(3)]


def make_response_runner(env_cfg: EnvConfig, model: ActorCritic, steps: int):
    """``run(vel_targets (R, T, 3)) -> (R, T, 13)`` state logs of R runs
    from the hover start; the controller sees (state - velocity target),
    as the mission harness feeds it."""
    params = list(model.parameters())
    device = params[0].device

    def body(carry, i, v, consts):
        env_s, hist, action = carry
        tgt14 = torch.zeros(v.shape[0], 14, dtype=v.dtype, device=v.device)
        tgt14[:, 1:6:2] = v
        x = env_s.x
        state14 = torch.cat([x[:, 0:10], deriv_quat(x[:, 10:13], quat_normalize(x[:, 6:10]))],
                            dim=-1)
        hist = push_hist(hist, state14 - tgt14, action)
        action = model.actor_mean(hist)
        env_s, _ = hover.step(env_s, action, env_cfg)
        return (env_s, hist, action), env_s.x

    @torch.no_grad()
    def run(vel_targets) -> np.ndarray:
        v = torch.as_tensor(np.asarray(vel_targets), dtype=torch.float32).to(device)
        r = v.shape[0]
        x0 = torch.zeros(r, 13, device=device)
        x0[:, 6] = 1.0
        env_s = hover.reset(None, env_cfg, det_state=x0)
        carry = (env_s, torch.zeros(r, feat_size(5), device=device),
                 torch.zeros(r, 4, device=device))
        _, log = graphs.scan(("step_response", id(model), env_cfg), body, carry, steps,
                             xs=v.transpose(0, 1), chunk=CHUNK, params=params)
        return log.transpose(0, 1).cpu().numpy()

    return run


def response_metrics_velocity(log: np.ndarray, axis: int, target: float, dt: float):
    v = log[:, 1 + 2 * axis]
    err = np.abs(v - target)
    band = max(0.05 * abs(target), 0.05)
    inside = err < band
    rise = float(np.argmax(inside)) * dt if inside.any() else None
    out = np.nonzero(~inside)[0]
    settling = float(out[-1] + 1) * dt if out.size else 0.0
    overshoot = float(v.max() if target > 0 else v.min())
    ss = float(v[-500:].mean() - target)
    return {"rise_s": rise, "settling_s": settling, "peak": overshoot, "ss_error": ss}


def targets_table(steps: int, amplitude: float) -> np.ndarray:
    """The (6, steps, 3) velocity targets of `CASES`: a step, or a ramp over
    the first half then a hold, on one axis."""
    t = np.arange(steps)
    targets = np.zeros((len(CASES), steps, 3), np.float32)
    for r, (kind, axis) in enumerate(CASES):
        if kind == "step":
            targets[r, :, axis] = amplitude
        else:
            ramp_len = steps // 2
            targets[r, :ramp_len, axis] = amplitude * t[:ramp_len] / ramp_len
            targets[r, ramp_len:, axis] = amplitude
    return targets


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--policy", type=str, required=True)
    p.add_argument("--policy-size", type=int, default=128)
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--amplitude", type=float, default=1.0)
    p.add_argument("--device", type=str, default=None,
                   help="torch device; the CUDA card when omitted")
    return p


def main(argv=None) -> dict:
    enable_compilation_cache()
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    env_cfg = EnvConfig(n_steps=args.steps, training=False)
    model = load_policy(args.policy, args.policy_size, device)
    runner = make_response_runner(env_cfg, model, args.steps)
    logs = runner(targets_table(args.steps, args.amplitude))
    results = {}
    for r, (kind, axis) in enumerate(CASES):
        results[f"{kind}_{'xyz'[axis]}"] = response_metrics_velocity(
            logs[r], axis, args.amplitude, env_cfg.dt)
    print(json.dumps(results, indent=2))
    return results


if __name__ == "__main__":
    main()
