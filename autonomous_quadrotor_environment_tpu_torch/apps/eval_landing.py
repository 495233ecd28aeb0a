"""100-episode visual-landing benchmark + oracle baseline.

Counterpart of `apps/eval_landing.py` in the JAX package (the reference's
rl_eval_worker 100-episode benchmark, visual_landing/rl_eval_worker.py:43,
350-354, and the math_trajectory oracle printout :157-160): the same flags
and defaults, and one JSON dict with the same keys. It runs on the CUDA
card unless given ``--device cpu``.

Example:
    python -m autonomous_quadrotor_environment_tpu_torch.apps.eval_landing \\
        --controller autonomous_quadrotor_environment_tpu/fixtures/nn_solved_128_0.msgpack \\
        --policy autonomous_quadrotor_environment_tpu/fixtures/landing_policy.msgpack \\
        --episodes 100 --seed 0 --oracle
"""

from __future__ import annotations

import argparse
import json

import torch

from ..agents.networks import ActorCritic
from ..device import resolve_device
from ..landing.env import LandingConfigs
from ..landing.networks import LandingActorCritic
from ..landing.oracle import oracle_landing_eval
from ..landing.ppo import make_landing_eval_fn
from ..utils.checkpoint import load_params


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--controller", type=str, required=True)
    p.add_argument("--controller-size", type=int, default=128)
    p.add_argument("--policy", type=str, default=None,
                   help="landing CNN checkpoint; omit to run only the oracle")
    p.add_argument("--episodes", type=int, default=100)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--oracle", action="store_true", help="also run the PI oracle")
    p.add_argument("--conv-dtype", type=str, default="float32",
                   choices=("float32", "bfloat16"),
                   help="CNN compute dtype (params stay float32)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device; the CUDA card when omitted")
    return p


def load_controller(path: str, size: int, device) -> ActorCritic:
    """The frozen state controller (the JAX package's
    apps/train_landing.py:load_controller) on ``device``, in eval mode."""
    model = ActorCritic.from_flax(load_params(path))
    if model.hidden != size:
        raise ValueError(f"{path} holds hidden width {model.hidden}, not --controller-size {size}")
    return model.to(device).eval()


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    # float32 means float32: cuDNN would run the convs in TF32 by default.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    ctrl = load_controller(args.controller, args.controller_size, device)
    cfgs = LandingConfigs.default(training=False)
    results = {}

    if args.policy:
        # The first-conv layout (plain or space-to-depth) is read from the
        # checkpoint itself.
        conv_dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[args.conv_dtype]
        model = LandingActorCritic.from_flax(load_params(args.policy),
                                             conv_dtype=conv_dtype).to(device).eval()
        gen = torch.Generator(device=device).manual_seed(args.seed)
        eval_fn = make_landing_eval_fn(model, cfgs, ctrl, args.episodes)
        results.update({k: float(v) for k, v in eval_fn(gen).items()})

    if args.oracle or not args.policy:
        # A stream of its own, as the JAX package folds 1 into the key.
        gen = torch.Generator(device=device).manual_seed(args.seed + 1_000_003)
        oracle = oracle_landing_eval(ctrl, cfgs, args.episodes, gen)
        results.update({k: float(v) for k, v in oracle.items()})

    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
