"""Train the visual-landing CNN policy over a frozen state controller.

Counterpart of `apps/train_landing.py` in the JAX package (the reference's
`trainer_vldg.sh N` + `vldg_training.py [-c]` mother/child orchestration,
vldg_training.py:19-127, visual_landing/rl_worker.py:267-342): the same
flags, defaults and outputs (`train_landing_{seed}.jsonl` with one row per
eval, the rolling `PPO_landing_{seed}.msgpack` and the best-eval
`PPO_landing_best_{seed}.msgpack`, both readable by the JAX package's
`load_params`). It runs on the CUDA card unless given ``--device cpu``.

The defaults are the JAX package's certified configuration: float32
rollout images, bf16 convolutions, the reference's per-row shuffle and the
space-to-depth first conv. The eval after update i draws from a generator
seeded with ``seed * 2**32 + i``, where the JAX package folds i into
``PRNGKey(seed)``. ``--dp N`` trains data-parallel over N ranks
(`parallel.dp_landing`: one CUDA card each over NCCL, or processes on the
CPU over gloo with ``--device cpu``), ``--num-envs / N`` envs a rank, each
minibatch's gradients averaged over the ranks; rank 0 evaluates and writes
the log and checkpoints.

Example:
    python -m autonomous_quadrotor_environment_tpu_torch.apps.train_landing \\
        --controller autonomous_quadrotor_environment_tpu/fixtures/nn_solved_128_0.msgpack \\
        --updates 500 --num-envs 64 --out runs/landing
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import sys
import time

import torch

from ..config import PPOConfig
from ..device import resolve_device
from ..landing.env import LandingConfigs
from ..landing.networks import (
    LandingActorCritic,
    detect_s2d,
    params_from_s2d,
    params_to_s2d,
    to_flax,
)
from ..landing.ppo import (
    landing_ppo_init,
    make_landing_eval_fn,
    make_landing_train_loop,
    make_landing_train_step,
)
from ..parallel import dp_landing
from ..parallel.dp import DPMesh
from ..parallel.launch import rank_devices, spawn
from ..utils import JSONLLogger, load_params, save_params
from ..utils.cache import enable_compilation_cache
from ..utils.graphs import counted_launches
from .eval_landing import load_controller

CONV_DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
IMAGE_DTYPES = {"uint8": torch.uint8, "bf16": torch.bfloat16, "f32": None}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--controller", type=str, required=True,
                   help="frozen state-controller checkpoint (.msgpack)")
    p.add_argument("--controller-size", type=int, default=128)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--updates", type=int, default=500)
    p.add_argument("--num-envs", type=int, default=64)
    p.add_argument("--rollout-steps", type=int, default=24,
                   help="policy decisions per env per update")
    p.add_argument("--eval-every", type=int, default=10)
    p.add_argument("--eval-episodes", type=int, default=20)
    p.add_argument("--inner", type=int, default=1,
                   help="train steps per `make_landing_train_loop` call between evals; "
                   "clamped to gcd(--inner, --eval-every); the same updates as --inner 1")
    p.add_argument("--dp", type=int, default=0,
                   help="data-parallel ranks (0 = single process): one CUDA card each, or "
                   "processes on the CPU with --device cpu")
    p.add_argument("--image-dtype", type=str, default="f32", choices=tuple(IMAGE_DTYPES),
                   help="rollout image storage dtype; uint8 (clip(round(x * 255))) was "
                   "unstable over long training in the JAX package, f32 is certified")
    p.add_argument("--conv-dtype", type=str, default="bf16", choices=tuple(CONV_DTYPES),
                   help="conv/dense compute dtype (params and loss math stay f32)")
    p.add_argument("--shuffle-block", type=int, default=-1,
                   help="minibatch shuffle granularity in rows; -1 = "
                   "PPOConfig.landing_variant() (1, the reference's per-row shuffle); "
                   "the minibatch size gives frozen minibatch compositions")
    p.add_argument("--conv-s2d", action=argparse.BooleanOptionalAction, default=True,
                   help="space-to-depth first conv (the same function under a fixed "
                   "kernel permutation); --resume converts a checkpoint of the other layout")
    p.add_argument("--reshuffle-epoch", action="store_true",
                   help="one full-batch row permutation per epoch, minibatches "
                   "contiguous chunks of it (PPOConfig.reshuffle_per_epoch)")
    p.add_argument("--reshuffle-update", action="store_true",
                   help="one full-batch row permutation per update "
                   "(PPOConfig.reshuffle_per_update)")
    p.add_argument("--out", type=str, default="runs/landing")
    p.add_argument("--resume", type=str, default=None,
                   help="landing checkpoint to continue from, either first-conv layout "
                   "(Adam's moments start afresh, as in the JAX package)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device; the CUDA card when omitted")
    return p


def _resume(model: LandingActorCritic, path: str, conv_s2d: bool) -> None:
    """Load a landing checkpoint into ``model`` in place, converting between
    the plain and space-to-depth first-conv layouts."""
    tree = load_params(path)
    ckpt_s2d = detect_s2d(path)
    if ckpt_s2d != conv_s2d:
        tree = params_to_s2d(tree) if conv_s2d else params_from_s2d(tree)
    loaded = LandingActorCritic.from_flax(tree)
    if loaded.conv_s2d != model.conv_s2d:
        raise ValueError(f"{path}: first-conv layout does not fit the model")
    with torch.no_grad():
        for dst, src in zip(model.parameters(), loaded.parameters()):
            dst.copy_(src)
    print(f"resumed from {path}" + (" (converted layout)" if ckpt_s2d != conv_s2d else ""))


def main(argv=None) -> dict:
    enable_compilation_cache()
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    if args.dp > 0:
        devices, backend = rank_devices(args.dp, args.device)
        ranks = spawn(_dp_rank, devices, backend, (argv,))
        return {**ranks[0]["result"], "ranks": [r["launches"] for r in ranks]}
    return train(args, resolve_device(args.device))


def _dp_rank(mesh: DPMesh, argv: list) -> dict:
    """One rank of ``--dp``: its share of the training, rank 0's result,
    and the rank's kernel launches."""
    enable_compilation_cache()
    result = train(build_parser().parse_args(argv), mesh.device, mesh)
    return {"result": result, "launches": counted_launches()}


def train(args, device: torch.device, mesh: DPMesh = None) -> dict:
    """The training run of ``args`` on ``device``, or as this rank of the
    data-parallel ``mesh`` (rank 0 evaluates, logs and saves)."""
    lead = mesh is None or mesh.rank == 0
    # float32 means float32: cuDNN and cuBLAS would run f32 products in TF32.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    ctrl = load_controller(args.controller, args.controller_size, device)
    cfgs = LandingConfigs.default(training=True)
    ppo_cfg = PPOConfig.landing_variant()
    if args.shuffle_block >= 0:
        ppo_cfg = dataclasses.replace(ppo_cfg, shuffle_block=args.shuffle_block)
    if args.reshuffle_update:
        ppo_cfg = dataclasses.replace(ppo_cfg, reshuffle_per_update=True)
    if args.reshuffle_epoch:
        ppo_cfg = dataclasses.replace(ppo_cfg, reshuffle_per_epoch=True)
    image_dtype = IMAGE_DTYPES[args.image_dtype]

    inner = max(args.inner, 1)
    if inner > 1:
        inner = max(math.gcd(inner, args.eval_every), 1)
    conv = dict(conv_dtype=CONV_DTYPES[args.conv_dtype], conv_s2d=args.conv_s2d)
    train_loop = None
    if mesh is None:
        model, opt, state = landing_ppo_init(args.seed, cfgs, ppo_cfg, args.num_envs, ctrl,
                                             device=device, **conv)
        train_step = make_landing_train_step(model, opt, cfgs, ppo_cfg, ctrl, args.rollout_steps,
                                             image_dtype=image_dtype)
        if inner > 1:
            train_loop = make_landing_train_loop(model, opt, cfgs, ppo_cfg, ctrl,
                                                 args.rollout_steps, inner,
                                                 image_dtype=image_dtype)
    else:
        model, opt, state = dp_landing.landing_ppo_init_sharded(
            args.seed, cfgs, ppo_cfg, args.num_envs, ctrl, mesh, **conv)
        train_step = dp_landing.make_landing_parallel_train_step(
            model, opt, cfgs, ppo_cfg, ctrl, args.rollout_steps, mesh, image_dtype=image_dtype)
        if inner > 1:
            train_loop = dp_landing.make_landing_parallel_train_loop(
                model, opt, cfgs, ppo_cfg, ctrl, args.rollout_steps, mesh, inner,
                image_dtype=image_dtype)
    if args.resume:
        _resume(model, args.resume, args.conv_s2d)
    eval_fn = make_landing_eval_fn(model, cfgs, ctrl, args.eval_episodes)
    jsonl = JSONLLogger(f"{args.out}/train_landing_{args.seed}.jsonl") if lead else None
    t0 = time.time()
    last_eval: dict = {}
    # The best-eval checkpoint (the reference saves the solved network the
    # moment it solves, controller/ppo.py:428-429; PPO can degrade after its
    # peak) beside the rolling one.
    best = (-1.0, float("-inf"))
    i = 0  # updates done
    while i < args.updates:
        if train_loop is not None and args.updates - i >= inner:
            state, stacked = train_loop(state)
            metrics = {k: v[-1] for k, v in stacked.items()}
            i += inner
        else:
            state, metrics = train_step(state)
            i += 1
        if i % args.eval_every == 0 and lead:
            gen = torch.Generator(device=device).manual_seed(args.seed * 2**32 + i)
            last_eval = {k: float(v) for k, v in eval_fn(gen).items()}
            jsonl.log(update=i, **last_eval, **{k: float(v) for k, v in metrics.items()})
            print(f"update {i:5d}  eval_reward {last_eval['eval_reward']:8.2f}  "
                  f"solved {last_eval['eval_solved']:6.1%}  decisions/s "
                  f"{i * args.num_envs * args.rollout_steps / (time.time() - t0):7.0f}",
                  flush=True)
            save_params(f"{args.out}/PPO_landing_{args.seed}.msgpack", to_flax(model))
            score = (last_eval["eval_solved"], last_eval["eval_reward"])
            if score > best:
                best = score
                save_params(f"{args.out}/PPO_landing_best_{args.seed}.msgpack", to_flax(model))
    if not lead:
        return {}
    save_params(f"{args.out}/PPO_landing_{args.seed}.msgpack", to_flax(model))
    return {"final_eval": last_eval, "best_eval_solved": best[0], "wall_s": time.time() - t0}


if __name__ == "__main__":
    main()
