"""Train the state-feedback PPO hover/velocity controller, calm or robust.

Counterpart of `apps/train_control.py` in the JAX package (the reference's
`python3 ppo.py -s SEED -N SIZE` training loop, environment/controller/
ppo.py:27-430): the same flags and defaults, the same periodic
deterministic eval, CSV and JSONL logs, and untrained / solved / final
checkpoints in the JAX package's format. It runs on the CUDA card unless
given ``--device cpu``.

``--dp N`` trains data-parallel over N ranks (`parallel.launch.spawn`):
one CUDA card each over NCCL, or N processes on the CPU over gloo with
``--device cpu``. Every rank holds the same model and optimizer and rolls
out ``--num-envs / N`` envs; each minibatch's gradients and each update's
metrics are averaged over the ranks (the CSV's episode count is that mean,
as in the JAX package). Rank 0 evaluates (from the stream the serial run
uses) and writes the logs and checkpoints, and broadcasts each stop
decision, so every rank leaves the loop at the same update.

Example:
    python -m autonomous_quadrotor_environment_tpu_torch.apps.train_control \\
        --robust --severity-sample --seed 0 --updates 2000 --out runs/ctrl_robust
"""

from __future__ import annotations

import argparse
import math
import sys
import time
from datetime import datetime

import torch

from ..agents.networks import ActorCritic, to_flax
from ..agents.ppo import (
    PPOTrainState,
    make_eval_fn,
    make_train_loop,
    make_train_step,
    ppo_init,
    stream,
)
from ..config import EnvConfig, PPOConfig, RandomizationConfig, TrainConfig
from ..device import resolve_device
from ..envs import hover
from ..parallel import dp
from ..parallel.launch import rank_devices, spawn
from ..utils import TRAIN_LOG_HEADER, CSVLogger, JSONLLogger, load_params, save_params
from ..utils.cache import enable_compilation_cache
from ..utils.graphs import counted_launches


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--size", type=int, default=128, help="hidden width N")
    p.add_argument("--updates", type=int, default=2000)
    p.add_argument("--num-envs", type=int, default=1024)
    p.add_argument("--rollout-steps", type=int, default=128)
    p.add_argument("--lr", type=float, default=5e-4)
    p.add_argument("--k-epochs", type=int, default=10)
    p.add_argument("--eval-every", type=int, default=5)
    p.add_argument("--eval-episodes", type=int, default=40)
    p.add_argument("--robust", action="store_true", help="domain randomization + wind")
    p.add_argument(
        "--severity-sample", action="store_true",
        help="per-episode severity s~U[0,1] scaling all perturbations "
        "(RandomizationConfig.severity_sample); the stage severity is the upper bound",
    )
    p.add_argument("--task", type=str, default="hover", choices=("hover", "velocity"),
                   help="hover = position/attitude stabilization; velocity = "
                   "per-episode random velocity-target tracking")
    p.add_argument("--vel-target-max", type=float, default=1.0,
                   help="velocity task: per-axis target range U[-max, max] [m/s]")
    p.add_argument(
        "--curriculum", type=str, default=None, metavar="S1,S2,...",
        help="calm->windy robust curriculum: comma list of severities in [0,1]; each "
        "stage trains for updates//len(stages) updates (the remainder extends the final "
        "stage) and scales the randomization magnitudes (RandomizationConfig.scaled)",
    )
    p.add_argument(
        "--inner", type=int, default=1,
        help="N train steps per call between host round-trips (agents.make_train_loop), "
        "clamped to gcd(--inner, --eval-every, per-stage updates); training is identical "
        "to --inner 1, logging reads each chunk's last update",
    )
    p.add_argument("--dp", type=int, default=0,
                   help="data-parallel ranks (0 = single process): one CUDA card each, or "
                   "processes on the CPU with --device cpu")
    p.add_argument("--out", type=str, default="runs/control")
    p.add_argument("--solved-threshold", type=float, default=0.95)
    p.add_argument("--resume-from", type=str, default=None, metavar="CKPT",
                   help="warm-start params from a .msgpack checkpoint")
    p.add_argument(
        "--polish", action="store_true",
        help="acceptance gate for matching the reference's committed RL same-start log: at "
        "each eval also fly the 20 reference-seeded classical start states and stop only "
        "when that leg is 20/20 AND the eval solved rate holds 100%% AND an eval from an "
        "independent stream confirms >=95%%. Combine with --resume-from and a few hundred "
        "--updates.",
    )
    p.add_argument("--device", type=str, default=None,
                   help="torch device; the CUDA card when omitted")
    return p


_STAGE, _EVAL = 1, 2  # stream tags
_CONFIRM = 10**6  # the polish gate's confirming evals: stream (seed, _EVAL, _CONFIRM + i)


def main(argv=None) -> dict:
    enable_compilation_cache()
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    if args.dp > 0:
        devices, backend = rank_devices(args.dp, args.device)
        ranks = spawn(_dp_rank, devices, backend, (argv,))
        return {**ranks[0]["result"], "ranks": [r["launches"] for r in ranks]}
    return train(args, resolve_device(args.device))


def _dp_rank(mesh: dp.DPMesh, argv: list) -> dict:
    """One rank of ``--dp``: its share of the training, rank 0's result,
    and the rank's kernel launches."""
    enable_compilation_cache()
    result = train(build_parser().parse_args(argv), mesh.device, mesh)
    return {"result": result, "launches": counted_launches()}


def train(args, device: torch.device, mesh: dp.DPMesh = None) -> dict:
    """The training run of ``args`` on ``device``, or as this rank of the
    data-parallel ``mesh``."""
    lead = mesh is None or mesh.rank == 0  # evaluates, logs and saves
    vel_max = (args.vel_target_max,) * 3 if args.task == "velocity" else (0.0, 0.0, 0.0)

    def stage_env_cfg(severity: float) -> EnvConfig:
        return EnvConfig(
            n_steps=1000,
            randomization=RandomizationConfig(
                enabled=args.robust, severity_sample=args.severity_sample
            ).scaled(severity),
            vel_target_max=vel_max,
        )

    if args.curriculum and args.robust:
        severities = [float(s) for s in args.curriculum.split(",")]
    else:
        severities = [1.0 if args.robust else 0.0]
    per_stage = max(args.updates // len(severities), 1)
    # A chunk never straddles an eval point or a stage boundary.
    inner = max(args.inner, 1)
    if inner > 1:
        inner = max(math.gcd(math.gcd(inner, args.eval_every), per_stage), 1)

    env_cfg = stage_env_cfg(severities[-1])  # full-severity (final) config
    ppo_cfg = PPOConfig(lr=args.lr, k_epochs=args.k_epochs)
    train_cfg = TrainConfig(
        num_envs=args.num_envs, rollout_steps=args.rollout_steps, network_size=args.size,
        updates=args.updates, eval_every=args.eval_every, eval_episodes=args.eval_episodes,
        seed=args.seed,
    )
    if mesh is None:
        model, opt, state = ppo_init(args.seed, stage_env_cfg(severities[0]), ppo_cfg, train_cfg,
                                     device=device)
    else:
        model, opt, state = dp.ppo_init_sharded(args.seed, stage_env_cfg(severities[0]), ppo_cfg,
                                                train_cfg, mesh)
    if args.resume_from:
        loaded = ActorCritic.from_flax(load_params(args.resume_from))
        if loaded.hidden != model.hidden:
            raise ValueError(f"{args.resume_from} holds hidden width {loaded.hidden}, "
                             f"not --size {model.hidden}")
        with torch.no_grad():
            for p, q in zip(model.linears(), loaded.linears()):
                p.weight.copy_(q.weight)
                p.bias.copy_(q.bias)
        if lead:
            print(f"resumed params from {args.resume_from}")

    def build(cfg: EnvConfig):
        """The train step (and `inner`-step loop) for a stage's env config;
        the model and optimizer are the same objects at every stage, so
        Adam's state (keyed by the parameters) carries over."""
        if mesh is not None:
            return (dp.make_parallel_train_step(model, opt, cfg, ppo_cfg, train_cfg, mesh),
                    dp.make_parallel_train_loop(model, opt, cfg, ppo_cfg, train_cfg, mesh, inner)
                    if inner > 1 else None)
        step = make_train_step(model, opt, cfg, ppo_cfg, train_cfg)
        loop = make_train_loop(model, opt, cfg, ppo_cfg, train_cfg, inner) if inner > 1 else None
        return step, loop

    # The eval always runs at full severity, so curves compare across stages.
    eval_fn = make_eval_fn(model, env_cfg, episodes=args.eval_episodes)
    stage_i = 0
    train_step, train_loop = build(stage_env_cfg(severities[0]))

    # --polish: the 20 reference-seeded classical start states, flown with
    # the deterministic actor and scored by the reference analyzer's success
    # criterion (classical_compare); checked at every eval.
    polish = {}
    if args.polish and lead:
        from .classical_compare import analyze, leg_env, make_rl_runner, reference_start_states

        polish_cfg = leg_env("rl")
        polish_starts = reference_start_states()
        rl_runner = make_rl_runner(polish_cfg, model)

        def polish_runner() -> float:
            return analyze(rl_runner(polish_starts), polish_cfg)["success_rate"]

    tag = f"{args.size}_{args.seed}"
    if lead:
        csv_log = CSVLogger(f"{args.out}/log_{tag}.csv", TRAIN_LOG_HEADER)
        jsonl = JSONLLogger(f"{args.out}/train_{tag}.jsonl")
    t0 = time.time()
    total_steps = 0
    total_eps_dev = None  # summed on the device: no sync per update
    last_eval: dict = {}

    i = 0  # updates completed
    while i < args.updates:
        next_stage = min(i // per_stage, len(severities) - 1)
        if next_stage != stage_i:
            stage_i = next_stage
            sev = severities[stage_i]
            if lead:
                print(f"== curriculum stage {stage_i}: severity {sev:.2f} ==")
            cfg = stage_env_cfg(sev)
            train_step, train_loop = build(cfg)
            # The env batch is reset under the stage's config from a stream
            # of its own (each rank keeping its slice); model, optimizer and
            # update count carry over.
            gen = torch.Generator(device=device).manual_seed(stream(args.seed, _STAGE, stage_i))
            if mesh is None:
                env_states = hover.reset(gen, cfg, n=train_cfg.num_envs)
            else:
                env_states, gen = dp.reset_sharded(gen, cfg, train_cfg.num_envs, mesh, args.seed,
                                                   _STAGE, stage_i)
            state = PPOTrainState(model=model, optimizer=opt, env_states=env_states, gen=gen,
                                  update_i=state.update_i)
        if train_loop is not None and args.updates - i >= inner:
            state, stacked = train_loop(state)
            metrics = {k: v[-1] for k, v in stacked.items()}
            chunk_eps = stacked["episodes"].sum()
            chunk = inner
        else:
            state, metrics = train_step(state)
            chunk_eps = metrics["episodes"]
            chunk = 1
        i += chunk
        total_steps += chunk * train_cfg.num_envs * train_cfg.rollout_steps
        total_eps_dev = chunk_eps if total_eps_dev is None else total_eps_dev + chunk_eps
        if i % args.eval_every == 0 and not lead:
            if mesh.broadcast_flag(False):  # rank 0's decision to stop
                break
        elif i % args.eval_every == 0:
            total_eps = int(total_eps_dev)
            gen = torch.Generator(device=device).manual_seed(stream(args.seed, _EVAL, i))
            last_eval = {k: float(v) for k, v in eval_fn(gen).items()}
            hours = (time.time() - t0) / 3600.0
            now = datetime.now()
            csv_log.append({
                "LR": args.lr, "Max timesteps": env_cfg.n_steps,
                "Update timesteps": train_cfg.num_envs * train_cfg.rollout_steps,
                "K epochs": args.k_epochs, "Eval episodes": args.eval_episodes,
                "Std": ppo_cfg.action_std, "Date": now.strftime("%d/%m/%Y"),
                "Time": now.strftime("%H:%M:%S"), "Training Count": i,
                "T hours": round(hours, 4),
                "Reward avg": last_eval["eval_reward"],
                "Solved avg": last_eval["eval_solved"],
                "Time avg": last_eval["eval_length"],
                "Total Episodes": total_eps, "Total Timesteps": total_steps,
                "ETF": round(hours / i * (args.updates - i), 4),
            })
            jsonl.log(update=i, **last_eval, **{k: float(v) for k, v in metrics.items()})
            print(
                f"update {i:5d}  reward {last_eval['eval_reward']:8.2f}  "
                f"solved {last_eval['eval_solved']:6.1%}  len {last_eval['eval_length']:6.1f}  "
                f"steps/s {total_steps / (time.time() - t0):9.0f}"
            )
            save_params(f"{args.out}/untrained_networks/nn_{tag}.msgpack", to_flax(model))
            # Robust runs gate on station-keeping (strict stillness is out of
            # reach under persistent gusts), and only at full severity.
            solved_metric = (
                last_eval["eval_station_keeping"] if args.robust else last_eval["eval_solved"]
            )
            stop = False
            if args.polish:
                # Polish acceptance: 20/20 on the reference's same-start
                # classical leg AND 100% eval AND a confirming eval from an
                # independent stream >= 95% (against a lucky eval batch).
                classical = polish["classical"] = polish_runner()
                print(f"  polish: classical leg {classical:.0%}")
                if classical >= 1.0 and last_eval["eval_solved"] >= 1.0:
                    gen = torch.Generator(device=device).manual_seed(
                        stream(args.seed, _EVAL, _CONFIRM + i))
                    confirm = float(eval_fn(gen)["eval_solved"])
                    print(f"  polish: independent confirm {confirm:.1%}")
                    if confirm >= 0.95:
                        save_params(f"{args.out}/solved/nn_solved_{tag}.msgpack", to_flax(model))
                        print("########## Polished: classical 20/20 + eval 100% ##########")
                        stop = True
            elif stage_i == len(severities) - 1 and solved_metric >= args.solved_threshold:
                save_params(f"{args.out}/solved/nn_solved_{tag}.msgpack", to_flax(model))
                print("########## Solved! ##########")
                stop = True
            if mesh is not None:
                mesh.broadcast_flag(stop)
            if stop:
                break

    if not lead:
        return {}
    save_params(f"{args.out}/nn_final_{tag}.msgpack", to_flax(model))
    return {"final_eval": last_eval, "total_steps": total_steps, "wall_s": time.time() - t0,
            **{f"polish_{k}": v for k, v in polish.items()}}


if __name__ == "__main__":
    main()
