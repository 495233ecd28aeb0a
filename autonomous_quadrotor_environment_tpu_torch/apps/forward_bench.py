"""Policy-forward latency sweep across network sizes.

Counterpart of `apps/forward_bench.py` in the JAX package (the reference's
ppo_forward_time.py, environment/controller/ppo_forward_time.py:48-77: mean
inference latency per hidden size N in {16, 32, 64, 128, 256}), on the CUDA
card unless ``--device cpu``: the actor's mean of one observation (the
real-robot deployment question the reference asked) and of a large batch
(the training question), each timed over ``--iters`` calls after a warm
one, the card synchronized before the clock is read. Prints one JSON line
per size, each naming the device (on the card its name and power limit, as
`nvidia-smi` gives them: a card set below its maximum runs slower).

    python -m autonomous_quadrotor_environment_tpu_torch.apps.forward_bench
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

from ..agents.networks import ActorCritic
from ..device import resolve_device
from ..utils.cache import enable_compilation_cache
from ..utils.timing import Timer

SIZES = (16, 32, 64, 128, 256)


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--iters", type=int, default=100)
    p.add_argument("--batch", type=int, default=4096)
    p.add_argument("--device", type=str, default=None,
                   help="torch device; the CUDA card when omitted")
    return p


def device_name(dev: torch.device) -> str:
    """The card's name and power limit from nvidia-smi (its name alone if
    nvidia-smi does not answer); "cpu" on the CPU."""
    if dev.type != "cuda":
        return "cpu"
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
             f"--id={dev.index or 0}"], capture_output=True, text=True, check=True, timeout=30)
        return smi.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return torch.cuda.get_device_name(dev)


@torch.no_grad()
def main(argv=None) -> list[dict]:
    enable_compilation_cache()
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    name = device_name(dev)
    results = []
    for n in SIZES:
        torch.manual_seed(0)
        model = ActorCritic(hidden=n).to(dev)
        obs1 = torch.zeros(1, 75, device=dev)
        obsb = torch.zeros(args.batch, 75, device=dev)
        times = {}
        for key, obs in (("single", obs1), ("batch", obsb)):
            model.actor_mean(obs)  # warm: cuBLAS handles and workspaces
            timer = Timer()
            with timer.measure():
                for _ in range(args.iters):
                    model.actor_mean(obs)
            times[key] = timer.last / args.iters
        row = {
            "size": n,
            "latency_single_us": round(times["single"] * 1e6, 1),
            "latency_batch_us": round(times["batch"] * 1e6, 1),
            "batch": args.batch,
            "throughput_obs_per_s": round(args.batch / times["batch"]),
            "device": name,
        }
        results.append(row)
        print(json.dumps(row))
    return results


if __name__ == "__main__":
    main()
