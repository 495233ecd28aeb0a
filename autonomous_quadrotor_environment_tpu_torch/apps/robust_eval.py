"""Robust-control cross-evaluation: {nominal, robust} x {calm, windy}.

Counterpart of `apps/robust_eval.py` in the JAX package (the reference's
`robust_control` mode, quadrotor_env.py:84-109: per-episode mass, motor,
rotor and inertia perturbations plus 5 m/s interpolated wind gusts). It
prints, per policy x env cell, the strict solve rate, the station-keeping
rate (survive the episode AND hold the post-settle RMS velocity under
0.5 m/s), survival and RMS velocity, as the same JSON; with ``--forensic``
it writes per-episode records and a failure taxonomy. It runs on the CUDA
card unless given ``--device cpu``; the eval is plain PyTorch, so any
width runs there.

    python -m autonomous_quadrotor_environment_tpu_torch.apps.robust_eval \\
        --nominal autonomous_quadrotor_environment_tpu/fixtures/nn_solved_128_0.msgpack \\
        --robust autonomous_quadrotor_environment_tpu/fixtures/nn_robust_128_0.msgpack \\
        --episodes 256 --forensic runs/robust_forensic.json

Every cell flies the episodes of one generator seeded with ``--seed``, so
both policies meet the same starts, and the forensic ``windy_full`` run
repeats the windy cell's draws exactly.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ..agents.networks import ActorCritic
from ..agents.ppo import make_eval_fn, make_forensic_eval_fn
from ..config import EnvConfig, RandomizationConfig
from ..device import resolve_device
from ..utils import load_params


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--nominal", type=str, required=True)
    p.add_argument("--robust", type=str, default=None)
    p.add_argument("--size", type=int, default=128)
    p.add_argument("--robust-size", type=int, default=None,
                   help="hidden width of the robust policy when it differs from --size")
    p.add_argument("--episodes", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--forensic", type=str, default=None, metavar="OUT_JSON",
        help="also run the per-episode diagnostic eval (agents.make_forensic_eval_fn) over "
        "the windy env at full severity and with per-episode severity ~ U[0,1]; writes "
        "records + a failure taxonomy to OUT_JSON",
    )
    p.add_argument("--device", type=str, default=None,
                   help="torch device; the CUDA card when omitted")
    return p


def _taxonomy(rec: dict) -> dict:
    """Classify episodes by the first criterion they fail and summarize the
    diagnostic features per class (the JAX package's own code)."""
    solved = np.asarray(rec["solved"], dtype=float) > 0.5
    survived = np.asarray(rec["survived"], dtype=float) > 0.5
    station = np.asarray(rec["station"], dtype=float) > 0.5
    classes = {
        "solved_strict": solved,
        "station_not_strict": station & ~solved,
        "survived_not_station": survived & ~station,
        "crashed": ~survived,
    }
    out = {}
    for name, mask in classes.items():
        n = int(mask.sum())
        entry = {"n": n, "frac": round(n / len(solved), 4)}
        if n:
            for k in ("severity", "peak_gust", "sat_frac", "rms_vel", "mass_factor", "kf_mean"):
                v = np.asarray(rec[k])[mask].astype(float)
                entry[k] = {"mean": round(float(v.mean()), 4), "max": round(float(v.max()), 4)}
            entry["length_mean"] = float(np.asarray(rec["length"])[mask].mean())
        out[name] = entry
    # Solve rate by severity quartile (informative for the sampled env).
    sev = np.asarray(rec["severity"]).astype(float)
    bins = {}
    for lo in (0.0, 0.25, 0.5, 0.75):
        m = (sev >= lo) & (sev < lo + 0.25 + (lo == 0.75) * 1e-6)
        if m.sum():
            bins[f"[{lo:.2f},{lo + 0.25:.2f})"] = {
                "n": int(m.sum()),
                "solved": round(float(solved[m].mean()), 4),
                "station": round(float(station[m].mean()), 4),
                "survived": round(float(survived[m].mean()), 4),
                "sat_frac_mean": round(float(np.asarray(rec["sat_frac"])[m].mean()), 4),
            }
    out["by_severity_quartile"] = bins
    return out


def load_policy(path: str, size: int, device) -> ActorCritic:
    model = ActorCritic.from_flax(load_params(path))
    if model.hidden != size:
        raise ValueError(f"{path} holds hidden width {model.hidden}, not {size}")
    return model.to(device).eval()


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    policies = {"nominal": load_policy(args.nominal, args.size, device)}
    if args.robust:
        policies["robust"] = load_policy(args.robust, args.robust_size or args.size, device)

    def gen():
        return torch.Generator(device=device).manual_seed(args.seed)

    envs = {
        "calm": EnvConfig(n_steps=1000),
        "windy": EnvConfig(n_steps=1000, randomization=RandomizationConfig(enabled=True)),
    }
    table = {}
    for env_name, cfg in envs.items():
        for pol_name, model in policies.items():
            out = make_eval_fn(model, cfg, episodes=args.episodes)(gen())
            table[f"{pol_name}/{env_name}"] = {k: float(v) for k, v in out.items()}
    print(json.dumps(table, indent=2))

    if args.forensic:
        pol_name = "robust" if "robust" in policies else "nominal"
        model = policies[pol_name]
        forensic = {"policy": pol_name, "episodes": args.episodes, "seed": args.seed}
        forensic_envs = {
            "windy_full": envs["windy"],
            "windy_sampled": EnvConfig(
                n_steps=1000,
                randomization=RandomizationConfig(enabled=True, severity_sample=True),
            ),
        }
        for env_name, cfg in forensic_envs.items():
            out = make_forensic_eval_fn(model, cfg, episodes=args.episodes)(gen())
            rec = {k: [round(float(x), 5) for x in v.float().cpu()] for k, v in out.items()}
            forensic[env_name] = {"taxonomy": _taxonomy(rec), "records": rec}
        os.makedirs(os.path.dirname(args.forensic) or ".", exist_ok=True)
        with open(args.forensic, "w") as f:
            json.dump(forensic, f, indent=1)
        for env_name in forensic_envs:
            print(env_name, json.dumps(forensic[env_name]["taxonomy"], indent=1))
    return table


if __name__ == "__main__":
    main()
