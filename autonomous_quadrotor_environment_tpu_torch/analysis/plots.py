"""Figure generation: 3D trajectories and training curves.

Capability match for the reference's `plotter` class
(reference: environment/quadrotor_env.py:727-836 — accumulates states and
renders a 3D position plot with optional target) and the training-log
curve figures (training_log/csv_reader.py:17-69). Headless matplotlib
(Agg), PNG output.
"""

from __future__ import annotations

import os

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_trajectory_3d(
    states: np.ndarray,           # (T, 13) state log
    path: str,
    target: np.ndarray | None = None,  # (T, 3) or (3,) reference positions
    title: str = "Trajectory",
) -> str:
    """3D position plot (reference plotter.plot, quadrotor_env.py:790-836)."""
    plt = _plt()
    fig = plt.figure(figsize=(7, 6))
    ax = fig.add_subplot(projection="3d")
    xyz = states[:, 0:5:2]
    ax.plot(xyz[:, 0], xyz[:, 1], xyz[:, 2], label="position")
    if target is not None:
        t = np.atleast_2d(np.asarray(target))
        if t.shape[0] == 1:
            ax.scatter(*t[0], color="r", marker="*", s=80, label="target")
        else:
            ax.plot(t[:, 0], t[:, 1], t[:, 2], "--", label="target")
    ax.set_xlabel("x (m)")
    ax.set_ylabel("y (m)")
    ax.set_zlabel("z (m)")
    ax.set_title(title)
    ax.legend()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return path


def plot_training_curves(curves: dict, path: str, metric: str = "reward") -> str:
    """Reward/solved curves per log (reference csv_reader.py:41-69).
    ``curves``: output of analysis.training_curves."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(7, 4))
    for name, c in curves.items():
        label = os.path.basename(name).replace("log_", "").replace(".csv", "")
        ax.plot(c["updates"], c[metric], label=label)
    ax.set_xlabel("update")
    ax.set_ylabel(metric)
    ax.grid(True)
    ax.legend()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return path


def sweep_band_figure(
    out_dir: str,
    sizes: list[int],
    seeds: list[int],
    path: str,
    solved_threshold: float = 0.95,
) -> dict:
    """Per-size mean±std reward bands over seeds — the reference's
    network-size-sweep figure (training_log/csv_reader.py:17-69 plots
    mean/band curves over its 5 sizes x 4 seeds log grid).

    Seeds early-stop at different update counts (train_control stops at the
    solved threshold, like the reference's worker); shorter curves are
    extended by holding their final value, which is faithful for a solved
    run (the policy is frozen at that quality) and matches how the
    reference's analyzer aligns unequal-length logs. Returns the per-size
    aggregate table (also written by the caller to summary.json).
    """
    import csv

    plt = _plt()
    fig, ax = plt.subplots(figsize=(8, 4.5))
    summary: dict = {}
    colors = plt.get_cmap("viridis")(np.linspace(0.0, 0.85, len(sizes)))
    for size, color in zip(sizes, colors):
        per_seed = []
        finals, solved_flags, episodes = [], [], []
        for seed in seeds:
            fp = os.path.join(out_dir, f"log_{size}_{seed}.csv")
            if not os.path.exists(fp):
                continue
            with open(fp) as f:
                rows = list(csv.DictReader(f))
            if not rows:
                continue
            upd = np.array([int(r["Training Count"]) for r in rows])
            rew = np.array([float(r["Reward avg"]) for r in rows])
            sol = np.array([float(r["Solved avg"]) for r in rows])
            per_seed.append((upd, rew))
            finals.append(rew[-1])
            solved_flags.append(bool((sol >= solved_threshold).any()))
            episodes.append(int(rows[-1]["Total Episodes"]))
        if not per_seed:
            continue
        grid = max(u[-1] for u, _ in per_seed)
        step = min(np.diff(u).min() if len(u) > 1 else grid for u, _ in per_seed)
        xs = np.arange(step, grid + 1, step)
        mat = np.stack([
            np.interp(xs, u, r, right=r[-1]) for u, r in per_seed
        ])
        mean, std = mat.mean(0), mat.std(0)
        ax.plot(xs, mean, color=color, label=f"N={size} ({len(per_seed)} seeds)")
        ax.fill_between(xs, mean - std, mean + std, color=color, alpha=0.2)
        summary[str(size)] = {
            "seeds": len(per_seed),
            "solved_seeds": int(np.sum(solved_flags)),
            "final_reward_mean": float(np.mean(finals)),
            "final_reward_std": float(np.std(finals)),
            "episodes_mean": float(np.mean(episodes)),
        }
    ax.set_xlabel("update")
    ax.set_ylabel("eval reward (mean ± std over seeds)")
    ax.grid(True, alpha=0.3)
    ax.legend()
    ax.set_title("Network-size sweep (reference csv_reader.py figure)")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return summary


def plot_landing_stats(
    errors: np.ndarray,   # (E, T, 3) per-episode position errors over time
    path: str,
    dt: float = 0.01,     # seconds per sample (0.1 for per-decision samples)
) -> str:
    """Mean ± std landing-error envelopes (reference rl_eval_worker.py:
    306-348: mean/std error plots over the 100-episode benchmark)."""
    plt = _plt()
    fig, axs = plt.subplots(3, 1, figsize=(7, 7), sharex=True)
    t = np.arange(errors.shape[1]) * dt
    for i, lab in enumerate(["x", "y", "z"]):
        mean = errors[:, :, i].mean(0)
        std = errors[:, :, i].std(0)
        axs[i].plot(t, mean, label=f"{lab} error")
        axs[i].fill_between(t, mean - std, mean + std, alpha=0.3)
        axs[i].grid(True)
        axs[i].legend()
    axs[-1].set_xlabel("time (s)")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return path


def plot_controller_comparison(
    logs: dict,   # {"pid": (E, T, >=10) log, "lqr": ..., "rl": ...}
    path: str,
    dt: float = 0.01,
) -> str:
    """Same-start controller comparison: mean state norm (vel, ang, ang_vel)
    vs time per controller (reference classical_controller_results/
    results_analyzer_same.py:16-71 figures)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(7, 4))
    for name, log in logs.items():
        norm = np.linalg.norm(log[:, :, 0:9], axis=-1)
        t = np.arange(norm.shape[1]) * dt
        # median + IQR: episodes that leave the bounding box keep integrating
        # (the reference's fixed-500-step protocol) and would swamp a mean
        med = np.median(norm, 0)
        ax.plot(t, med, label=f"{name} (median of {norm.shape[0]} eps)")
        ax.fill_between(t, np.quantile(norm, 0.25, 0), np.quantile(norm, 0.75, 0), alpha=0.2)
    ax.axhline(0.05, color="k", ls=":", lw=1, label="success band (0.05)")
    ax.set_yscale("log")
    ax.set_xlabel("time (s)")
    ax.set_ylabel("‖vel, ang, ang-vel‖")
    ax.grid(True, which="both", alpha=0.3)
    ax.legend()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return path
