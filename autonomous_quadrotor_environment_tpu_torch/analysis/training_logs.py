"""Training-log analysis: reward curves, size sweeps, cost-to-solve.

Capability match for the reference's offline analyzers
(reference: environment/controller/training_log/csv_reader.py:17-69 —
NN-size sweep reward curves +/- std and summary table;
training_log/lr_test/csv_reader_lr.py:18-74 — LR sweep;
environment/controller/logger_analyzer.py:5-97 — episodes-to-solve and
flight-hours-to-solve across seeds, solve threshold on eval reward).
Operates on the CSV logs written by apps/train_control.py (same schema).
"""

from __future__ import annotations

import csv
import glob
import math
import os
from collections import defaultdict


def _read_log(path: str) -> list[dict]:
    with open(path) as f:
        return [row for row in csv.DictReader(f)]


def training_curves(log_paths: list[str]) -> dict:
    """{path: {"updates": [...], "reward": [...], "solved": [...]}}."""
    out = {}
    for p in log_paths:
        rows = _read_log(p)
        out[p] = {
            "updates": [int(float(r["Training Count"])) for r in rows],
            "reward": [float(r["Reward avg"]) for r in rows],
            "solved": [float(r["Solved avg"]) for r in rows],
            "timesteps": [int(float(r["Total Timesteps"])) for r in rows],
        }
    return out


def size_sweep_summary(log_dir: str) -> dict:
    """Group logs by network size (log_{size}_{seed}.csv) and summarize the
    final reward mean +/- std per size (reference csv_reader.py:41-69)."""
    groups: dict[int, list[float]] = defaultdict(list)
    for p in glob.glob(os.path.join(log_dir, "log_*.csv")):
        name = os.path.basename(p)[4:-4]
        try:
            size = int(name.split("_")[0])
        except ValueError:
            continue
        rows = _read_log(p)
        if rows:
            groups[size].append(float(rows[-1]["Reward avg"]))
    return {
        size: {
            "n": len(v),
            "reward_mean": sum(v) / len(v),
            "reward_std": math.sqrt(sum((x - sum(v) / len(v)) ** 2 for x in v) / len(v)),
        }
        for size, v in sorted(groups.items())
    }


def episodes_to_solve(
    log_path: str,
    reward_threshold: float | None = 660.0,
    solved_threshold: float | None = None,
) -> int | None:
    """First Total Episodes at which the run counts as solved
    (reference logger_analyzer.py:51-55 gates on eval reward > 660 for the
    velocity task; for our hover task gate on the eval solved fraction via
    ``solved_threshold`` instead — the same stop train_control uses)."""
    for row in _read_log(log_path):
        if solved_threshold is not None:
            if float(row["Solved avg"]) >= solved_threshold:
                return int(float(row["Total Episodes"]))
        elif float(row["Reward avg"]) > reward_threshold:
            return int(float(row["Total Episodes"]))
    return None


def flight_hours_to_solve(
    log_path: str,
    reward_threshold: float | None = 660.0,
    dt: float = 0.01,
    solved_threshold: float | None = None,
) -> float | None:
    """Simulated flight hours until solve: Total Timesteps * dt / 3600
    (reference logger_analyzer.py:95-97)."""
    for row in _read_log(log_path):
        if solved_threshold is not None:
            if float(row["Solved avg"]) >= solved_threshold:
                return float(row["Total Timesteps"]) * dt / 3600.0
        elif float(row["Reward avg"]) > reward_threshold:
            return float(row["Total Timesteps"]) * dt / 3600.0
    return None
