"""Structured metrics logging.

The port's copy of `utils/metrics.py` in the JAX package: the reference's
16-column CSV training log (reference ppo.py:63-69, 416-419: appended at
each eval, continued on resume) and a JSONL writer.
"""

from __future__ import annotations

import csv
import json
import os
import time
from typing import Iterable

# The reference's header (ppo.py:63).
TRAIN_LOG_HEADER = [
    "LR", "Max timesteps", "Update timesteps", "K epochs", "Eval episodes",
    "Std", "Date", "Time", "Training Count", "T hours", "Reward avg",
    "Solved avg", "Time avg", "Total Episodes", "Total Timesteps", "ETF",
]


class CSVLogger:
    """Append-only CSV with resume semantics: an existing log is kept and
    continued, its row count read back."""

    def __init__(self, path: str, header: Iterable[str]):
        self.path = path
        self.header = list(header)
        self.rows = 0
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        if os.path.exists(path):
            with open(path) as f:
                self.rows = max(sum(1 for _ in f) - 1, 0)
        else:
            with open(path, "w", newline="") as f:
                csv.writer(f).writerow(self.header)

    def append(self, row: dict) -> None:
        with open(self.path, "a", newline="") as f:
            csv.writer(f).writerow([row.get(k, "") for k in self.header])
        self.rows += 1


class JSONLLogger:
    """One JSON object per line, timestamped."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def log(self, **fields) -> None:
        fields.setdefault("ts", time.time())
        with open(self.path, "a") as f:
            f.write(json.dumps(fields) + "\n")
