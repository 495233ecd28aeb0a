"""Manual/eval flight-log aggregation.

Capability match for the reference's manual_flight_log_analyzer
(reference: manual_flight_add/manual_flight_log_analyzer.py:18-28): pools
per-user episode CSVs (Episode, Delta V, Reward, Time, Solved) and reports
success rate, mean |dV|, and mean time — the "~83% human pilot" baseline
(reference README.md:10).
"""

from __future__ import annotations

import csv
import glob


def aggregate_pilot_logs(pattern: str) -> dict:
    """``pattern``: glob of per-user CSVs with columns
    [Episode, Delta V, Reward, Time, Solved]."""
    episodes = 0
    solved = 0
    dv_sum = 0.0
    time_sum = 0.0
    for path in glob.glob(pattern):
        with open(path) as f:
            for row in csv.DictReader(f):
                episodes += 1
                solved += int(float(row["Solved"]))
                dv_sum += abs(float(row["Delta V"]))
                time_sum += float(row["Time"])
    if episodes == 0:
        return {"episodes": 0}
    return {
        "episodes": episodes,
        "success_rate": solved / episodes,
        "mean_delta_v": dv_sum / episodes,
        "mean_time_s": time_sum / episodes,
    }
