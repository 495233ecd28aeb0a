"""Step-response metrics: overshoot, rise time, settling time, SS error.

The port's own copy of `missions/metrics.py` in the JAX package (the
reference's response_analyzer, environment/controller/response_analyzer.py:
5-39), producing the same 14-metric table schema (CE, EOT, Over/Rise/Set/SS
per axis).

The reference's rise/settling formulas contain indexing bugs
(``np.where(y[i, :]) - target`` compares *indices* to the target,
response_analyzer.py:14, and the settling constant hardcodes a 50.01 s
horizon :17); here the metrics are computed by their textbook definitions —
a deliberate divergence, flagged for the parity audit:

  * overshoot:  max |y(t)| over the episode (same as reference :12)
  * rise time:  first t with |y(t) - target| < 0.05
  * settling:   last t with |y(t) - target| > 0.05*|target| (0 if never)
  * ss error:   y(T) - target (same as reference :21)
"""

from __future__ import annotations

import numpy as np


def metrics_calculator(y: np.ndarray, target, dt: float = 0.01):
    """``y``: (13, T) state log (reference layout, transposed); ``target``:
    (3,) final position target."""
    axis = [0, 2, 4]
    over, rise, settle, ss = [], [], [], []
    for j, i in enumerate(axis):
        sig = y[i, :]
        over.append(float(np.max(np.abs(sig))))
        hit = np.nonzero(np.abs(sig - target[j]) < 0.05)[0]
        rise.append(float(hit[0]) * dt if hit.size else 0.0)
        out = np.nonzero(np.abs(sig - target[j]) > 0.05 * abs(target[j]))[0]
        settle.append(float(out[-1] + 1) * dt if out.size else 0.0)
        ss.append(float(sig[-1] - target[j]))
    return over, rise, settle, ss


def response_metrics(
    y: np.ndarray,
    target,
    control_effort: float,
    abs_error: float,
    env_max_steps: int,
    dt: float = 0.01,
) -> dict:
    """The reference's 14-entry series (response_analyzer.py:25-39) as a
    plain dict (pandas optional downstream)."""
    over, rise, settle, ss = metrics_calculator(y, target, dt)
    return {
        "CE": control_effort / env_max_steps,
        "EOT": abs_error / env_max_steps,
        "Over X": over[0], "Over Y": over[1], "Over Z": over[2],
        "Rise X": rise[0], "Rise Y": rise[1], "Rise Z": rise[2],
        "Set X": settle[0], "Set Y": settle[1], "Set Z": settle[2],
        "SS X": ss[0], "SS Y": ss[1], "SS Z": ss[2],
    }
