"""Offline experiment analysis (reference SURVEY.md §2 #26-27): a copy of the
JAX package's `analysis/` (csv, numpy, matplotlib when installed), which
reads the CSV logs that both packages write in the same schema."""

from .training_logs import (
    episodes_to_solve,
    flight_hours_to_solve,
    size_sweep_summary,
    training_curves,
)
from .flight_logs import aggregate_pilot_logs
from .plots import plot_landing_stats, plot_training_curves, plot_trajectory_3d

__all__ = [
    "aggregate_pilot_logs",
    "episodes_to_solve",
    "flight_hours_to_solve",
    "plot_landing_stats",
    "plot_training_curves",
    "plot_trajectory_3d",
    "size_sweep_summary",
    "training_curves",
]
