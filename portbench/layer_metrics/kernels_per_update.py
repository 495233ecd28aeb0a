"""Kernels the device ran per profiled landing update, the landing cell's
train step: `kernels_per_step`'s count. Reads `kernels_per_update.landing`."""

from portbench.layer_metrics.kernels_per_step import read  # noqa: F401
