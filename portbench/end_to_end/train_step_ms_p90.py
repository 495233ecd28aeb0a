"""The 90th percentile of the times of all train steps in the window, each
step timed by CUDA events recorded on the stream at its boundaries, with no
host synchronization between steps. Also reads the per-layer
`train_step_ms_p90.host`, the same tail in a cell whose device is idle for
most of each step, so that the host's launches set it."""

import numpy as np


def read(ctx):
    ms = ctx.window.step_ms
    return float(np.quantile(np.asarray(ms, dtype=np.float64), 0.9)) if ms else None
