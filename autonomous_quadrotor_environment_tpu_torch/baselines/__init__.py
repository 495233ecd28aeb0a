"""Classical control baselines: cascaded PID, velocity PID, double-loop LQR."""

from .lqr import LQRGains, lqr_control, make_lqr_gains
from .pid import (
    CascadedPIDState,
    PIDGains,
    PIDState,
    POSITION_GAINS,
    VELOCITY_GAINS,
    VELOCITY_GAINS_UNCLIPPED,
    cascaded_pid_control,
    cascaded_pid_init,
    pid_step,
)
from .velocity_pid import VelPIDState, vel_pid, vel_pid_init

__all__ = [
    "CascadedPIDState",
    "LQRGains",
    "PIDGains",
    "PIDState",
    "POSITION_GAINS",
    "VELOCITY_GAINS",
    "VELOCITY_GAINS_UNCLIPPED",
    "VelPIDState",
    "cascaded_pid_control",
    "cascaded_pid_init",
    "lqr_control",
    "make_lqr_gains",
    "pid_step",
    "vel_pid",
    "vel_pid_init",
]
