from .quaternion import (
    deriv_quat,
    euler_quat,
    quat_euler,
    quat_mul,
    quat_normalize,
    quat_rot_mat,
    rot_mat_quat,
)
from .dynamics import (
    MotorOutput,
    StepAux,
    aux_at_state,
    drone_eq,
    f2F,
    f2w,
    physics_step,
    rk4,
    rotor_gyro_speed,
)
from .randomization import DomainParams, zeros_domain

__all__ = [
    "DomainParams",
    "MotorOutput",
    "StepAux",
    "aux_at_state",
    "deriv_quat",
    "drone_eq",
    "euler_quat",
    "f2F",
    "f2w",
    "physics_step",
    "quat_euler",
    "quat_mul",
    "quat_normalize",
    "quat_rot_mat",
    "rk4",
    "rot_mat_quat",
    "rotor_gyro_speed",
    "zeros_domain",
]
