"""Computer-vision pose pipeline: corner detection, PnP, sensor fusion.

Counterpart of `vision/` in the JAX package (the reference's OpenCV
pipeline, computer_vision/quadrotor_cv.py:51-105, and
camera_calibration.py): every stage is a batched tensor function over a
leading episode axis, so the pose correction runs on the card for every
episode inside the mission's compiled step loop.
"""

from .calibration import calibrate_camera, reprojection_rms
from .corners import chessboard_corners_nadir, corner_response, count_corners
from .fusion import VisionFusionState, vision_fuse, vision_fusion_init
from .pipeline import VisionPoseOut, vision_correction_step, vision_pose
from .pnp import board_object_points, solve_pnp

__all__ = [
    "VisionFusionState",
    "VisionPoseOut",
    "board_object_points",
    "calibrate_camera",
    "chessboard_corners_nadir",
    "corner_response",
    "count_corners",
    "reprojection_rms",
    "solve_pnp",
    "vision_correction_step",
    "vision_fuse",
    "vision_fusion_init",
    "vision_pose",
]
