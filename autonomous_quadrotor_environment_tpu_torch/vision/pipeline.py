"""End-to-end vision pose-correction step for closed-loop control.

Counterpart of `vision/pipeline.py` in the JAX package (the reference's
`pos_deter` task, computer_vision/quadrotor_cv.py:57-105), batched over E
episodes: every N-th frame, render each episode's camera view, gate on the
FAST-equivalent corner count (>50, :64-66), find the ordered chessboard
corners, solve PnP, convert the camera pose to an env-frame position and
attitude estimate, and blend it into the INS with the complementary filter
(:90-99). Used by the hybrid ("IMG_POS_DETER") mode of the mission harness.

The JAX package skips off-cadence steps with `lax.cond` on the step index.
Inside a CUDA graph the step index is a tensor on the card, so the cadence
is static here: the caller passes the step's phase ``step_i % every`` as a
Python int (`utils/graphs.scan` gives each step body its phase), and only
due steps render and solve. An off-cadence step is the identity on the
fusion and sensor state, as the JAX package's is.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..config import CameraConfig, MarkerConfig
from ..core.quaternion import quat_normalize, quat_rot_mat, rot_mat_quat
from ..envs.sensors import SensorState
from ..render import make_camera, render_pinhole
from ..render.camera import nadir_rotation
from .corners import chessboard_corners_nadir, count_corners
from .fusion import VisionFusionState, vision_fuse
from .pnp import board_object_points, camera_pose_from_pnp, solve_pnp


class VisionPoseOut(NamedTuple):
    ok: torch.Tensor       # (E,) detection+solve success
    pos_env: torch.Tensor  # (E, 3) estimated env-frame position
    quat: torch.Tensor     # (E, 4) estimated attitude
    rms: torch.Tensor      # (E,) reprojection error [px]


def vision_pose(
    quad_pos_env: torch.Tensor,   # (E, 3) TRUE positions (render the views)
    marker_xy: torch.Tensor,      # (E, 2) marker positions on the ground
    cam_cfg: CameraConfig,
    marker_cfg: MarkerConfig,
    ground_z_env: float = -5.0,
    corner_gate: int = 50,
    rms_gate: float = 1.0,
    quad_quat: Optional[torch.Tensor] = None,  # (E, 4)
) -> VisionPoseOut:
    """Render -> detect -> PnP -> env-frame pose estimates.

    With ``quad_quat`` the camera is BODY-ATTACHED, optical axis along body
    -z (the reference's mission camera, quadrotor_cv.py:29-32), so PnP also
    measures attitude; without it the camera is gimbal-stabilized nadir
    (the landing camera) and the recovered quaternion is only the camera
    mount's (about the identity)."""
    cam = make_camera(cam_cfg)
    dtype, device = quad_pos_env.dtype, quad_pos_env.device
    height = quad_pos_env[:, 2] - ground_z_env
    cam_pos_w = torch.stack(
        [quad_pos_env[:, 0], quad_pos_env[:, 1], torch.clamp_min(height, 1e-3)], dim=-1)
    nadir = nadir_rotation(dtype, device)
    if quad_quat is None:
        r_wc = nadir
    else:
        # camera frame = nadir-convention frame rigidly attached to the body:
        # world->camera = R_cam<-body @ R_body<-world = nadir @ rot_mat^T.
        r_wc = nadir @ quat_rot_mat(quat_normalize(quad_quat)).transpose(1, 2)
    img = render_pinhole(cam, r_wc, cam_pos_w, marker_xy, marker_cfg)
    gray = torch.mean(img, dim=1)
    n_corners = count_corners(gray)
    uv, found = chessboard_corners_nadir(gray, marker_cfg.cols, marker_cfg.rows)
    r, t, rms = solve_pnp(cam, board_object_points(marker_cfg, device=device), uv)
    cam_pos_board, _r_cb = camera_pose_from_pnp(r, t)
    # board frame == world translated to the marker; env z = height + ground.
    pos_env = torch.stack([cam_pos_board[:, 0] + marker_xy[:, 0],
                           cam_pos_board[:, 1] + marker_xy[:, 1],
                           cam_pos_board[:, 2] + ground_z_env], dim=-1)
    # attitude: R maps board->camera = nadir @ R_body<-world, so
    # R_body->world = (nadir^T R)^T.
    quat = rot_mat_quat((nadir.T @ r).transpose(1, 2))
    ok = (n_corners > corner_gate) & found & (rms < rms_gate) & torch.isfinite(rms)
    safe = lambda x: torch.where(torch.isfinite(x), x, 0.0)
    return VisionPoseOut(ok=ok, pos_env=safe(pos_env), quat=safe(quat), rms=rms)


def vision_correction_step(
    fstate: VisionFusionState,
    sens: SensorState,
    quad_pos_env: torch.Tensor,  # (E, 3)
    marker_xy: torch.Tensor,     # (E, 2)
    step_i: torch.Tensor,        # () integer env step: the fusion ring's slot
    dt: float,
    cam_cfg: CameraConfig,
    marker_cfg: MarkerConfig,
    every: int = 10,
    quad_quat: Optional[torch.Tensor] = None,
    innovation_gate: float = 1.5,
    *,
    phase: int,
) -> tuple[VisionFusionState, SensorState, VisionPoseOut]:
    """The full pos_deter cadence: the vision pipeline on every
    ``every``-th step (reference quadrotor_cv.py:62: task.frame % 10 == 1),
    fused on success. ``phase``, the step modulo ``every`` as a Python int,
    alone decides the cadence: the render+detect+PnP work runs only where it
    is 1 (``step_i`` is a device tensor, which a graph cannot branch on, and
    only picks the fusion ring's slot). The caller keeps the two in step, as
    `graphs.scan(..., period=every)` does.

    Beyond the reference's corner-count gate, fixes are innovation-gated:
    an estimate further than ``innovation_gate`` meters from the current
    INS position is rejected (the top-k detector always returns 54 peaks,
    so marginal detections at altitude must not yank the filter)."""
    if not 0 <= phase < every:
        raise ValueError(f"phase {phase} is not a step index modulo every={every}")
    e = quad_pos_env.shape[0]
    if phase != 1:
        kw = dict(dtype=quad_pos_env.dtype, device=quad_pos_env.device)
        return fstate, sens, VisionPoseOut(
            ok=torch.zeros(e, dtype=torch.bool, device=quad_pos_env.device),
            pos_env=torch.zeros(e, 3, **kw), quat=torch.zeros(e, 4, **kw),
            rms=torch.full((e,), float("inf"), **kw))
    out = vision_pose(quad_pos_env, marker_xy, cam_cfg, marker_cfg, quad_quat=quad_quat)
    innovation = torch.linalg.vector_norm(out.pos_env - sens.pos_ins, dim=-1)
    ok = out.ok & (innovation < innovation_gate)
    fstate, sens = vision_fuse(fstate, sens, out.pos_env, out.quat, ok, step_i, dt)
    return fstate, sens, VisionPoseOut(ok=ok, pos_env=out.pos_env, quat=out.quat, rms=out.rms)
