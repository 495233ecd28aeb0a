"""Camera calibration: recover pinhole intrinsics from board observations.

Counterpart of `vision/calibration.py` in the JAX package (the
reference's `calibration` class, computer_vision/camera_calibration.py:
5-67, cv.calibrateCamera with distortion zeroed): a least-squares fit of
(fx, fy, cx, cy) from corner observations of boards at known poses, plus a
reprojection RMS check. It runs on the host side of a session, never in a
CUDA graph.
"""

from __future__ import annotations

import torch

from ..render.camera import CameraModel


def calibrate_camera(
    obj_pts_cam: torch.Tensor,  # (V, N, 3) board corners in the CAMERA frame per view
    uv: torch.Tensor,           # (V, N, 2) observed pixels
    width: int,
    height: int,
) -> CameraModel:
    """Linear least squares for (fx, cx) and (fy, cy):
        u = fx * (x/z) + cx,  v = fy * (y/z) + cy."""
    xn = (obj_pts_cam[..., 0] / obj_pts_cam[..., 2]).reshape(-1)
    yn = (obj_pts_cam[..., 1] / obj_pts_cam[..., 2]).reshape(-1)
    u = uv[..., 0].reshape(-1)
    v = uv[..., 1].reshape(-1)

    def fit(x, y):
        a = torch.stack([x, torch.ones_like(x)], dim=-1)
        # the CPU's gelsd (SVD-based, as `jnp.linalg.lstsq`); the card's
        # driver takes only gels
        sol = torch.linalg.lstsq(a.cpu(), y.cpu()[:, None], driver="gelsd").solution[:, 0]
        return float(sol[0]), float(sol[1])

    fx, cx = fit(xn, u)
    fy, cy = fit(yn, v)
    return CameraModel(fx=fx, fy=fy, cx=cx, cy=cy, width=width, height=height)


def reprojection_rms(
    cam: CameraModel,
    obj_pts_cam: torch.Tensor,  # (..., 3) camera-frame points
    uv: torch.Tensor,           # (..., 2) observed pixels
) -> torch.Tensor:
    u = cam.fx * obj_pts_cam[..., 0] / obj_pts_cam[..., 2] + cam.cx
    v = cam.fy * obj_pts_cam[..., 1] / obj_pts_cam[..., 2] + cam.cy
    err = torch.stack([u, v], dim=-1) - uv
    return torch.sqrt(torch.mean(torch.sum(err**2, dim=-1)))
