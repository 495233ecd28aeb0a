"""Batched nadir-camera render kernel (B5).

Counterpart of `ops/render_kernel.py:render_nadir_batch_pallas` in the JAX
package. `render_nadir_batch` computes one (3, H, W) image per env from
the env's camera position, marker position and brightness:

* on CUDA tensors, as one launch of the hand-written kernel in
  `csrc/render_nadir.cu` (a CTA per band of rows and span of columns of
  an image: the column and row terms once, then the pixels from them;
  NCHW output; any image size);
* on CPU tensors, as its plain version `render_nadir_batch_plain`
  (`render/scene.py:render_nadir` with the same arguments), which is also
  the reference the kernel is held against on the card.

The landing env's `_observe` calls it once per decision and once per reset
batch.
"""

from __future__ import annotations

import torch

from ..config import CameraConfig, MarkerConfig
from ..render.camera import make_camera
from ..render.scene import render_nadir
from . import _build


def _geometry(cam: CameraConfig, marker: MarkerConfig) -> dict:
    """The kernel's float constants, each the float32 rounding of the value
    the plain version uses; the half extents are formed in double first, as
    the plain version forms them."""
    c = make_camera(cam)
    s = marker.square
    return dict(
        fx=c.fx, fy=c.fy, cx=c.cx, cy=c.cy, square=s,
        half_w=(marker.cols + 1) * s / 2.0, half_h=(marker.rows + 1) * s / 2.0,
    )


def _check(name: str, x: torch.Tensor, shape: tuple, device: torch.device) -> None:
    if x.device != device or x.dtype != torch.float32 or tuple(x.shape) != shape:
        raise ValueError(
            f"{name}: want float32 {shape} on {device}, "
            f"got {x.dtype} {tuple(x.shape)} on {x.device}"
        )
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(quad_pos_env, marker_xy, cam, marker, ground_z_env, brightness):
    device = quad_pos_env.device
    b = quad_pos_env.shape[0]
    _check("quad_pos_env", quad_pos_env, (b, 3), device)
    _check("marker_xy", marker_xy, (b, 2), device)
    if brightness is not None:
        _check("brightness", brightness, (b,), device)
    out = torch.empty(b, 3, cam.height, cam.width, dtype=torch.float32, device=device)
    g = _geometry(cam, marker)
    lib = _build.load("render_nadir")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.render_nadir(
            quad_pos_env.data_ptr(), marker_xy.data_ptr(),
            None if brightness is None else brightness.data_ptr(), out.data_ptr(),
            b, cam.height, cam.width, g["fx"], g["fy"], g["cx"], g["cy"], g["square"],
            g["half_w"], g["half_h"], float(ground_z_env), device.index, stream,
        )
    if err != 0:
        msg = lib.cuda_error_string(err).decode()
        raise RuntimeError(f"render_nadir kernel launch failed: error {err} ({msg})")
    render_nadir_batch.launches += 1
    return out


def render_nadir_batch_plain(quad_pos_env, marker_xy, cam=CameraConfig(), marker=MarkerConfig(),
                             ground_z_env=-5.0, brightness=None):
    """The kernel's plain version, on any device, with its signature."""
    return render_nadir(make_camera(cam), quad_pos_env, marker_xy, marker, ground_z_env,
                        1.0 if brightness is None else brightness)


def render_nadir_batch(
    quad_pos_env: torch.Tensor,  # (B, 3) env-frame quad positions
    marker_xy: torch.Tensor,     # (B, 2)
    cam: CameraConfig = CameraConfig(),
    marker: MarkerConfig = MarkerConfig(),
    ground_z_env: float = -5.0,
    brightness: torch.Tensor | None = None,  # (B,), default 1
) -> torch.Tensor:
    """(B, 3, H, W) float32 images: one kernel launch for CUDA tensors
    (float32, contiguous, all on one card, or a ValueError), the plain
    version for CPU tensors. `render_nadir_batch.launches` counts the
    kernel launches."""
    if quad_pos_env.device.type == "cuda":
        return _launch(quad_pos_env, marker_xy, cam, marker, ground_z_env, brightness)
    if quad_pos_env.device.type != "cpu":
        raise ValueError(f"render_nadir_batch runs on CUDA or CPU tensors, not {quad_pos_env.device}")
    return render_nadir_batch_plain(quad_pos_env, marker_xy, cam, marker, ground_z_env, brightness)


render_nadir_batch.launches = 0
