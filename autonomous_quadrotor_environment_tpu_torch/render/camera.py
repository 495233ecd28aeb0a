"""Pinhole camera model of the renderer.

Counterpart of `render/camera.py` in the JAX package, same conventions:
  * world: z up; ground plane at z = 0 (the env's z = -5);
  * camera frame: +x right, +y down, +z forward (optical axis);
  * nadir pose: optical axis = -world z, image +u = +world x,
    +v = -world y;
  * intrinsics fx = focal/film_w * width, fy = focal/film_h * height,
    principal point at the image center.
The intrinsics are float32 values, as the JAX package rounds them.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import CameraConfig
from ..device import const


class CameraModel(NamedTuple):
    fx: float  # each the float32 rounding of the config's value
    fy: float
    cx: float
    cy: float
    width: int
    height: int

    @property
    def k(self) -> torch.Tensor:
        """3x3 intrinsics matrix (float32, CPU)."""
        return torch.tensor(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
            dtype=torch.float32,
        )


def make_camera(cfg: CameraConfig | None = None) -> CameraModel:
    cfg = cfg or CameraConfig()
    f32 = lambda v: float(np.float32(v))
    return CameraModel(
        fx=f32(cfg.fx),
        fy=f32(cfg.fy),
        cx=f32((cfg.width - 1) / 2.0),
        cy=f32((cfg.height - 1) / 2.0),
        width=cfg.width,
        height=cfg.height,
    )


def nadir_rotation(dtype=torch.float32, device=None) -> torch.Tensor:
    """World->camera rotation of the fixed nadir camera: pi about world x
    (camera x = world x, camera y = -world y, camera z = -world z)."""
    return const(((1.0, 0.0, 0.0), (0.0, -1.0, 0.0), (0.0, 0.0, -1.0)), dtype, device)


def project_points(
    cam: CameraModel,
    points_w: torch.Tensor,  # (..., 3) world points
    r_wc: torch.Tensor,      # (3, 3) world->camera rotation
    t_c: torch.Tensor,       # (3,) camera-frame translation: X_c = R X_w + t
) -> tuple[torch.Tensor, torch.Tensor]:
    """Project world points -> pixel (u, v); also the camera-frame depth."""
    xc = points_w @ r_wc.T + t_c
    z = xc[..., 2]
    u = cam.fx * xc[..., 0] / z + cam.cx
    v = cam.fy * xc[..., 1] / z + cam.cy
    return torch.stack([u, v], dim=-1), z


def pixel_rays(cam: CameraModel, dtype=torch.float32, device=None) -> torch.Tensor:
    """Camera-frame ray directions of every pixel, (H, W, 3) with z = 1
    (normalized image plane)."""
    u = torch.arange(cam.width, dtype=dtype, device=device)
    v = torch.arange(cam.height, dtype=dtype, device=device)
    vv, uu = torch.meshgrid(v, u, indexing="ij")  # (H, W)
    # Tensor divisors: a Python-scalar divisor becomes a reciprocal multiply
    # on CUDA, which rounds differently from the kernel's division.
    fx = const(cam.fx, dtype, device)
    fy = const(cam.fy, dtype, device)
    x = (uu - cam.cx) / fx
    y = (vv - cam.cy) / fy
    return torch.stack([x, y, torch.ones_like(x)], dim=-1)
