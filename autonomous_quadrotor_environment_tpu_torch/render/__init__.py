"""Camera rendering of the port: the pinhole model and the procedural
ground + checkerboard marker scene, batched over envs."""

from .camera import CameraModel, make_camera, nadir_rotation, pixel_rays, project_points
from .scene import render_nadir, render_pinhole

__all__ = [
    "CameraModel",
    "make_camera",
    "nadir_rotation",
    "pixel_rays",
    "project_points",
    "render_nadir",
    "render_pinhole",
]
