"""Projective ground-plane + checkerboard-marker renderer, batched over envs.

Counterpart of `render/scene.py` in the JAX package: every pixel's ray is
intersected with the ground plane z=0 and colored by a procedural
checkerboard/ground shader; checker edges use a linear smooth step whose
width is the pixel's ground footprint (anti-aliasing). Board geometry: 9x6
inner corners => 10x7 squares of side scale*sqr_size with a light border.

Images are NCHW, (B, 3, H, W), the layout the kernel of
`ops/render_kernel.py` writes; `render_nadir` is that kernel's plain
version.
"""

from __future__ import annotations

import torch

from ..config import MarkerConfig
from ..device import const
from .camera import CameraModel, nadir_rotation, pixel_rays

GROUND_RGB = (0.35, 0.42, 0.32)   # muted greenish ground
BORDER_RGB = (0.9, 0.9, 0.9)
SKY_RGB = (0.55, 0.65, 0.8)
DARK = 0.05
LIGHT = 0.95


def _smooth_square_wave(x: torch.Tensor, half_period: float, soft: torch.Tensor) -> torch.Tensor:
    """Anti-aliased alternating 0/1 pattern with cell size ``half_period``:
    the distance to the nearest cell edge through a linear smooth step of
    width ``soft``. The cell parity is a floor-mod (`torch.remainder`, as
    `jnp.mod`): `fmod` gives -1 on negative cells."""
    t = x / const(half_period, x.dtype, x.device)
    cell = torch.floor(t)
    parity = torch.remainder(cell, 2.0)
    frac = t - cell
    dist = torch.minimum(frac, 1.0 - frac) * half_period
    w = torch.clamp(0.5 + (dist / torch.clamp_min(soft, 1e-6)) * 0.5, 0.0, 1.0)
    return parity * w + (1.0 - parity) * (1.0 - w)


def checkerboard_color(
    xy: torch.Tensor,         # (..., 2) world coords relative to the marker center
    footprint: torch.Tensor,  # (...,) projected pixel size in world units
    marker: MarkerConfig,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(rgb (..., 3), coverage (...)) of the marker at these points;
    coverage is 1 inside the bordered board, 0 outside (smooth edge)."""
    s = marker.square
    nx, ny = marker.cols + 1, marker.rows + 1   # 10 x 7 squares
    half_w, half_h = nx * s / 2.0, ny * s / 2.0
    border = s
    x, y = xy[..., 0], xy[..., 1]
    px = _smooth_square_wave(x + half_w, s, footprint)
    py = _smooth_square_wave(y + half_h, s, footprint)
    checker = px * (1.0 - py) + py * (1.0 - px)     # XOR with AA
    val = DARK + (LIGHT - DARK) * checker

    soft = torch.clamp_min(footprint, 1e-6)
    inside = lambda half, c: torch.clamp((half - torch.abs(c)) / soft + 0.5, 0.0, 1.0)
    on_board = inside(half_w, x) * inside(half_h, y)
    coverage = inside(half_w + border, x) * inside(half_h + border, y)

    border_rgb = const(BORDER_RGB, val.dtype, val.device)
    rgb = val[..., None] * on_board[..., None] + border_rgb * (1.0 - on_board[..., None])
    return rgb, coverage


def shade_ground(xy: torch.Tensor) -> torch.Tensor:
    """Procedural ground shading (..., 3): base color with a soft
    low-frequency variation."""
    g = const(GROUND_RGB, xy.dtype, xy.device)
    wave = (
        0.06 * torch.sin(xy[..., 0] * 1.7) * torch.cos(xy[..., 1] * 1.3)
        + 0.04 * torch.sin(xy[..., 0] * 5.1 + xy[..., 1] * 3.7)
    )
    return torch.clamp(g + wave[..., None], 0.0, 1.0)


def render_pinhole(
    cam: CameraModel,
    r_wc: torch.Tensor,       # (B, 3, 3) or (3, 3) world->camera rotation
    cam_pos_w: torch.Tensor,  # (B, 3) camera positions in the world frame
    marker_xy: torch.Tensor,  # (B, 2) marker centers on the ground plane
    marker: MarkerConfig,
    brightness: torch.Tensor | float = 1.0,  # (B,) or a scalar
) -> torch.Tensor:
    """(B, 3, H, W) images in [0, 1] for arbitrary poses: each pixel's ray
    from ``cam_pos_w`` meets the ground plane z=0; rays that point away
    from the plane see the sky color."""
    dtype, device = cam_pos_w.dtype, cam_pos_w.device
    b = cam_pos_w.shape[0]
    r = r_wc.to(dtype).expand(b, 3, 3)
    dirs_c = pixel_rays(cam, dtype, device)  # (H, W, 3)
    # dirs_c @ r_wc, as explicit multiply-adds in the JAX package's order
    # (a TF32 product on the card would move pixels).
    ray = lambda i: dirs_c[None, :, :, i, None] * r[:, None, None, i, :]
    dirs_w = ray(0) + ray(1) + ray(2)  # (B, H, W, 3)
    dz = dirs_w[..., 2]
    cam_z = cam_pos_w[:, 2, None, None]
    t = -cam_z / torch.where(torch.abs(dz) < 1e-6, 1e-6, dz)
    valid = (t > 0.0) & (dz < 0.0)
    hit = cam_pos_w[:, None, None, :] + t[..., None] * dirs_w
    xy = hit[..., 0:2]
    footprint = torch.abs(t) / const(cam.fx, dtype, device)

    rel = xy - marker_xy.to(dtype)[:, None, None, :]
    marker_rgb, cover = checkerboard_color(rel, footprint, marker)
    rgb = marker_rgb * cover[..., None] + shade_ground(xy) * (1.0 - cover[..., None])
    sky = const(SKY_RGB, dtype, device)
    rgb = torch.where(valid[..., None], rgb, sky)
    if isinstance(brightness, torch.Tensor):
        brightness = brightness.to(dtype).reshape(-1, 1, 1, 1)
    return torch.clamp(rgb * brightness, 0.0, 1.0).permute(0, 3, 1, 2).contiguous()


def render_nadir(
    cam: CameraModel,
    quad_pos_env: torch.Tensor,  # (B, 3) env-frame quad positions (ground at -5)
    marker_xy: torch.Tensor,     # (B, 2) marker positions
    marker: MarkerConfig,
    ground_z_env: float = -5.0,
    brightness: torch.Tensor | float = 1.0,
) -> torch.Tensor:
    """The landing camera, (B, 3, H, W): fixed nadir orientation, position
    follows the quad (reference rl_worker.py:127-128, 358-362: world z =
    5 + env z, attitude NOT applied to the camera)."""
    height = quad_pos_env[:, 2] - ground_z_env
    cam_pos = torch.stack(
        [quad_pos_env[:, 0], quad_pos_env[:, 1], torch.clamp_min(height, 1e-3)], dim=-1
    )
    return render_pinhole(
        cam, nadir_rotation(cam_pos.dtype, cam_pos.device), cam_pos, marker_xy, marker,
        brightness,
    )
