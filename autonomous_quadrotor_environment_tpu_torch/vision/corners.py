"""Chessboard corner detection as batched image ops.

Counterpart of `vision/corners.py` in the JAX package (which replaces the
reference's FAST prefilter + `cv.findChessboardCorners`, computer_vision/
quadrotor_cv.py:64-68), on a batch of grayscale images (E, H, W): a
ChESS-style saddle response (four shifted box sums), non-maximum
suppression, the strongest rows*cols peaks refined to sub-pixel and
ordered into the board's rows. Shapes are fixed (a (E, rows*cols, 2) corner
array and a validity flag per image), so a batch runs inside a CUDA graph.

Ties are broken as the JAX package breaks them: `lax.top_k` keeps the
lowest flat index among equal peaks (NMS keeps plateaus, so equal peaks
are real) and `jnp.argsort` is stable. `torch.topk` promises no order among
ties on the card, so the peaks are ranked by one int64 key per pixel that
holds the response's float bits above the reversed index, and the
orderings use stable sorts. The box filter's prefix sums add in the JAX
package's CPU order (`_cumsum`), so the response of a given image is the
JAX package's to the bit, on the card too.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..device import const

CUMSUM_BLOCK = 16


def _seq_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Cumulative sums along the last axis, each the previous one plus the
    next element, in order."""
    outs = [x[..., 0]]
    for k in range(1, x.shape[-1]):
        outs.append(outs[-1] + x[..., k])
    return torch.stack(outs, dim=-1)


def _cumsum(x: torch.Tensor) -> torch.Tensor:
    """``jnp.cumsum`` along the last axis, added in the order XLA's CPU
    backend adds (its reduce-window rewrite of a prefix sum): sequential
    sums within blocks of 16, plus the scan, by the same rule, of the
    blocks' totals. Every step is an elementwise float32 add, so the card
    and the CPU give the JAX package's CPU sums to the bit (`torch.cumsum`
    adds in another order on each device, and a float32 prefix sum over
    480 rows loses up to an ulp of its running total to cancellation)."""
    n, block = x.shape[-1], CUMSUM_BLOCK
    if n <= block:
        return _seq_cumsum(x)
    nb = -(-n // block)
    inb = _seq_cumsum(F.pad(x, (0, nb * block - n)).reshape(*x.shape[:-1], nb, block))
    totals = _cumsum(inb[..., -1])
    before = F.pad(totals[..., :-1], (1, 0))
    return (inb + before[..., None]).reshape(*x.shape[:-1], nb * block)[..., :n]


def _box_sum(img: torch.Tensor, r: int) -> torch.Tensor:
    """(2r+1)^2 box filter of (E, H, W) images via separable cumulative
    sums, 'same' padding."""
    pad = F.pad(img, (r + 1, r, r + 1, r))
    c = _cumsum(pad.transpose(1, 2)).transpose(1, 2)
    rows = c[:, 2 * r + 1:, :] - c[:, : -(2 * r + 1), :]
    c = _cumsum(rows)
    return c[:, :, 2 * r + 1:] - c[:, :, : -(2 * r + 1)]


def corner_response(gray: torch.Tensor, radius: int = 2) -> torch.Tensor:
    """Saddle (X-crossing) response maps, same shape as ``gray`` (E, H, W).

    For each pixel, mean intensities of the four diagonal quadrants A..D
    (A=up-left, B=up-right, C=down-right, D=down-left):
        response = |A + C - B - D| - |A - C| - |B - D|
    max over radii {radius, radius+2}; zero on the wrap-around border."""
    out = None
    for r in (radius, radius + 2):
        # a tensor divisor: a Python-scalar one is a reciprocal multiply on CUDA
        s = _box_sum(gray, r) / const(float((2 * r + 1) ** 2), gray.dtype, gray.device)
        d = r + 1
        a = torch.roll(s, (d, d), (1, 2))      # quadrant centered up-left
        b = torch.roll(s, (d, -d), (1, 2))
        c = torch.roll(s, (-d, -d), (1, 2))
        e = torch.roll(s, (-d, d), (1, 2))
        resp = torch.abs(a + c - b - e) - torch.abs(a - c) - torch.abs(b - e)
        out = resp if out is None else torch.maximum(out, resp)
    h, w = gray.shape[1:]
    rmax = radius + 3
    mask = torch.zeros_like(out)
    mask[:, rmax: h - rmax, rmax: w - rmax] = 1.0
    return torch.clamp_min(out, 0.0) * mask


def _nms(resp: torch.Tensor, radius: int = 2) -> torch.Tensor:
    """Non-maximum suppression: keep pixels that are the max of their
    (2r+1)^2 neighborhood (plateaus included)."""
    m = resp
    for axis in (1, 2):
        for shift in range(1, radius + 1):
            m = torch.maximum(m, torch.roll(resp, shift, axis))
            m = torch.maximum(m, torch.roll(resp, -shift, axis))
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            if dy == 0 or dx == 0:
                continue
            m = torch.maximum(m, torch.roll(resp, (dy, dx), (1, 2)))
    return torch.where(resp >= m, resp, 0.0)


def count_corners(gray: torch.Tensor, threshold: float = 0.05) -> torch.Tensor:
    """(E,) number of NMS corner peaks above threshold: the analogue of the
    reference's FAST-prefilter gate `len(corner_good) > 50`
    (quadrotor_cv.py:64-66)."""
    peaks = _nms(corner_response(gray))
    return torch.sum(peaks > threshold, dim=(1, 2))


def _top_k(flat: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` of non-negative (E, N) float32 rows: the k largest
    values in descending order, equal values lowest index first. Each key
    is the value's bits (monotonic for non-negative floats; + 0.0 turns a
    -0.0 into 0.0) above N - 1 - index, so all keys differ."""
    n = flat.shape[1]
    bits = (flat + 0.0).view(torch.int32).long()
    rev = n - 1 - torch.arange(n, device=flat.device)
    _, pos = torch.topk(bits * (1 << 32) + rev, k, dim=1)
    return torch.gather(flat, 1, pos), pos


def _subpixel_refine(resp: torch.Tensor, yx: torch.Tensor) -> torch.Tensor:
    """Quadratic 1-D fits along y and x around the (E, K, 2) integer peaks
    -> float (y, x)."""
    h, w = resp.shape[1:]
    yc = torch.clamp(yx[..., 0], 1, h - 2)
    xc = torch.clamp(yx[..., 1], 1, w - 2)
    flat = resp.reshape(resp.shape[0], -1)
    at = lambda dy, dx: torch.gather(flat, 1, (yc + dy) * w + (xc + dx))
    c = at(0, 0)
    up, down, left, right = at(-1, 0), at(1, 0), at(0, -1), at(0, 1)
    dy = (down - up) / 2.0
    dyy = down - 2 * c + up
    dx = (right - left) / 2.0
    dxx = right - 2 * c + left
    off_y = torch.where(torch.abs(dyy) > 1e-9, -dy / dyy, 0.0)
    off_x = torch.where(torch.abs(dxx) > 1e-9, -dx / dxx, 0.0)
    off_y = torch.clamp(off_y, -0.5, 0.5)
    off_x = torch.clamp(off_x, -0.5, 0.5)
    return torch.stack([yc + off_y, xc + off_x], dim=-1)


def chessboard_corners_nadir(
    gray: torch.Tensor, cols: int = 9, rows: int = 6, threshold: float = 0.02
) -> tuple[torch.Tensor, torch.Tensor]:
    """Detect and ORDER the rows*cols inner corners of each (E, H, W) image.

    The board appears axis-aligned to the nadir camera, so all peaks are
    sorted into `rows` bands by v (descending: the first row is the
    board's smallest world-y row), then each band by u ascending, matching
    `board_object_points`' row-major order. Returns (corners (E, rows*cols,
    2) as (u, v), ok flags (E,)); ``ok`` is False where the
    (rows*cols)-th strongest peak is not above threshold (board not found).
    """
    e, n = gray.shape[0], rows * cols
    resp = corner_response(gray)
    peaks = _nms(resp)
    vals, idx = _top_k(peaks.reshape(e, -1), n)
    ok = vals[:, -1] > threshold
    w = gray.shape[2]
    yx = _subpixel_refine(resp, torch.stack([idx // w, idx % w], dim=-1))

    # order: rows by v descending, then within each row by u ascending
    order_v = torch.argsort(-yx[..., 0], dim=1, stable=True)
    yx = torch.gather(yx, 1, order_v[..., None].expand(-1, -1, 2))
    yx = yx.reshape(e, rows, cols, 2)
    order_u = torch.argsort(yx[..., 1], dim=2, stable=True)
    yx = torch.gather(yx, 2, order_u[..., None].expand(-1, -1, -1, 2))
    uv = torch.stack([yx[..., 1], yx[..., 0]], dim=-1).reshape(e, n, 2)
    return uv, ok
