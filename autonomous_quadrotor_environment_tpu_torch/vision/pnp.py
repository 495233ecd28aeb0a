"""Batched Gauss-Newton PnP: planar-board pose from ordered 2D corners.

Counterpart of `vision/pnp.py` in the JAX package (which replaces the
reference's `cv.solvePnP`, computer_vision/quadrotor_cv.py:70), batched
over a leading axis E: a homography initialization, then a fixed number of
Gauss-Newton steps over (so(3) rotation, translation).

Conventions: object points live on the marker plane z=0 (board frame);
the solved pose maps board->camera, ``X_c = R X_b + t``; the camera
position in the board frame is ``-R^T t``.

Everything here runs inside the mission's CUDA graphs, so no step may read
the card from the host. `torch.linalg.eigh` and `svd` check their solver's
status on the host and have no form that does not, so the two
decompositions of the homography initialization are written as plain
batched tensor ops, on every device: the 9x9 normal matrix's smallest
eigenvector by cyclic Jacobi sweeps (the pairs of each round rotated at
once), and the projection onto SO(3) (`U V^T` of the SVD) as the orthogonal
polar factor by scaled Newton iterations with a closed-form 3x3 inverse.
The Gauss-Newton step's 6x6 solve is `torch.linalg.solve_ex` without its
error check, and its Jacobian `torch.func.jacfwd` (forward mode, as
`jax.jacfwd`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import MarkerConfig
from ..device import const
from ..render.camera import CameraModel

JACOBI_SWEEPS = 8
POLAR_ITERS = 8


def board_object_points(marker: MarkerConfig | None = None, centered: bool = True,
                        device=None) -> torch.Tensor:
    """(rows*cols, 3) float32 inner-corner coordinates on the board plane,
    row-major; ``centered`` puts the origin at the board center (the
    renderer's marker frame), else at the first corner (the reference's
    mgrid * scale * sqr_size, detector_setup.py:13-14). A cached constant:
    do not write to it."""
    marker = marker or MarkerConfig()
    s = np.float32(marker.square)
    jj, ii = np.meshgrid(np.arange(marker.rows), np.arange(marker.cols), indexing="ij")
    pts = np.stack([ii.reshape(-1).astype(np.float32) * s,
                    jj.reshape(-1).astype(np.float32) * s], axis=-1)
    if centered:
        pts = pts - np.asarray([(marker.cols - 1) * marker.square / 2.0,
                                (marker.rows - 1) * marker.square / 2.0], np.float32)
    pts = np.concatenate([pts, np.zeros((pts.shape[0], 1), np.float32)], axis=-1)
    return const(tuple(map(tuple, pts.tolist())), torch.float32, device)


def _skew(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) cross-product matrices."""
    z = torch.zeros_like(w[..., 0])
    return torch.stack([
        torch.stack([z, -w[..., 2], w[..., 1]], dim=-1),
        torch.stack([w[..., 2], z, -w[..., 0]], dim=-1),
        torch.stack([-w[..., 1], w[..., 0], z], dim=-1),
    ], dim=-2)


def _so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: so(3) vectors (..., 3) -> rotation matrices (..., 3, 3),
    written as the JAX package's so that both the value AND its
    forward-mode derivative are finite at w = 0 (the first Gauss-Newton
    step linearizes there): sin(t)/t and (1-cos t)/t^2 with a softened t,
    the second as half a squared half-angle sinc."""
    theta2 = torch.sum(w * w, dim=-1)
    # a tensor eps: under `torch.func` transforms a 0-d sum plus a Python
    # float promotes to float64
    theta = torch.sqrt(theta2 + const(1e-12, w.dtype, w.device))[..., None, None]
    a = torch.sin(theta) / theta
    half_sinc = torch.sin(theta / 2.0) / (theta / 2.0)
    b = 0.5 * half_sinc**2  # == (1 - cos t) / t^2, smooth at t = 0
    wx = _skew(w)
    eye = const(((1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0)), w.dtype, w.device)
    return eye + a * wx + b * (wx @ wx)


def _rounds(n: int) -> list:
    """Round-robin pairings of n (even) indices: n - 1 rounds of n / 2
    disjoint pairs (p < q), every pair once."""
    idx = list(range(n))
    out = []
    for _ in range(n - 1):
        out.append([tuple(sorted((idx[k], idx[n - 1 - k]))) for k in range(n // 2)])
        idx = [idx[0], idx[-1]] + idx[1:-1]
    return out


def _jacobi_min_eigvec(m: torch.Tensor) -> torch.Tensor:
    """Eigenvector of the smallest eigenvalue of symmetric (E, n, n)
    matrices, by `JACOBI_SWEEPS` cyclic Jacobi sweeps (quadratic convergence:
    8 leave a 9x9 float32 matrix diagonal to rounding): each round rotates
    n/2 disjoint (p, q)
    planes at once (one rotation matrix, A <- J^T A J, V <- V J), each
    rotation the one that zeroes A[p, q] (Golub & Van Loan, sym.schur2).
    An odd n is padded with a zero row and column, which pair to the
    identity and never count as an eigenvalue."""
    e, n = m.shape[0], m.shape[1]
    size = n + (n % 2)
    dtype, device = m.dtype, m.device
    a = torch.zeros(e, size, size, dtype=dtype, device=device)
    a[:, :n, :n] = m
    v = torch.eye(size, dtype=dtype, device=device).expand(e, size, size)
    rounds = []
    for pairs in _rounds(size):
        # J's nonzero entries in flat (row * size + col) order: [p,p], [q,q], [p,q], [q,p]
        at = [(i, i) for i, _ in pairs] + [(j, j) for _, j in pairs] + list(pairs) + [
            (j, i) for i, j in pairs]
        rounds.append((const(tuple(i for i, _ in pairs), torch.long, device),
                       const(tuple(j for _, j in pairs), torch.long, device),
                       const(tuple(r * size + c for r, c in at), torch.long, device)))
    for _ in range(JACOBI_SWEEPS):
        for p, q, at in rounds:
            app, aqq, apq = a[:, p, p], a[:, q, q], a[:, p, q]
            tau = aqq - app
            den = torch.abs(tau) + torch.sqrt(tau * tau + 4.0 * apq * apq)
            sgn = torch.where(tau >= 0, 1.0, -1.0)
            t = torch.where(den > 0, sgn * 2.0 * apq / torch.where(den > 0, den, 1.0), 0.0)
            c = 1.0 / torch.sqrt(1.0 + t * t)
            s = t * c
            j = torch.zeros(e, size * size, dtype=dtype, device=device).scatter(
                1, at.expand(e, -1), torch.cat([c, c, s, -s], dim=1)).reshape(e, size, size)
            a = j.transpose(1, 2) @ a @ j
            v = v @ j
    diag = torch.diagonal(a, dim1=1, dim2=2)[:, :n]
    k = torch.argmin(diag, dim=1)
    return torch.gather(v[:, :n, :], 2, k[:, None, None].expand(-1, n, 1))[..., 0]


def _cofactor(x: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> cofactor matrices, det(X) X^{-T}: columns x1 x x2,
    x2 x x0, x0 x x1."""
    c0, c1, c2 = x[..., :, 0], x[..., :, 1], x[..., :, 2]
    return torch.stack([torch.linalg.cross(c1, c2), torch.linalg.cross(c2, c0),
                        torch.linalg.cross(c0, c1)], dim=-1)


def _det3(x: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> determinants, x0 . (x1 x x2)."""
    return torch.sum(x[..., :, 0] * torch.linalg.cross(x[..., :, 1], x[..., :, 2]), dim=-1)


def _polar(x: torch.Tensor) -> torch.Tensor:
    """Orthogonal polar factor of (..., 3, 3) matrices (``U V^T`` of their
    SVD) by Newton's iteration X <- (g X + (g X)^{-T}) / 2 with the
    determinant scaling g = |det X|^(-1/3) (Higham)."""
    for _ in range(POLAR_ITERS):
        det = _det3(x)[..., None, None]
        g = torch.pow(torch.abs(det), -1.0 / 3.0)
        x = 0.5 * (g * x + _cofactor(x) / (g * det))
    return x


def _homography_init(obj_xy: torch.Tensor, uv_n: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """DLT homography from the plane (N, 2) to normalized image coords
    (E, N, 2), decomposed into an initial (R (E, 3, 3), t (E, 3)) (classic
    plane-based pose init)."""
    e, n = uv_n.shape[0], obj_xy.shape[-2]
    obj_xy = obj_xy.expand(e, n, 2)
    x, y = obj_xy[..., 0], obj_xy[..., 1]
    u, v = uv_n[..., 0], uv_n[..., 1]
    zero = torch.zeros_like(x)
    one = torch.ones_like(x)
    rows_u = torch.stack([x, y, one, zero, zero, zero, -u * x, -u * y, -u], dim=-1)
    rows_v = torch.stack([zero, zero, zero, x, y, one, -v * x, -v * y, -v], dim=-1)
    a = torch.cat([rows_u, rows_v], dim=1)
    # h = eigenvector of A^T A with the smallest eigenvalue
    h = _jacobi_min_eigvec(a.transpose(1, 2) @ a)
    hmat = h.reshape(e, 3, 3)
    # normalize so that ||h1|| = 1 and depth positive
    h1, h2, h3 = hmat[..., 0], hmat[..., 1], hmat[..., 2]
    scale = torch.linalg.vector_norm(h1, dim=-1, keepdim=True)
    sign = torch.where(h3[:, 2:3] / scale > 0, 1.0, -1.0)
    h1, h2, h3 = h1 / scale * sign, h2 / scale * sign, h3 / scale * sign
    r3 = torch.linalg.cross(h1, h2)
    r = _polar(torch.stack([h1, h2, r3], dim=-1))  # onto SO(3)
    r = r * _det3(r)[:, None, None]  # ensure det +1 (flips all cols; ok for init)
    return r, h3


def _residuals(params, r0, obj, uv_n, f_scale):
    """Pixel reprojection residuals (2N,) of one pose ``params`` = (w, t)
    about the initial rotation ``r0``."""
    w, t = params[:3], params[3:6]
    r = _so3_exp(w) @ r0
    xc = obj @ r.T + t
    proj = xc[:, 0:2] / xc[:, 2:3]
    return ((proj - uv_n) * f_scale).reshape(-1)


def solve_pnp(
    cam: CameraModel,
    obj_pts: torch.Tensor,  # (N, 3) board-frame points (z=0 plane)
    uv: torch.Tensor,       # (E, N, 2) pixel observations
    iters: int = 10,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (R (E, 3, 3), t (E, 3), rms (E,)) with X_c = R X_b + t and
    rms the final pixel reprojection error."""
    dtype, device = uv.dtype, uv.device
    fx, fy = const(cam.fx, dtype, device), const(cam.fy, dtype, device)
    uv_n = torch.stack([(uv[..., 0] - cam.cx) / fx, (uv[..., 1] - cam.cy) / fy], dim=-1)
    obj = obj_pts.to(dtype)
    r0, t0 = _homography_init(obj[:, 0:2], uv_n)
    f_scale = const((cam.fx, cam.fy), dtype, device)
    res_fn = torch.func.vmap(_residuals, in_dims=(0, 0, None, 0, None))
    jac_fn = torch.func.vmap(torch.func.jacfwd(_residuals), in_dims=(0, 0, None, 0, None))
    eye6 = const(tuple(tuple(float(i == k) for k in range(6)) for i in range(6)), dtype, device)

    params = torch.cat([torch.zeros_like(t0), t0], dim=-1)
    for _ in range(iters):
        j = jac_fn(params, r0, obj, uv_n, f_scale)
        res = res_fn(params, r0, obj, uv_n, f_scale)
        jt = j.transpose(1, 2)
        jtj = jt @ j + 1e-6 * eye6
        delta = torch.linalg.solve_ex(jtj, (jt @ res[..., None]), check_errors=False)[0]
        params = params - delta[..., 0]
    r = _so3_exp(params[:, :3]) @ r0
    t = params[:, 3:6]
    rms = torch.sqrt(torch.mean(res_fn(params, r0, obj, uv_n, f_scale) ** 2, dim=-1))
    return r, t, rms


def camera_pose_from_pnp(r: torch.Tensor, t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Camera position and board->camera-frame rotation transposed: (cam
    position in the board frame (E, 3), R_cb = R^T (E, 3, 3))."""
    rt = r.transpose(-1, -2)
    return -(rt @ t[..., None])[..., 0], rt
