"""Quaternion / Euler utilities on batched tensors (last axis = components).

Counterpart of `core/quaternion.py` in the JAX package; same conventions:
quaternion ``[w, x, y, z]`` (scalar first), 3-2-1 Euler angles
``[phi, theta, psi]``, and ``quat_rot_mat`` maps body-frame vectors to the
inertial frame.
"""

from __future__ import annotations

import torch


def euler_quat(ang: torch.Tensor) -> torch.Tensor:
    """3-2-1 Euler angles ``[..., 3]`` -> unit quaternion ``[..., 4]``."""
    half = ang * 0.5
    phi, theta, psi = half[..., 0], half[..., 1], half[..., 2]
    cp, sp = torch.cos(phi), torch.sin(phi)
    ct, st = torch.cos(theta), torch.sin(theta)
    cps, sps = torch.cos(psi), torch.sin(psi)
    q = torch.stack(
        [
            cp * ct * cps + sp * st * sps,
            sp * ct * cps - cp * st * sps,
            cp * st * cps + sp * ct * sps,
            cp * ct * sps - sp * st * cps,
        ],
        dim=-1,
    )
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def quat_euler(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion ``[..., 4]`` -> 3-2-1 Euler angles ``[..., 3]``; the
    arcsin argument is clipped to [-1, 1]."""
    q0, q1, q2, q3 = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    phi = torch.atan2(2 * (q0 * q1 + q2 * q3), 1 - 2 * (q1**2 + q2**2))
    theta = torch.asin(torch.clamp(2 * (q0 * q2 - q3 * q1), -1.0, 1.0))
    psi = torch.atan2(2 * (q0 * q3 + q1 * q2), 1 - 2 * (q2**2 + q3**2))
    return torch.stack([phi, theta, psi], dim=-1)


def deriv_quat(w: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Quaternion kinematics ``q_dot = 1/2 * Omega(w) @ q`` for body rates
    ``w [..., 3]`` and quaternion ``q [..., 4]``."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    q0, q1, q2, q3 = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return 0.5 * torch.stack(
        [
            -wx * q1 - wy * q2 - wz * q3,
            wx * q0 + wz * q2 - wy * q3,
            wy * q0 - wz * q1 + wx * q3,
            wz * q0 + wy * q1 - wx * q2,
        ],
        dim=-1,
    )


def quat_rot_mat(q: torch.Tensor) -> torch.Tensor:
    """Quaternion ``[..., 4]`` -> body-to-inertial rotation ``[..., 3, 3]``."""
    a, b, c, d = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = a**2 + b**2 - c**2 - d**2
    r01 = 2 * (b * c - a * d)
    r02 = 2 * (b * d + a * c)
    r10 = 2 * (b * c + a * d)
    r11 = a**2 - b**2 + c**2 - d**2
    r12 = 2 * (c * d - a * b)
    r20 = 2 * (b * d - a * c)
    r21 = 2 * (c * d + a * b)
    r22 = a**2 - b**2 - c**2 + d**2
    row0 = torch.stack([r00, r01, r02], dim=-1)
    row1 = torch.stack([r10, r11, r12], dim=-1)
    row2 = torch.stack([r20, r21, r22], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def quat_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Normalize quaternion(s) along the last axis."""
    return q / torch.clamp_min(torch.linalg.vector_norm(q, dim=-1, keepdim=True), eps)


def rot_mat_quat(r: torch.Tensor) -> torch.Tensor:
    """Rotation matrix ``[..., 3, 3]`` -> quaternion ``[w, x, y, z]``.

    Branch-free Shepperd extraction, as the JAX package's: all four
    candidate quaternions, the one with the largest pivot kept (ties go to
    the first, as `jnp.argmax` breaks them), normalized, scalar part made
    non-negative."""
    m00, m01, m02 = r[..., 0, 0], r[..., 0, 1], r[..., 0, 2]
    m10, m11, m12 = r[..., 1, 0], r[..., 1, 1], r[..., 1, 2]
    m20, m21, m22 = r[..., 2, 0], r[..., 2, 1], r[..., 2, 2]
    tr = m00 + m11 + m22

    qw = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], dim=-1)
    qy = torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], dim=-1)
    pivots = torch.stack(
        [1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22],
        dim=-1,
    )
    # First index of the maximum: `torch.argmax` does not promise which tie
    # it returns, so compare against the running best explicitly.
    best = torch.zeros_like(pivots[..., 0], dtype=torch.long)
    best_val = pivots[..., 0]
    for i in range(1, 4):
        better = pivots[..., i] > best_val
        best = torch.where(better, i, best)
        best_val = torch.where(better, pivots[..., i], best_val)
    cands = torch.stack([qw, qx, qy, qz], dim=-2)  # [..., 4, 4]
    idx = best[..., None, None].expand(best.shape + (1, 4))
    q = torch.gather(cands, -2, idx)[..., 0, :]
    q = quat_normalize(q)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def quat_mul(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Hamilton product of two ``[w, x, y, z]`` quaternions (broadcasting)."""
    pw, px, py, pz = p[..., 0], p[..., 1], p[..., 2], p[..., 3]
    qw, qx, qy, qz = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack(
        [
            pw * qw - px * qx - py * qy - pz * qz,
            pw * qx + px * qw + py * qz - pz * qy,
            pw * qy - px * qz + py * qw + pz * qx,
            pw * qz + px * qy - py * qx + pz * qw,
        ],
        dim=-1,
    )
