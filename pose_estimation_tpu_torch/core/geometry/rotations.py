"""Rotation conversions (counterpart of core/geometry/rotations.py).

What the serving and transparent paths need: Rodrigues both ways,
quaternion to matrix, rigid transform of points, geodesic angle. Conventions as in the JAX package: matrices act on
column vectors, axis-angle is (..., 3) with angle = |v|, quaternions are
(w, x, y, z). Every branch is a `torch.where` over both values, so the
functions run under torch.func.vmap/jacfwd (the LM Jacobian).
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-8


def skew(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) cross-product matrix."""
    z = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([z, -v[..., 2], v[..., 1]], -1),
        torch.stack([v[..., 2], z, -v[..., 0]], -1),
        torch.stack([-v[..., 1], v[..., 0], z], -1),
    ], dim=-2)


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    sq = torch.sum(q * q, dim=-1, keepdim=True)
    q = q / torch.sqrt(torch.clamp(sq, min=_EPS * _EPS))
    return torch.where(q[..., :1] < 0, -q, q)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """(w, x, y, z) quaternion, normalised first -> (..., 3, 3) matrix."""
    q = quat_normalize(q)
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    m = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], dim=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def matrix_to_quat(m: torch.Tensor) -> torch.Tensor:
    """Branch-free Shepperd's method, as in the JAX package."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    qw = torch.stack([1 + m00 + m11 + m22, m21 - m12, m02 - m20, m10 - m01], -1)
    qx = torch.stack([m21 - m12, 1 + m00 - m11 - m22, m01 + m10, m02 + m20], -1)
    qy = torch.stack([m02 - m20, m01 + m10, 1 - m00 + m11 - m22, m12 + m21], -1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1 - m00 - m11 + m22], -1)
    pivots = torch.stack([1 + m00 + m11 + m22, 1 + m00 - m11 - m22,
                          1 - m00 + m11 - m22, 1 - m00 - m11 + m22], -1)
    best = torch.argmax(pivots, dim=-1)
    cands = torch.stack([qw, qx, qy, qz], dim=-2)            # (..., 4, 4)
    idx = best[..., None, None].expand(*best.shape, 1, 4)
    q = torch.gather(cands, -2, idx)[..., 0, :]
    return quat_normalize(q)


def axis_angle_to_matrix(v: torch.Tensor) -> torch.Tensor:
    """Rotation vector (..., 3) -> matrix via Rodrigues, first-order
    expansion below angle^2 = 1e-12 (both branches finite)."""
    angle_sq = torch.sum(v * v, dim=-1, keepdim=True)
    small = angle_sq < 1e-12
    angle = torch.sqrt(torch.where(small, torch.ones_like(angle_sq),
                                   angle_sq))
    axis = v / angle
    s = torch.sin(angle)[..., None]
    c = torch.cos(angle)[..., None]
    k = skew(axis)
    eye = torch.eye(3, dtype=v.dtype, device=v.device).expand(k.shape)
    r_exact = eye + s * k + (1 - c) * (k @ k)
    r_taylor = eye + skew(v)
    return torch.where(small[..., None], r_taylor, r_exact)


def matrix_to_axis_angle(m: torch.Tensor) -> torch.Tensor:
    q = matrix_to_quat(m)
    w = torch.clamp(q[..., 0], -1.0, 1.0)
    xyz = q[..., 1:]
    n = torch.linalg.norm(xyz, dim=-1)
    angle = 2.0 * torch.atan2(n, w)
    scale = torch.where(n < _EPS, torch.full_like(n, 2.0),
                        angle / torch.clamp(n, min=_EPS))
    return xyz * scale[..., None]


def angular_distance(r1: torch.Tensor, r2: torch.Tensor,
                     eps: float = 1e-7) -> torch.Tensor:
    """Geodesic angle in degrees between rotation matrices."""
    tr = torch.diagonal(r1 @ r2.transpose(-1, -2), dim1=-2, dim2=-1).sum(-1)
    cos = torch.clamp((tr - 1.0) / 2.0, -1.0 + eps, 1.0 - eps)
    return torch.acos(cos) * (180.0 / math.pi)


def transform_points(points: torch.Tensor, r: torch.Tensor,
                     t: torch.Tensor) -> torch.Tensor:
    """points (..., N, 3), r (..., 3, 3), t (..., 3): points @ r^T + t."""
    return points @ r.transpose(-1, -2) + t[..., None, :]
