"""Rotation conversions (counterpart of core/geometry/rotations.py).

Rodrigues both ways, quaternions both ways, the 6-D (ortho6d) form both
ways, intrinsic Euler angles, uniform random rotations, rigid transform
of points, geodesic angle. Conventions as in the JAX package: matrices
act on column vectors, axis-angle is (..., 3) with angle = |v|,
quaternions are (w, x, y, z). Every branch is a `torch.where` over both values, so the
functions run under torch.func.vmap/jacfwd (the LM Jacobian).
"""

from __future__ import annotations

import math

import torch

from pose_estimation_tpu_torch.core.mathsafe import safe_normalize

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


def ortho6d_to_matrix(poses: torch.Tensor) -> torch.Tensor:
    """6-D continuous representation (..., 6) -> matrix (Zhou et al.,
    CVPR'19): columns x = normalize(poses[..., :3]), z = normalize(x x
    poses[..., 3:]), y = z x x."""
    x = safe_normalize(poses[..., 0:3], eps=_EPS)
    z = safe_normalize(torch.cross(x, poses[..., 3:6], dim=-1), eps=_EPS)
    y = torch.cross(z, x, dim=-1)
    return torch.stack([x, y, z], -1)


def matrix_to_ortho6d(m: torch.Tensor) -> torch.Tensor:
    """Matrix -> its first two columns, flattened (..., 6)."""
    return torch.cat([m[..., :, 0], m[..., :, 1]], -1)


def _axis_rotation(axis: str, a: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(a), torch.sin(a)
    z, o = torch.zeros_like(a), torch.ones_like(a)
    rows = {"x": ((o, z, z), (z, c, -s), (z, s, c)),
            "y": ((c, z, s), (z, o, z), (-s, z, c)),
            "z": ((c, -s, z), (s, c, z), (z, z, o))}[axis]
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def euler_to_matrix(angles: torch.Tensor, order: str = "xyz") -> torch.Tensor:
    """Intrinsic Euler angles (..., 3), radians -> matrix, the product of
    the axis rotations in `order`."""
    m = _axis_rotation(order[0], angles[..., 0])
    for i, ax in enumerate(order[1:], start=1):
        m = m @ _axis_rotation(ax, angles[..., i])
    return m


def random_rotation(generator: torch.Generator | None = None,
                    shape: tuple = (),
                    normals: torch.Tensor | None = None) -> torch.Tensor:
    """Uniform random rotations (*shape, 3, 3) from normalised Gaussian
    quaternions, drawn from `generator` on its device, or from `normals`
    (*shape, 4) when given (the JAX package's jax.random.normal draws,
    say)."""
    if normals is None:
        normals = torch.randn(tuple(shape) + (4,), generator=generator,
                              device=generator.device if generator else None)
    return quat_to_matrix(quat_normalize(normals))


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
