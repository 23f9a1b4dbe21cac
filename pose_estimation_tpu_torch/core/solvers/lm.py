"""Levenberg-Marquardt pose refinement on reprojection residuals
(counterpart of core/solvers/lm.py), batched over leading dims.

The JAX package takes the Jacobian with jax.jacfwd; here it is written
out (the Rodrigues derivative of Gallego & Yezzi, JMIV 2015, and the
pinhole derivative), which needs no autodiff machinery on the card and
runs batched over any leading dims.
"""

from __future__ import annotations

import torch

from pose_estimation_tpu_torch.core.geometry.intrinsics import project_points
from pose_estimation_tpu_torch.core.geometry.rotations import (
    axis_angle_to_matrix, skew)

_EPS = 1e-12


def reprojection_residuals(pose6, pw, uv, k):
    """pose6 [..., 6] = (rvec, t) -> residuals [..., 2n]."""
    r = axis_angle_to_matrix(pose6[..., :3])
    pc = pw @ r.transpose(-1, -2) + pose6[..., None, 3:]
    res = project_points(pc, k) - uv
    return res.reshape(res.shape[:-2] + (-1,))


def _jacobian(pose6, pw, uv, k):
    """d residuals / d pose6 [..., 2n, 6], rows (u, v) per point like the
    residuals.

    d(R p)/dv_i = (v_i (v x Rp) + (v x (e_i - R e_i)) x Rp) / |v|^2, and
    -[p]_x on the first-order branch below |v|^2 = 1e-12 (the one
    axis_angle_to_matrix takes). The depth clamp at 1e-8 passes no
    gradient below it, as jnp.maximum's."""
    v = pose6[..., :3]
    r = axis_angle_to_matrix(v)
    q = pw @ r.transpose(-1, -2)                                # R p
    pc = q + pose6[..., None, 3:]
    theta2 = torch.sum(v * v, -1)
    small = theta2 < 1e-12
    theta2 = torch.where(small, torch.ones_like(theta2), theta2)
    vq = torch.cross(v[..., None, :].expand_as(q), q, dim=-1)
    eye = torch.eye(3, dtype=pw.dtype, device=pw.device)
    cols = []
    for i in range(3):
        w = torch.cross(v, eye[i] - r[..., :, i], dim=-1)
        wq = torch.cross(w[..., None, :].expand_as(q), q, dim=-1)
        cols.append((v[..., i, None, None] * vq + wq)
                    / theta2[..., None, None])
    d_rot = torch.where(small[..., None, None, None], -skew(pw),
                        torch.stack(cols, -1))                  # [..., n, 3, 3]
    z = pc[..., 2]
    zc = torch.clamp(z, min=1e-8)
    live = (z > 1e-8).to(pw.dtype)
    fx, fy = k[..., 0, 0, None], k[..., 1, 1, None]
    zero = torch.zeros_like(zc)
    du = torch.stack([fx / zc, zero, -fx * pc[..., 0] / (zc * zc) * live], -1)
    dv = torch.stack([zero, fy / zc, -fy * pc[..., 1] / (zc * zc) * live], -1)
    ju = torch.cat([(du[..., None, :] @ d_rot)[..., 0, :], du], -1)
    jv = torch.cat([(dv[..., None, :] @ d_rot)[..., 0, :], dv], -1)
    jac = torch.stack([ju, jv], -2)                             # [..., n, 2, 6]
    return jac.reshape(jac.shape[:-3] + (-1, 6))


def refine_pose_lm(pose6_init, pw, uv, k, weights, iters: int = 10):
    """Damped Gauss-Newton on the weighted reprojection error.

    pose6_init [..., 6]; pw [..., n, 3]; uv [..., n, 2]; k [..., 3, 3];
    weights [..., n]. Returns (pose6 [..., 6], weighted mean squared
    pixel error [...])."""
    w2 = torch.repeat_interleave(weights, 2, dim=-1)
    eye = torch.eye(6, dtype=pw.dtype, device=pw.device)

    def cost(p):
        res = reprojection_residuals(p, pw, uv, k)
        return torch.sum(w2 * res * res, -1)

    pose = pose6_init
    lam = torch.full(pose.shape[:-1], 1e-3, dtype=pw.dtype, device=pw.device)
    for _ in range(iters):
        res = reprojection_residuals(pose, pw, uv, k)
        jac = _jacobian(pose, pw, uv, k)
        jt = jac.transpose(-1, -2)
        jtj = jt @ (w2[..., :, None] * jac)
        g = (jt @ (w2 * res)[..., None])[..., 0]
        damp = lam[..., None, None] * torch.diag_embed(
            torch.diagonal(jtj, dim1=-2, dim2=-1))
        delta = torch.linalg.solve(jtj + damp + _EPS * eye, g)
        new_pose = pose - delta
        improved = cost(new_pose) < torch.sum(w2 * res * res, -1)
        pose = torch.where(improved[..., None], new_pose, pose)
        lam = torch.where(improved, torch.clamp(lam * 0.3, min=1e-8),
                          torch.clamp(lam * 3.0, max=1e6))
    res = reprojection_residuals(pose, pw, uv, k)
    res = res.reshape(res.shape[:-1] + (-1, 2))
    mse = (weights * torch.sum(res * res, -1)).sum(-1) / torch.clamp(
        weights.sum(-1), min=_EPS)
    return pose, mse
