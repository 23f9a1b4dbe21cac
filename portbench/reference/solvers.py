"""Plain float32 PnP-RANSAC: EPnP hypotheses on minimal subsets (axis
control points, inverse iteration for the null space, Gauss-Newton on the
betas, Kabsch for the pose), inlier scoring of every hypothesis against
every point, and Levenberg-Marquardt from the best `refine_top_k`
hypotheses ranked by a Cauchy cost. The subsets are given, [B, H, 6]."""

from __future__ import annotations

import numpy as np
import torch

_EPS = 1e-9
_PAIRS = np.array([(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)])


# ---------------------------------------------------------------- geometry

def skew(v):
    z = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([z, -v[..., 2], v[..., 1]], -1),
        torch.stack([v[..., 2], z, -v[..., 0]], -1),
        torch.stack([-v[..., 1], v[..., 0], z], -1)], dim=-2)


def quat_normalize(q):
    sq = torch.sum(q * q, dim=-1, keepdim=True)
    q = q / torch.sqrt(torch.clamp(sq, min=1e-16))
    return torch.where(q[..., :1] < 0, -q, q)


def matrix_to_quat(m):
    """Shepperd's method without branches: the candidate of the largest
    pivot."""
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
    cands = torch.stack([qw, qx, qy, qz], dim=-2)
    idx = best[..., None, None].expand(*best.shape, 1, 4)
    return quat_normalize(torch.gather(cands, -2, idx)[..., 0, :])


def axis_angle_to_matrix(v):
    """Rodrigues, first order below angle^2 = 1e-12."""
    angle_sq = torch.sum(v * v, dim=-1, keepdim=True)
    small = angle_sq < 1e-12
    angle = torch.sqrt(torch.where(small, torch.ones_like(angle_sq),
                                   angle_sq))
    k = skew(v / angle)
    s, c = torch.sin(angle)[..., None], torch.cos(angle)[..., None]
    eye = torch.eye(3, dtype=v.dtype, device=v.device).expand(k.shape)
    return torch.where(small[..., None], eye + skew(v),
                       eye + s * k + (1 - c) * (k @ k))


def matrix_to_axis_angle(m):
    q = matrix_to_quat(m)
    w = torch.clamp(q[..., 0], -1.0, 1.0)
    n = torch.linalg.norm(q[..., 1:], dim=-1)
    angle = 2.0 * torch.atan2(n, w)
    scale = torch.where(n < 1e-8, torch.full_like(n, 2.0),
                        angle / torch.clamp(n, min=1e-8))
    return q[..., 1:] * scale[..., None]


def project_points(points, k):
    z = torch.clamp(points[..., 2:3], min=1e-8)
    uv1 = points / z
    fx, fy = k[..., 0, 0, None], k[..., 1, 1, None]
    cx, cy = k[..., 0, 2, None], k[..., 1, 2, None]
    return torch.stack([uv1[..., 0] * fx + cx, uv1[..., 1] * fy + cy], -1)


def kabsch(src, dst, weights):
    """(R, t) of the weighted least-squares fit dst ~ R src + t."""
    w = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-8)
    mu_s = (w[..., None] * src).sum(-2)
    mu_d = (w[..., None] * dst).sum(-2)
    cov = ((w[..., :, None] * (dst - mu_d[..., None, :])).transpose(-1, -2)
           @ (src - mu_s[..., None, :]))
    u, _, vt = torch.linalg.svd(cov)
    det = torch.linalg.det(u @ vt)
    d = torch.cat([torch.ones(det.shape + (2,), dtype=src.dtype,
                              device=src.device), det[..., None]], -1)
    r = (u * d[..., None, :]) @ vt
    return r, mu_d - (r @ mu_s[..., None])[..., 0]


# -------------------------------------------------------------------- EPnP

def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _control_points(pw):
    c = pw.mean(-2)
    s = torch.clamp(pw.std(-2, correction=0), min=1e-6)
    return torch.cat([c[..., None, :], c[..., None, :] + torch.diag_embed(s)],
                     -2)


def _barycentric(pw, ctrl):
    ones4 = torch.ones(ctrl.shape[:-2] + (1, 4), dtype=pw.dtype,
                       device=pw.device)
    onesn = torch.ones(pw.shape[:-2] + (1, pw.shape[-2]), dtype=pw.dtype,
                       device=pw.device)
    ct = torch.cat([ctrl.transpose(-1, -2), ones4], -2)
    rhs = torch.cat([pw.transpose(-1, -2), onesn], -2)
    return torch.linalg.solve(ct + _EPS * _eye(4, pw), rhs).transpose(-1, -2)


def _build_mtm(alpha, uv, k):
    fx, fy = k[..., 0, 0, None, None], k[..., 1, 1, None, None]
    cx, cy = k[..., 0, 2, None], k[..., 1, 2, None]
    n = alpha.shape[-2]
    zeros = torch.zeros_like(alpha)
    du = (cx - uv[..., 0])[..., None] * alpha
    dv = (cy - uv[..., 1])[..., None] * alpha
    shape = alpha.shape[:-2] + (n, 12)
    row_u = torch.stack([fx * alpha, zeros, du], -1).reshape(shape)
    row_v = torch.stack([zeros, fy * alpha, dv], -1).reshape(shape)
    return (row_u.transpose(-1, -2) @ row_u + row_v.transpose(-1, -2) @ row_v)


def _gram_schmidt(q):
    cols = []
    for i in range(q.shape[-1]):
        v = q[..., i]
        for u in cols:
            v = v - torch.sum(u * v, -1, keepdim=True) * u
        cols.append(v / torch.clamp(torch.linalg.norm(v, dim=-1,
                                                      keepdim=True),
                                    min=1e-12))
    return torch.stack(cols, -1)


def _smallest_eigvecs(mtm, k=4, iters=2):
    n = mtm.shape[-1]
    tr = torch.diagonal(mtm, dim1=-2, dim2=-1).sum(-1)
    eps = 1e-6 * (tr / n + 1e-12)
    chol = torch.linalg.cholesky(mtm + eps[..., None, None] * _eye(n, mtm))
    q = (_eye(n, mtm)[:, :k] + 0.01).expand(mtm.shape[:-2] + (n, k))
    for _ in range(iters):
        q = _gram_schmidt(torch.cholesky_solve(q, chol))
    ray = torch.sum(q * (mtm @ q), -2)
    order = torch.argsort(ray, dim=-1, stable=True)
    return torch.gather(q, -1, order[..., None, :].expand(q.shape))


def epnp(pw, uv, k):
    """Hypothesis-grade EPnP (beta case 1): (R [..., 3, 3], t [..., 3])."""
    w = torch.ones(pw.shape[:-1], dtype=pw.dtype, device=pw.device)
    ctrl = _control_points(pw)
    alpha = _barycentric(pw, ctrl)
    q = _smallest_eigvecs(_build_mtm(alpha, uv, k))
    vk = q.transpose(-1, -2).reshape(q.shape[:-2] + (4, 4, 3))
    d = ctrl[..., _PAIRS[:, 0], :] - ctrl[..., _PAIRS[:, 1], :]
    rho = torch.sum(d * d, -1)
    dv = vk[..., :, _PAIRS[:, 0], :] - vk[..., :, _PAIRS[:, 1], :]
    d1 = torch.sum(dv[..., 0, :, :] ** 2, -1)
    b1 = torch.sqrt(torch.clamp(torch.sum(rho * d1, -1) / torch.clamp(
        torch.sum(d1 * d1, -1), min=_EPS), min=_EPS))
    zeros = torch.zeros_like(b1)
    betas = torch.stack([b1, zeros, zeros, zeros], -1)
    for _ in range(3):
        x = torch.einsum("...k,...kpc->...pc", betas, dv)
        r = torch.sum(x * x, -1) - rho
        j = 2.0 * torch.einsum("...pc,...kpc->...pk", x, dv)
        jtj = j.transpose(-1, -2) @ j + 1e-9 * _eye(4, j)
        betas = betas - torch.linalg.solve(
            jtj, j.transpose(-1, -2) @ r[..., None])[..., 0]
    pc = alpha @ torch.einsum("...k,...kcj->...cj", betas, vk)
    depth = (w * pc[..., 2]).sum(-1) / torch.clamp(w.sum(-1), min=_EPS)
    return kabsch(pw, pc * torch.sign(depth)[..., None, None], w)


# ---------------------------------------------------------------------- LM

def residuals(pose6, pw, uv, k):
    r = axis_angle_to_matrix(pose6[..., :3])
    pc = pw @ r.transpose(-1, -2) + pose6[..., None, 3:]
    res = project_points(pc, k) - uv
    return res.reshape(res.shape[:-2] + (-1,))


def _jacobian(pose6, pw, k):
    """d residuals / d pose6 [..., 2n, 6] (Gallego & Yezzi's derivative of
    the rotation vector, the pinhole derivative)."""
    v = pose6[..., :3]
    r = axis_angle_to_matrix(v)
    q = pw @ r.transpose(-1, -2)
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
                        torch.stack(cols, -1))
    z = pc[..., 2]
    zc = torch.clamp(z, min=1e-8)
    live = (z > 1e-8).to(pw.dtype)
    fx, fy = k[..., 0, 0, None], k[..., 1, 1, None]
    zero = torch.zeros_like(zc)
    du = torch.stack([fx / zc, zero, -fx * pc[..., 0] / (zc * zc) * live], -1)
    dv = torch.stack([zero, fy / zc, -fy * pc[..., 1] / (zc * zc) * live], -1)
    ju = torch.cat([(du[..., None, :] @ d_rot)[..., 0, :], du], -1)
    jv = torch.cat([(dv[..., None, :] @ d_rot)[..., 0, :], dv], -1)
    jac = torch.stack([ju, jv], -2)
    return jac.reshape(jac.shape[:-3] + (-1, 6))


def refine_lm(pose, pw, uv, k, weights, iters):
    """Damped Gauss-Newton on the weighted reprojection error."""
    w2 = torch.repeat_interleave(weights, 2, dim=-1)
    eye = torch.eye(6, dtype=pw.dtype, device=pw.device)
    lam = torch.full(pose.shape[:-1], 1e-3, dtype=pw.dtype, device=pw.device)
    for _ in range(iters):
        res = residuals(pose, pw, uv, k)
        jac = _jacobian(pose, pw, k)
        jt = jac.transpose(-1, -2)
        jtj = jt @ (w2[..., :, None] * jac)
        g = (jt @ (w2 * res)[..., None])[..., 0]
        damp = lam[..., None, None] * torch.diag_embed(
            torch.diagonal(jtj, dim1=-2, dim2=-1))
        new = pose - torch.linalg.solve(jtj + damp + 1e-12 * eye, g)
        new_res = residuals(new, pw, uv, k)
        better = (torch.sum(w2 * new_res * new_res, -1)
                  < torch.sum(w2 * res * res, -1))
        pose = torch.where(better[..., None], new, pose)
        lam = torch.where(better, torch.clamp(lam * 0.3, min=1e-8),
                          torch.clamp(lam * 3.0, max=1e6))
    return pose


# ------------------------------------------------------------ PnP-RANSAC

def _take(x, idx):
    flat = idx.reshape(idx.shape[0], -1)
    out = torch.gather(x, 1, flat[..., None].expand(-1, -1, x.shape[-1]))
    return out.reshape(idx.shape + (x.shape[-1],))


def _pick(x, idx):
    return x[torch.arange(x.shape[0], device=x.device), idx]


def pnp_ransac(pw, uv, k, subset_ids, inlier_px=2.0, refine_iters=5,
               robust=True, top_k=4, sample_size=6):
    """pw [B, n, 3], uv [B, n, 2], k [B, 3, 3], subset_ids [B, H, 6] ->
    dict of r [B, 3, 3], t [B, 3], num_inliers [B]."""
    b, n, _ = pw.shape
    mask = torch.ones((b, n), dtype=pw.dtype, device=pw.device)
    h = subset_ids.shape[1]
    rs, ts = epnp(_take(pw, subset_ids), _take(uv, subset_ids),
                  k[:, None].expand(b, h, 3, 3))
    pc = torch.einsum("bhij,bnj->bhni", rs, pw) + ts[:, :, None, :]
    z = torch.clamp(pc[..., 2], min=1e-8)
    kk = k[:, None, None]
    err = torch.sqrt((pc[..., 0] / z * kk[..., 0, 0] + kk[..., 0, 2]
                      - uv[:, None, :, 0]) ** 2
                     + (pc[..., 1] / z * kk[..., 1, 1] + kk[..., 1, 2]
                        - uv[:, None, :, 1]) ** 2)
    inl = (err < inlier_px) & (mask[:, None] > 0) & (pc[..., 2] > 0)
    scores = inl.sum(-1)

    def weights_for(idx):
        if robust:
            w = mask / (1.0 + (_pick(err, idx) / inlier_px) ** 2)
        else:
            w = _pick(inl, idx).to(pw.dtype)
        return torch.where((_pick(scores, idx) >= sample_size)[:, None], w,
                           mask)

    def pose0(idx):
        return torch.cat([matrix_to_axis_angle(_pick(rs, idx)),
                          _pick(ts, idx)], -1)

    if top_k <= 1:
        best = torch.argmax(scores, dim=-1)
        pose = refine_lm(pose0(best), pw, uv, k, weights_for(best),
                         refine_iters)
    else:
        top = torch.sort(scores, dim=-1, descending=True,
                         stable=True).indices[:, :top_k]
        p0 = torch.stack([pose0(top[:, j]) for j in range(top_k)], 1)
        w0 = torch.stack([weights_for(top[:, j]) for j in range(top_k)], 1)
        ex = lambda t: t[:, None].expand(t.shape[:1] + (top_k,) + t.shape[1:])
        poses = refine_lm(p0, ex(pw), ex(uv), ex(k), w0, refine_iters)
        res = residuals(poses, ex(pw), ex(uv), ex(k))
        res = res.reshape(res.shape[:-1] + (-1, 2))
        rho = torch.log1p(torch.sum(res * res, -1) / (inlier_px * inlier_px))
        pose = _pick(poses, torch.argmin((mask[:, None] * rho).sum(-1),
                                         dim=-1))
    res = residuals(pose, pw, uv, k).reshape(b, n, 2)
    final = (torch.linalg.norm(res, dim=-1) < inlier_px) & (mask > 0)
    return {"r": axis_angle_to_matrix(pose[:, :3]), "t": pose[:, 3:],
            "num_inliers": final.sum(-1)}


def rotation_deg(r1, r2):
    """Angle in degrees between rotation matrices [..., 3, 3], from their
    chordal distance |R1 - R2|_F = 2 sqrt(2) sin(angle / 2), which an
    fp32 rounding moves by an ulp and not, as arccos of the trace near 1,
    by hundredths of a degree."""
    chord = torch.linalg.matrix_norm(r1.double() - r2.double())
    return torch.rad2deg(2 * torch.arcsin(torch.clamp(
        chord / (2 * 2 ** 0.5), max=1.0))).float()
