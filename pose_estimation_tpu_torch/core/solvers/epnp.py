"""EPnP (counterpart of core/solvers/epnp.py), batched over any leading
dims.

epnp_fast, hypothesis-grade (the RANSAC hypotheses): beta case 1 only,
axis-aligned control points, two rounds of inverse iteration for the null
space, analytic Gauss-Newton on the betas, Kabsch for the pose. epnp, the
full solver (Lepetit et al., IJCV'09): PCA control points, the null space
by eight rounds of block inverse iteration with QR (or eigh), beta cases
1 and 2 each refined by eight Gauss-Newton steps, the one with the lower
reprojection error kept. Solvers run in fp32 whatever the model's dtype.
"""

from __future__ import annotations

import numpy as np
import torch

from pose_estimation_tpu_torch.core.geometry.intrinsics import project_points
from pose_estimation_tpu_torch.core.geometry.umeyama import kabsch

_EPS = 1e-9
_PAIRS = np.array([(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)])


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _control_points_fast(pw: torch.Tensor) -> torch.Tensor:
    """Centroid + per-axis std (ddof 0, as jnp.std) -> [..., 4, 3]."""
    c = pw.mean(-2)
    s = torch.clamp(pw.std(-2, correction=0), min=1e-6)
    return torch.cat([c[..., None, :], c[..., None, :] + torch.diag_embed(s)],
                     -2)


def _control_points(pw: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Weighted centroid + principal axes scaled by the square root of
    their eigenvalues -> [..., 4, 3]."""
    wsum = torch.clamp(w.sum(-1), min=_EPS)
    c = (w[..., None] * pw).sum(-2) / wsum[..., None]
    centered = (pw - c[..., None, :]) * torch.sqrt(w)[..., None]
    cov = centered.transpose(-1, -2) @ centered / wsum[..., None, None]
    # the 3x3 eigh on the host: its eigenvectors' signs pick the control
    # points, which move a noisy solution (0.08 degree median on
    # tools/parity_check.py's scenes), and the card's eigh picks other
    # signs than LAPACK's, which the CPU and the JAX package share
    eigval, eigvec = (x.to(pw.device) for x in torch.linalg.eigh(cov.cpu()))
    axes = eigvec.transpose(-1, -2) * torch.sqrt(
        torch.clamp(eigval, min=1e-12))[..., :, None]
    return torch.cat([c[..., None, :], c[..., None, :] + axes], -2)


def _barycentric(pw: torch.Tensor, ctrl: torch.Tensor) -> torch.Tensor:
    """alpha [..., n, 4] with pw = alpha @ ctrl and sum(alpha) = 1."""
    ones4 = torch.ones(ctrl.shape[:-2] + (1, 4), dtype=pw.dtype,
                       device=pw.device)
    onesn = torch.ones(pw.shape[:-2] + (1, pw.shape[-2]), dtype=pw.dtype,
                       device=pw.device)
    ct = torch.cat([ctrl.transpose(-1, -2), ones4], -2)
    rhs = torch.cat([pw.transpose(-1, -2), onesn], -2)
    alpha = torch.linalg.solve(ct + _EPS * _eye(4, pw), rhs)
    return alpha.transpose(-1, -2)


def _build_mtm(alpha, uv, k, w):
    """M^T M [..., 12, 12] of the projection equations."""
    fx, fy = k[..., 0, 0, None, None], k[..., 1, 1, None, None]
    cx, cy = k[..., 0, 2, None], k[..., 1, 2, None]
    n = alpha.shape[-2]
    zeros = torch.zeros_like(alpha)
    du = (cx - uv[..., 0])[..., None] * alpha
    dv = (cy - uv[..., 1])[..., None] * alpha
    shape = alpha.shape[:-2] + (n, 12)
    row_u = torch.stack([fx * alpha, zeros, du], -1).reshape(shape)
    row_v = torch.stack([zeros, fy * alpha, dv], -1).reshape(shape)
    wc = w[..., :, None]
    return ((wc * row_u).transpose(-1, -2) @ row_u
            + (wc * row_v).transpose(-1, -2) @ row_v)


def _rho(ctrl_w):
    d = ctrl_w[..., _PAIRS[:, 0], :] - ctrl_w[..., _PAIRS[:, 1], :]
    return torch.sum(d * d, -1)


def _vk_pair_diffs(vk):
    """vk [..., 4 basis, 4 ctrl, 3] -> [..., 4, 6, 3]."""
    return vk[..., :, _PAIRS[:, 0], :] - vk[..., :, _PAIRS[:, 1], :]


def _betas_case1(dv, rho):
    d1 = torch.sum(dv[..., 0, :, :] ** 2, -1)                  # [..., 6]
    num = torch.sum(rho * d1, -1)
    den = torch.clamp(torch.sum(d1 * d1, -1), min=_EPS)
    b1 = torch.sqrt(torch.clamp(num / den, min=_EPS))
    zeros = torch.zeros_like(b1)
    return torch.stack([b1, zeros, zeros, zeros], -1)


def _betas_case2(dv, rho):
    """x = b1 v1 + b2 v2: least squares for (b11, b12, b22), then the
    signs (the minimum-norm solution, as jnp.linalg.lstsq's)."""
    d1, d2 = dv[..., 0, :, :], dv[..., 1, :, :]
    a = torch.stack([torch.sum(d1 * d1, -1), 2 * torch.sum(d1 * d2, -1),
                     torch.sum(d2 * d2, -1)], -1)               # [..., 6, 3]
    b11, b12, b22 = (torch.linalg.pinv(a) @ rho[..., None])[..., 0].unbind(-1)
    b1 = torch.sqrt(torch.clamp(torch.abs(b11), min=_EPS))
    b2 = (torch.sqrt(torch.clamp(torch.abs(b22), min=_EPS))
          * torch.sign(b12) * torch.sign(b11))
    zeros = torch.zeros_like(b1)
    return torch.stack([b1, b2, zeros, zeros], -1)


def _smallest_eigvecs_inverse(mtm, k: int = 4, iters: int = 8):
    """k eigenvectors of the smallest eigenvalues of PSD [..., n, n] by
    block inverse iteration: one Cholesky factorisation, `iters` rounds of
    solve and QR, then sorted by Rayleigh quotient. Returns [..., n, k]."""
    n = mtm.shape[-1]
    tr = torch.diagonal(mtm, dim1=-2, dim2=-1).sum(-1)
    eps = 1e-6 * (tr / n + 1e-12)
    chol = torch.linalg.cholesky(mtm + eps[..., None, None] * _eye(n, mtm))
    q = (_eye(n, mtm)[:, :k] + 0.01).expand(mtm.shape[:-2] + (n, k))
    for _ in range(iters):
        q = torch.linalg.qr(torch.cholesky_solve(q, chol)).Q
    ray = torch.sum(q * (mtm @ q), -2)
    order = torch.argsort(ray, dim=-1, stable=True)
    return torch.gather(q, -1, order[..., None, :].expand(q.shape))


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


def _smallest_eigvecs_fast(mtm, k: int = 4, iters: int = 2):
    """k eigenvectors of the smallest eigenvalues of PSD [..., n, n]:
    Cholesky, `iters` inverse-iteration rounds with Gram-Schmidt, then
    sorted by Rayleigh quotient. Returns [..., n, k]."""
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


def _gauss_newton_betas(betas, dv, rho, iters: int = 3):
    """Gauss-Newton on the 6 control-distance residuals with the analytic
    Jacobian dr_p/db_k = 2 <x_p, dv_kp> (jax.jacfwd's, in the JAX full
    solver)."""
    for _ in range(iters):
        x = torch.einsum("...k,...kpc->...pc", betas, dv)     # [..., 6, 3]
        r = torch.sum(x * x, -1) - rho
        j = 2.0 * torch.einsum("...pc,...kpc->...pk", x, dv)  # [..., 6, 4]
        jtj = j.transpose(-1, -2) @ j + 1e-9 * _eye(4, j)
        betas = betas - torch.linalg.solve(
            jtj, j.transpose(-1, -2) @ r[..., None])[..., 0]
    return betas


def _pose_from_betas(betas, vk, alpha, pw, w):
    ctrl_cam = torch.einsum("...k,...kcj->...cj", betas, vk)   # [..., 4, 3]
    pc = alpha @ ctrl_cam
    depth = (w * pc[..., 2]).sum(-1) / torch.clamp(w.sum(-1), min=_EPS)
    pc = pc * torch.sign(depth)[..., None, None]
    return kabsch(pw, pc, weights=w)


def epnp_fast(pw: torch.Tensor, uv: torch.Tensor, k: torch.Tensor):
    """pw [..., n, 3], uv [..., n, 2], k [..., 3, 3] -> (R [..., 3, 3],
    t [..., 3])."""
    w = torch.ones(pw.shape[:-1], dtype=pw.dtype, device=pw.device)
    ctrl_w = _control_points_fast(pw)
    alpha = _barycentric(pw, ctrl_w)
    mtm = _build_mtm(alpha, uv, k, w)
    q = _smallest_eigvecs_fast(mtm, 4)
    vk = q.transpose(-1, -2).reshape(q.shape[:-2] + (4, 4, 3))
    rho = _rho(ctrl_w)
    dv = _vk_pair_diffs(vk)
    betas = _gauss_newton_betas(_betas_case1(dv, rho), dv, rho)
    return _pose_from_betas(betas, vk, alpha, pw, w)


def epnp(pw: torch.Tensor, uv: torch.Tensor, k: torch.Tensor,
         weights: torch.Tensor | None = None, null_basis: str = "iterative"):
    """The full EPnP. pw [..., n, 3] world points, uv [..., n, 2] pixels,
    k [..., 3, 3], weights [..., n] (optional mask); null_basis
    "iterative" (block inverse iteration) or "eigh". Returns (R [..., 3,
    3], t [..., 3])."""
    n = pw.shape[-2]
    w = (torch.ones(pw.shape[:-1], dtype=pw.dtype, device=pw.device)
         if weights is None else weights.to(pw.dtype))
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=_EPS) * n
    ctrl_w = _control_points(pw, w)
    alpha = _barycentric(pw, ctrl_w)
    mtm = _build_mtm(alpha, uv, k, w)
    if null_basis == "iterative":
        q = _smallest_eigvecs_inverse(mtm, 4)
    else:
        q = torch.linalg.eigh(mtm).eigenvectors[..., :4]
    vk = q.transpose(-1, -2).reshape(q.shape[:-2] + (4, 4, 3))
    rho = _rho(ctrl_w)
    dv = _vk_pair_diffs(vk)
    poses = [_pose_from_betas(_gauss_newton_betas(b0, dv, rho, iters=8),
                              vk, alpha, pw, w)
             for b0 in (_betas_case1(dv, rho), _betas_case2(dv, rho))]
    (r1, t1), (r2, t2) = poses
    e1, e2 = ((w * torch.sum((project_points(
        pw @ r.transpose(-1, -2) + t[..., None, :], k) - uv) ** 2, -1)
               ).sum(-1) for r, t in poses)
    first = torch.argmin(torch.stack([e1, e2], -1), dim=-1) == 0
    return (torch.where(first[..., None, None], r1, r2),
            torch.where(first[..., None], t1, t2))
