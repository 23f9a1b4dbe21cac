"""PnP-RANSAC (counterpart of core/solvers/pnp.py:pnp_ransac), batched over
[B, ...] where the JAX package vmaps one instance.

Hypotheses: EPnP on H minimal subsets of distinct points; scoring:
reprojection inliers over all points; refinement: LM on the winner (or the
refine_top_k best, ranked by a common Cauchy cost). The subsets come from a
torch.Generator (the JAX package uses jax.random, which torch cannot
reproduce) or are injected as `subset_ids` [B, H, sample_size]; under a
process group both are the global batch's, of which each rank takes its
rows.
"""

from __future__ import annotations

import torch

from pose_estimation_tpu_torch.core.geometry.rotations import (
    axis_angle_to_matrix, matrix_to_axis_angle)
from pose_estimation_tpu_torch.core.solvers.epnp import epnp_fast
from pose_estimation_tpu_torch.core.solvers.lm import (
    refine_pose_lm, reprojection_residuals)
from pose_estimation_tpu_torch.parallel import dist


def minimal_subsets(generator, mask: torch.Tensor, num: int,
                    num_subsets: int) -> torch.Tensor:
    """[B, num_subsets, num] duplicate-free subsets of the valid points:
    one random permutation of the valid points per instance, subset h the
    window [h*num, h*num + num) modulo n_valid while it fits, a random
    window start after that (the JAX sampler's algorithm). Under a
    process group the random numbers are drawn at the global batch's
    shape and each rank takes its rows (dist.draw_rows)."""
    b, n = mask.shape
    dev = mask.device
    g = dist.draw_rows(lambda shape: torch.rand(
        shape, generator=generator, device=dev), (b, n))
    valid = mask > 0
    perm = torch.argsort(torch.where(valid, g, torch.full_like(g, float("inf"))),
                         dim=-1, stable=True)
    n_valid = torch.clamp(valid.sum(-1), min=num)                 # [B]
    seq = torch.arange(num_subsets, device=dev) * num
    rand = dist.draw_rows(lambda shape: torch.randint(
        0, 2 ** 31 - 1, shape, generator=generator, device=dev),
        (b, num_subsets)) % n_valid[:, None]
    starts = torch.where(seq + num <= n_valid[:, None], seq, rand)
    pos = (starts[..., None] + torch.arange(num, device=dev)) % n_valid[
        :, None, None]
    return torch.gather(perm, 1, pos.reshape(b, -1)).reshape(
        b, num_subsets, num)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, n, c], idx [B, ...] -> [B, ..., c]."""
    flat = idx.reshape(idx.shape[0], -1)
    out = torch.gather(x, 1, flat[..., None].expand(-1, -1, x.shape[-1]))
    return out.reshape(idx.shape + (x.shape[-1],))


def _pick(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, H, ...], idx [B] -> [B, ...]."""
    return x[torch.arange(x.shape[0], device=x.device), idx]


def pnp_ransac(pw: torch.Tensor, uv: torch.Tensor, k: torch.Tensor,
               mask: torch.Tensor | None = None, generator=None,
               subset_ids: torch.Tensor | None = None,
               num_hypotheses: int = 64, sample_size: int = 6,
               inlier_px: float = 2.0, refine_iters: int = 5,
               robust_refine: bool = False, refine_top_k: int = 1):
    """pw [B, n, 3], uv [B, n, 2], k [B, 3, 3], mask [B, n] -> dict of
    r [B, 3, 3], t [B, 3], pose6 [B, 6], inliers [B, n], mean_err [B],
    num_inliers [B]. An injected `subset_ids` is [B x world_size, H,
    sample_size], the global batch's."""
    b, n, _ = pw.shape
    if mask is None:
        mask = torch.ones((b, n), dtype=pw.dtype, device=pw.device)
    mask = mask.to(pw.dtype)
    if subset_ids is None:
        subset_ids = minimal_subsets(generator, mask, sample_size,
                                     num_hypotheses)
    else:
        subset_ids = dist.rank_rows(subset_ids)
    h = subset_ids.shape[1]
    kh = k[:, None].expand(b, h, 3, 3)
    rs, ts = epnp_fast(_take(pw, subset_ids), _take(uv, subset_ids), kh)

    # score every hypothesis against every point
    pc = torch.einsum("bhij,bnj->bhni", rs, pw) + ts[:, :, None, :]
    z = torch.clamp(pc[..., 2], min=1e-8)
    kk = k[:, None, None]
    proj_u = pc[..., 0] / z * kk[..., 0, 0] + kk[..., 0, 2]
    proj_v = pc[..., 1] / z * kk[..., 1, 1] + kk[..., 1, 2]
    err = torch.sqrt((proj_u - uv[:, None, :, 0]) ** 2
                     + (proj_v - uv[:, None, :, 1]) ** 2)
    inl = (err < inlier_px) & (mask[:, None] > 0) & (pc[..., 2] > 0)
    scores = inl.sum(-1)                                          # [B, H]

    def weights_for(idx):                                         # idx [B]
        if robust_refine:
            w_inl = mask / (1.0 + (_pick(err, idx) / inlier_px) ** 2)
        else:
            w_inl = _pick(inl, idx).to(pw.dtype)
        ok = _pick(scores, idx) >= sample_size
        return torch.where(ok[:, None], w_inl, mask)

    def pose0(idx):
        return torch.cat([matrix_to_axis_angle(_pick(rs, idx)),
                          _pick(ts, idx)], -1)

    if refine_top_k <= 1:
        best = torch.argmax(scores, dim=-1)
        pose, mse = refine_pose_lm(pose0(best), pw, uv, k, weights_for(best),
                                   iters=refine_iters)
    else:
        # top-k with ties to the lower index (lax.top_k): a stable sort
        top = torch.sort(scores, dim=-1, descending=True,
                         stable=True).indices[:, :refine_top_k]
        p0 = torch.stack([pose0(top[:, j]) for j in range(refine_top_k)], 1)
        w0 = torch.stack([weights_for(top[:, j])
                          for j in range(refine_top_k)], 1)
        ex = lambda t: t[:, None].expand(t.shape[:1] + (refine_top_k,)
                                         + t.shape[1:])
        poses, _ = refine_pose_lm(p0, ex(pw), ex(uv), ex(k), w0,
                                  iters=refine_iters)
        res = reprojection_residuals(poses, ex(pw), ex(uv), ex(k))
        res = res.reshape(res.shape[:-1] + (-1, 2))
        rho = torch.log1p(torch.sum(res * res, -1) / (inlier_px * inlier_px))
        costs = (mask[:, None] * rho).sum(-1)                     # [B, K]
        win = torch.argmin(costs, dim=-1)
        pose = _pick(poses, win)
        res = reprojection_residuals(pose, pw, uv, k).reshape(b, n, 2)
        w_win = weights_for(_pick(top, win))
        mse = (w_win * torch.sum(res * res, -1)).sum(-1) / torch.clamp(
            w_win.sum(-1), min=1e-12)

    res = reprojection_residuals(pose, pw, uv, k).reshape(b, n, 2)
    final_inl = (torch.linalg.norm(res, dim=-1) < inlier_px) & (mask > 0)
    return {
        "r": axis_angle_to_matrix(pose[:, :3]),
        "t": pose[:, 3:],
        "pose6": pose,
        "inliers": final_inl,
        "mean_err": mse,
        "num_inliers": final_inl.sum(-1),
    }


def _objective_grad(pose6, pw, uv, k, weights):
    """dE/dpose6 [B, 6] of E = 1/2 sum_i w_i |r_i|^2 per instance, with the
    graph kept for a second differentiation."""
    res = reprojection_residuals(pose6, pw, uv, k)
    res = res.reshape(res.shape[:-1] + (-1, 2))
    energy = 0.5 * torch.sum(weights[..., None] * res * res)
    return torch.autograd.grad(energy, pose6, create_graph=True)[0]


class _PnPImplicit(torch.autograd.Function):
    """The identity on pose6 forward; backward by the implicit function
    theorem at the stationary point g(pose; pw, uv, k) = dE/dpose = 0:
    v = (H^T)^-1 gbar with H = dg/dpose (the exact Hessian of E, + 1e-6 I),
    and the gradient to (pw, uv, k) is the VJP of g at -v. pose6 and the
    weights get none. Every instance's E depends on its own pose only, so
    the sums over the batch give each instance's derivatives; the Hessian
    is six reverse passes through the graph of g (double backward)."""

    @staticmethod
    def forward(ctx, pose6, pw, uv, k, weights):
        ctx.save_for_backward(pose6, pw, uv, k, weights)
        return pose6.clone()

    @staticmethod
    def backward(ctx, gbar):
        pose6, pw, uv, k, weights = ctx.saved_tensors
        want = ctx.needs_input_grad[1:4]
        with torch.enable_grad():
            p = pose6.detach().requires_grad_()
            xs = [t.detach().requires_grad_(w)
                  for t, w in zip((pw, uv, k), want)]
            g = _objective_grad(p, *xs, weights.detach())
            hess = torch.stack([torch.autograd.grad(
                g[..., i].sum(), p, retain_graph=True)[0]
                for i in range(6)], -2)                    # [B, 6, 6]
            hess = hess + 1e-6 * torch.eye(6, dtype=p.dtype, device=p.device)
            v = torch.linalg.solve(hess.transpose(-1, -2),
                                   gbar[..., None])[..., 0]
            live = [x for x, w in zip(xs, want) if w]
            got = iter(torch.autograd.grad(g, live, grad_outputs=-v)
                       if live else ())
        return (None, *(next(got) if w else None for w in want), None)


def pnp_implicit(pose6, pw, uv, k, weights):
    """pose6 [B, 6] (a solver's stationary point of the weighted
    reprojection error) returned as is, with gradients to pw [B, n, 3],
    uv [B, n, 2] and k [B, 3, 3] through the implicit function theorem
    (the JAX package's custom_vjp, vmapped over B). Use as

        pose6 = pnp_ransac(pw.detach(), ...)["pose6"]   # under no_grad
        pose6 = pnp_implicit(pose6, pw, uv, k, weights)
    """
    return _PnPImplicit.apply(pose6.detach(), pw, uv, k, weights.detach())
