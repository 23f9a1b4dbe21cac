"""Iterative closest point refinement (counterpart of core/solvers/icp.py):
fixed iterations of (nearest model point of each observed point ->
weighted Kabsch), the trimmed residual that scores a pose, and the gated
refinement the transparent eval runs.

The correspondences are kernel 4 (ops.pointops.nearest_multi, the
observed cloud as the targets, the moved model as the sources; its plain
version for CPU tensors): JAX's argmin(pairwise_sqdist(dst, moved)), the
same expanded squared distance, ties to the lower index, but computed in
the frame of the observed cloud's centroid. The JAX package searches in
the camera frame, where |t|^2 + |s|^2 - 2 t.s cancels at 0.6-1.1 m: there
a rounding of 1e-6 anywhere flips near-tied correspondences and trims
and moves a refined pose by ~0.01-0.07 mm (the card against the CPU:
0.07); centred, the same perturbation moves nothing. The fit is the
same; only the rounding differs. No gradient is taken through the
search.
"""

from __future__ import annotations

import torch

from pose_estimation_tpu_torch.core.geometry.rotations import (
    transform_points)
from pose_estimation_tpu_torch.core.geometry.umeyama import kabsch
from pose_estimation_tpu_torch.ops import pointops as _kops


def _trim_weights(nn_d: torch.Tensor, trim_fraction: float) -> torch.Tensor:
    """1 for the m - int(trim_fraction m) smallest of nn_d [B, m] (and
    their ties), else 0."""
    m = nn_d.shape[1]
    if trim_fraction <= 0.0:
        return torch.ones_like(nn_d)
    keep = m - int(trim_fraction * m)
    thresh = torch.sort(nn_d, dim=-1).values[:, keep - 1:keep]
    return (nn_d <= thresh).to(nn_d.dtype)


def _min_sqdist(dst: torch.Tensor, moved: torch.Tensor, idx: torch.Tensor):
    """min_j sqdist(dst_i, moved_j) [B, m] at the search's argmin, in the
    kernel's operation order (so the value it minimised, bit for bit)."""
    s = torch.gather(moved, 1, idx.long()[..., None].expand(-1, -1, 3))
    t0, t1, t2 = dst.unbind(-1)
    s0, s1, s2 = s.unbind(-1)
    return (((t0 * t0 + t1 * t1 + t2 * t2) + (s0 * s0 + s1 * s1 + s2 * s2))
            - 2.0 * (t0 * s0 + t1 * s1 + t2 * s2))


def icp_refine(src: torch.Tensor, dst: torch.Tensor, r0: torch.Tensor,
               t0: torch.Tensor, iters: int = 10, trim_fraction: float = 0.0):
    """Refine (r0, t0) so that r @ src + t aligns to dst. src [B, N, 3]
    (the model), dst [B, M, 3] (the observed, partial cloud), r0
    [B, 3, 3], t0 [B, 3]. Each observed point is matched to its nearest
    model point (dst -> src: safe when the view is partial); with
    trim_fraction > 0 the worst correspondences of each iteration get
    weight 0. Returns (r, t, the last iteration's weighted mean residual
    [B])."""
    # in the frame of dst's centroid, where the expanded squared distance
    # does not cancel: at 0.6-1.1 m from the camera a rounding of 1e-6
    # elsewhere flips near-tied correspondences and trims and moves the
    # refined pose by ~0.01 mm; the fit is the same, translated back
    c = dst.mean(-2)
    dst = (dst - c[..., None, :]).contiguous()
    r, t = r0, t0 - c
    res = None
    for _ in range(iters):
        moved = transform_points(src, r, t).contiguous()
        _, idx = _kops.nearest(dst, moved)
        corr = torch.gather(src, 1, idx.long()[..., None].expand(-1, -1, 3))
        w = (_trim_weights(_min_sqdist(dst, moved, idx), trim_fraction)
             .to(src.dtype))
        r, t = kabsch(corr, dst, weights=w)
        err = torch.linalg.norm(transform_points(corr, r, t) - dst, dim=-1)
        res = (w * err).sum(-1) / torch.clamp(w.sum(-1), min=1.0)
    return r, t + c, res


def trimmed_residuals(src: torch.Tensor, dst: torch.Tensor, poses,
                      trim_fraction: float = 0.0) -> list:
    """The trimmed dst -> src nearest-neighbour residual [B] of each
    (r, t) in `poses`, icp_refine's objective at a given pose with fresh
    correspondences; the poses' moved models are the source clouds of one
    nearest_multi launch. The distance is the kernel's with eps = 0:
    sqrt(max(min d, 0))."""
    c = dst.mean(-2)                         # as icp_refine, centred
    dst = (dst - c[..., None, :]).contiguous()
    moved = [transform_points(src, r, t - c).contiguous() for r, t in poses]
    out = []
    for nn_d, _ in _kops.nearest_multi(dst, moved, eps=0.0):
        w = _trim_weights(nn_d, trim_fraction).to(src.dtype)
        out.append((w * nn_d).sum(-1) / torch.clamp(w.sum(-1), min=1.0))
    return out


def trimmed_residual(src, dst, r, t, trim_fraction: float = 0.0):
    """trimmed_residuals of one pose: [B]."""
    return trimmed_residuals(src, dst, [(r, t)], trim_fraction)[0]


def gated_icp_refine(src: torch.Tensor, dst: torch.Tensor, r0: torch.Tensor,
                     t0: torch.Tensor, iters: int = 10,
                     trim_fraction: float = 0.0, accept_margin: float = 0.15,
                     max_rot_deg: float = 10.0, max_trans: float = 0.02):
    """icp_refine with the JAX package's accept gate: the refined pose is
    kept only where it cuts the trimmed residual by more than
    `accept_margin` (relative) AND stays within the trust region of the
    initial pose (rotation change < max_rot_deg, translation change <
    max_trans metres); the gate's rationale is in the JAX docstring.
    Returns (r_out, t_out, accepted [B] bool, refined residual [B])."""
    r_ref, t_ref, resid = icp_refine(src, dst, r0, t0, iters, trim_fraction)
    # the two scores share dst: one launch with both moved models
    res_dir, res_ref = trimmed_residuals(src, dst, [(r0, t0), (r_ref, t_ref)],
                                         trim_fraction)
    improves = res_ref < (1.0 - accept_margin) * res_dir
    tr = torch.diagonal(r0.transpose(-1, -2) @ r_ref, dim1=-2,
                        dim2=-1).sum(-1)
    cos = torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0)
    rot_change = torch.rad2deg(torch.acos(cos))
    t_change = torch.linalg.norm(t_ref - t0, dim=-1)
    accept = improves & (rot_change < max_rot_deg) & (t_change < max_trans)
    r_out = torch.where(accept[:, None, None], r_ref, r0)
    t_out = torch.where(accept[:, None], t_ref, t0)
    return r_out, t_out, accept, resid
