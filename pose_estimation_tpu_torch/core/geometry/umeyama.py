"""Weighted Kabsch / Umeyama alignment and fixed-shape RANSAC similarity
alignment (counterpart of core/geometry/umeyama.py), batched over
leading dims."""

from __future__ import annotations

import torch


def _fit(src, dst, weights, with_scale: bool):
    """(R, t, scale) of the weighted fit; scale 1 without `with_scale`."""
    if weights is None:
        weights = torch.ones(src.shape[:-1], dtype=src.dtype,
                             device=src.device)
    w = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-8)
    mu_s = (w[..., None] * src).sum(-2)
    mu_d = (w[..., None] * dst).sum(-2)
    sc = src - mu_s[..., None, :]
    dc = dst - mu_d[..., None, :]
    cov = (w[..., :, None] * dc).transpose(-1, -2) @ sc       # [..., 3, 3]
    u, sv, vt = torch.linalg.svd(cov)
    det = torch.linalg.det(u @ vt)
    d = torch.cat([torch.ones(det.shape + (2,), dtype=src.dtype,
                              device=src.device), det[..., None]], -1)
    r = (u * d[..., None, :]) @ vt
    if with_scale:
        var_s = (w * (sc ** 2).sum(-1)).sum(-1)
        scale = (sv * d).sum(-1) / torch.clamp(var_s, min=1e-12)
    else:
        scale = torch.ones(det.shape, dtype=src.dtype, device=src.device)
    return r, mu_d - scale[..., None] * (r @ mu_s[..., None])[..., 0], scale


def kabsch(src: torch.Tensor, dst: torch.Tensor,
           weights: torch.Tensor | None = None, with_scale: bool = False):
    """Least-squares fit dst ~ scale * R @ src + t.

    src, dst [..., N, 3]; weights [..., N]. Returns (R [..., 3, 3],
    t [..., 3]), and with `with_scale` (Umeyama's similarity) (R, t,
    scale [...]). The sign ambiguity of the SVD cancels in
    U diag(1,1,det) V^T.
    """
    r, t, scale = _fit(src, dst, weights, with_scale)
    return (r, t, scale) if with_scale else (r, t)


def umeyama_ransac(generator: torch.Generator | None, src: torch.Tensor,
                   dst: torch.Tensor, num_hypotheses: int = 128, sample_size: int = 4,
                   inlier_thresh: float = 0.01, with_scale: bool = True,
                   hypotheses: torch.Tensor | None = None):
    """Fixed-shape RANSAC similarity alignment of src to dst [N, 3]: every
    hypothesis (`sample_size` indices drawn with replacement from
    `generator`, or `hypotheses` [num_hypotheses, sample_size] given) fit
    and scored at once, the best refit on its inliers (weights + 1e-6).
    Returns (R [3, 3], t [3], scale [], inlier mask [N])."""
    n = src.shape[0]
    if hypotheses is None:
        hypotheses = torch.randint(0, n, (num_hypotheses, sample_size),
                                   generator=generator, device=src.device)
    idx = hypotheses.to(device=src.device, dtype=torch.int64)
    rs, ts, ss = _fit(src[idx], dst[idx], None, with_scale)
    pred = (ss[:, None, None] * torch.einsum("hij,nj->hni", rs, src)
            + ts[:, None, :])
    inlier = torch.linalg.norm(pred - dst[None], dim=-1) < inlier_thresh
    best_inlier = inlier[torch.argmax(inlier.sum(-1))]
    r, t, s = _fit(src, dst, best_inlier.to(src.dtype) + 1e-6, with_scale)
    return r, t, s, best_inlier
