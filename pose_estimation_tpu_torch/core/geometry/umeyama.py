"""Weighted Kabsch alignment (counterpart of core/geometry/umeyama.py)."""

from __future__ import annotations

import torch


def kabsch(src: torch.Tensor, dst: torch.Tensor,
           weights: torch.Tensor | None = None):
    """Rigid least-squares fit dst ~ R @ src + t.

    src, dst [..., N, 3]; weights [..., N]. Returns (R [..., 3, 3],
    t [..., 3]). The sign ambiguity of the SVD cancels in U diag(1,1,det) V^T.
    """
    if weights is None:
        weights = torch.ones(src.shape[:-1], dtype=src.dtype,
                             device=src.device)
    w = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-8)
    mu_s = (w[..., None] * src).sum(-2)
    mu_d = (w[..., None] * dst).sum(-2)
    sc = src - mu_s[..., None, :]
    dc = dst - mu_d[..., None, :]
    cov = (w[..., :, None] * dc).transpose(-1, -2) @ sc       # [..., 3, 3]
    u, _, vt = torch.linalg.svd(cov)
    det = torch.linalg.det(u @ vt)
    d = torch.cat([torch.ones(det.shape + (2,), dtype=src.dtype,
                              device=src.device), det[..., None]], -1)
    r = (u * d[..., None, :]) @ vt
    t = mu_d - (r @ mu_s[..., None])[..., 0]
    return r, t
