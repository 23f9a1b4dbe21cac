"""Pinhole projection (counterpart of core/geometry/intrinsics.py)."""

from __future__ import annotations

import torch


def project_points(points: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Camera XYZ [..., N, 3] -> pixel UV [..., N, 2]; k [..., 3, 3]."""
    z = torch.clamp(points[..., 2:3], min=1e-8)
    uv1 = points / z
    fx, fy = k[..., 0, 0, None], k[..., 1, 1, None]
    cx, cy = k[..., 0, 2, None], k[..., 1, 2, None]
    return torch.stack([uv1[..., 0] * fx + cx, uv1[..., 1] * fy + cy], -1)
