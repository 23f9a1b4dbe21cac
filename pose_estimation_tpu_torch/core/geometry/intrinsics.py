"""Camera intrinsics, back-projection and projection (counterpart of
core/geometry/intrinsics.py), batched over leading dims."""

from __future__ import annotations

import torch


def intrinsic_vec_to_matrix(k_vec: torch.Tensor) -> torch.Tensor:
    """[..., 4] (fx, fy, cx, cy) -> [..., 3, 3] K."""
    fx, fy, cx, cy = k_vec.unbind(-1)
    z, o = torch.zeros_like(fx), torch.ones_like(fx)
    return torch.stack([torch.stack([fx, z, cx], -1),
                        torch.stack([z, fy, cy], -1),
                        torch.stack([z, z, o], -1)], -2)


def intrinsic_matrix_to_vec(k: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] K -> [..., 4] (fx, fy, cx, cy)."""
    return torch.stack([k[..., 0, 0], k[..., 1, 1], k[..., 0, 2],
                        k[..., 1, 2]], -1)


def uvd_to_cloud(uvd: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Pixel (u, v) and depth d [..., N, 3] -> camera XYZ [..., N, 3];
    k [..., 3, 3] or [3, 3] (broadcast)."""
    fx, fy = k[..., 0, 0, None], k[..., 1, 1, None]
    cx, cy = k[..., 0, 2, None], k[..., 1, 2, None]
    x = (uvd[..., 0] - cx) * uvd[..., 2] / fx
    y = (uvd[..., 1] - cy) * uvd[..., 2] / fy
    return torch.stack([x, y, uvd[..., 2]], -1)


def depth_map_to_cloud(depth: torch.Tensor, k: torch.Tensor, u0=0.0,
                       v0=0.0) -> torch.Tensor:
    """Back-project a depth map [..., H, W] to [..., H, W, 3]; (u0, v0) is
    the map's top-left pixel in the full image (for crops)."""
    h, w = depth.shape[-2:]
    dev = depth.device
    vmap = (torch.arange(h, dtype=torch.float32, device=dev)[:, None]
            .expand(h, w) + v0)
    umap = (torch.arange(w, dtype=torch.float32, device=dev)[None, :]
            .expand(h, w) + u0)
    fx, fy = k[..., 0, 0, None, None], k[..., 1, 1, None, None]
    cx, cy = k[..., 0, 2, None, None], k[..., 1, 2, None, None]
    x = (umap - cx) * depth / fx
    y = (vmap - cy) * depth / fy
    return torch.stack([x, y, depth], -1)


def project_points(points: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Camera XYZ [..., N, 3] -> pixel UV [..., N, 2]; k [..., 3, 3]."""
    z = torch.clamp(points[..., 2:3], min=1e-8)
    uv1 = points / z
    fx, fy = k[..., 0, 0, None], k[..., 1, 1, None]
    cx, cy = k[..., 0, 2, None], k[..., 1, 2, None]
    return torch.stack([uv1[..., 0] * fx + cx, uv1[..., 1] * fy + cy], -1)


def crop_intrinsics(k: torch.Tensor, u0, v0, scale=1.0) -> torch.Tensor:
    """K of a crop whose top-left corner is (u0, v0), then resized by
    `scale` (a number or a [...] tensor)."""
    k = torch.as_tensor(k, dtype=torch.float32).clone()
    k[..., 0, 2] -= torch.as_tensor(u0, dtype=torch.float32, device=k.device)
    k[..., 1, 2] -= torch.as_tensor(v0, dtype=torch.float32, device=k.device)
    s = torch.as_tensor(scale, dtype=torch.float32, device=k.device)
    return torch.cat([k[..., :2, :] * (s[..., None, None] if s.ndim else s),
                      k[..., 2:, :]], -2)
