"""Point-cloud neighbourhood ops (counterpart of core/pointops/neighbors.py).

Batched over leading dims, [..., N, 3] clouds. The two KNN searches
dispatch to the hand-written kernel in ops.pointops (its plain PyTorch
version for CPU tensors); the rest is plain PyTorch.
"""

from __future__ import annotations

import torch

from pose_estimation_tpu_torch.ops import pointops as _kops
from pose_estimation_tpu_torch.ops.pointops import (  # noqa: F401
    sqdist as pairwise_sqdist)


def knn_indices(vertices: torch.Tensor, k: int,
                exclude_self: bool = True) -> torch.Tensor:
    """K nearest neighbours within one cloud: [B, n, 3] -> [B, n, k] int32.
    The k+1 smallest distances with ties to the lower index, first
    dropped (gcn3d.get_neighbor_index semantics)."""
    return _kops.knn(vertices, vertices, k, exclude_self)


def knn_indices_cross(queries: torch.Tensor, keys: torch.Tensor, k: int,
                      exclude_self: bool = False) -> torch.Tensor:
    """K nearest `keys` for each query: [B, m, 3], [B, n, 3] -> [B, m, k]."""
    return _kops.knn(queries, keys, k, exclude_self)


def min_dists(target: torch.Tensor, source: torch.Tensor,
              eps: float = 1e-8) -> torch.Tensor:
    """Distance to the nearest source point [..., n1], sqrt clamped at
    eps^2 inside (grad-safe at coincident points)."""
    d = pairwise_sqdist(target, source)
    return torch.sqrt(torch.clamp(d.min(dim=-1).values, min=eps * eps))


def gather_neighbors(features: torch.Tensor,
                     index: torch.Tensor) -> torch.Tensor:
    """[B, n, c], [B, m, k] -> [B, m, k, c]."""
    b, m, k = index.shape
    flat = gather_rows(features, index.reshape(b, m * k))
    return flat.reshape(b, m, k, features.shape[-1])


def gather_rows(features: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """[B, n, c], [B, m] -> [B, m, c]."""
    idx = index.to(torch.int64)[..., None].expand(*index.shape,
                                                  features.shape[-1])
    return torch.gather(features, -2, idx)


def gather_neighbors_max(features: torch.Tensor,
                         index: torch.Tensor) -> torch.Tensor:
    """max_k features[index[:, m, k]]: [B, n, c], [B, m, k] -> [B, m, c]."""
    return gather_neighbors(features, index).amax(dim=-2)


def neighbor_directions(vertices: torch.Tensor, index: torch.Tensor,
                        eps: float = 1e-6) -> torch.Tensor:
    """Unit directions to the k neighbours [B, n, k, 3]; coincident points
    give 0. The where-trick keeps value and gradient finite there: the
    norm comes from a squared distance replaced by 1 where degenerate."""
    d = gather_neighbors(vertices, index) - vertices[..., :, None, :]
    sq = torch.sum(d * d, dim=-1, keepdim=True)
    degenerate = sq < eps * eps
    safe_n = torch.sqrt(torch.where(degenerate, torch.ones_like(sq), sq))
    return torch.where(degenerate, torch.zeros_like(d), d / safe_n)
