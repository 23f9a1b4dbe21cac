"""Point-cloud neighbourhood ops (counterpart of core/pointops/neighbors.py).

Batched over leading dims, [..., N, 3] clouds. The two KNN searches
(and random_subsample_pool's),
nearest_index and min_dists ([B, N, 3] clouds) dispatch to the
hand-written kernels in ops.pointops (their plain PyTorch versions for CPU
tensors), through the module attribute so that a caller can swap a
wrapper; the rest is plain PyTorch.
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


def nearest_index(target: torch.Tensor, source: torch.Tensor) -> torch.Tensor:
    """Index of the nearest source point: [B, n1, 3], [B, n2, 3] ->
    [B, n1] int32 (gcn3d.get_nearest_index semantics, ties to the lower
    index)."""
    return _kops.nearest_index(target, source)


def nearest_index_multi(target: torch.Tensor, sources) -> list:
    """nearest_index against each cloud of `sources` (each [B, n_c, 3]),
    one kernel launch for all of them: a list of [B, n1] int32."""
    return _kops.nearest_index_multi(target, sources)


def min_dists(target: torch.Tensor, source: torch.Tensor,
              eps: float = 1e-8) -> torch.Tensor:
    """Distance to the nearest source point [B, n1], sqrt clamped at
    eps^2 inside (grad-safe at coincident points); differentiable."""
    return _kops.min_dists(target, source, eps)


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


def farthest_point_sampling(points: torch.Tensor, num_samples: int,
                            start_index: int = 0) -> torch.Tensor:
    """Deterministic FPS: indices [..., num_samples] (int32) of a
    maximally spread subset of points [..., n, 3], from `start_index`;
    ties go to the first index (torch.argmax, as jnp.argmax). One step a
    sample, as the JAX package's lax.scan."""
    lead = points.shape[:-2]
    pts = points.reshape((-1,) + points.shape[-2:])
    b, n, _ = pts.shape
    rows = torch.arange(b, device=pts.device)
    d2 = torch.full((b, n), float("inf"), dtype=pts.dtype, device=pts.device)
    last = torch.full((b,), start_index, dtype=torch.int64,
                      device=pts.device)
    idx = []
    for _ in range(num_samples):
        idx.append(last)
        dist = torch.sum((pts - pts[rows, last][:, None, :]) ** 2, -1)
        d2 = torch.minimum(d2, dist)
        last = torch.argmax(d2, dim=-1)
    return torch.stack(idx, -1).to(torch.int32).reshape(
        lead + (num_samples,))


def random_subsample_pool(generator: torch.Generator | None,
                          vertices: torch.Tensor, features: torch.Tensor,
                          pool_num: int, neighbor_num: int = 4,
                          permutation: torch.Tensor | None = None):
    """3D-GCN Pool_layer (gcn3d.py:218-242): the max of each point's
    features over its `neighbor_num` nearest neighbours (KNN on
    vertices[..., :3]), then `pool_num` points of one random permutation
    shared by the batch, drawn from `generator` or given as
    `permutation` [n]. vertices [B, n, d_v], features [B, n, c] ->
    ([B, pool_num, d_v], [B, pool_num, c])."""
    n = vertices.shape[-2]
    idx = knn_indices(vertices[..., :3].contiguous(), neighbor_num,
                      exclude_self=True)
    pooled = gather_neighbors_max(features, idx)
    if permutation is None:
        permutation = torch.randperm(n, generator=generator,
                                     device=vertices.device)
    sample = permutation[:pool_num].to(device=vertices.device,
                                       dtype=torch.int64)
    return vertices[..., sample, :], pooled[..., sample, :]
