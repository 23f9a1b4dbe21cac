"""Ring-sharded point ops over a process group (counterpart of
parallel/ring_pointops.py).

Both point sets are sharded over the ranks, an equal number of points on
each. The source shard is passed around the ring (dist.ring_shift:
dist.batch_isend_irecv to the next rank, from the previous one) while
each rank keeps a running result against its resident shard, so a rank
holds (N x M) / d^2 distances at a time instead of N x M: the analog of
ring attention for chamfer, KNN and ADD-S over clouds larger than one
card.

  ring_min_dists  each block is the nearest-source function of kernel 4
                  (ops.pointops.nearest: the CUDA kernel on a card, its
                  plain version on the CPU), sqrt(max(min d, 1e-16)); the
                  running minimum of these equals the JAX ring's sqrt of
                  the clamped running minimum exactly, the square root and
                  the clamp being monotone.
  ring_knn        plain blocks, as the JAX ring's: squared distances in
                  the kernels' expanded order, a point's own global index
                  excluded, candidate lists merged by (distance, global
                  index), so ties go to the lower index as in the
                  one-process KNN.

Forward only (the JAX functions are used without gradients too).
"""

from __future__ import annotations

import torch

from pose_estimation_tpu_torch.ops import pointops as kops
from pose_estimation_tpu_torch.parallel import dist


def ring_min_dists(group=None):
    """fn(target [n, 3], source [m, 3]) -> [n]: the distance of each of
    this rank's targets to the nearest source point of every rank, both
    sets sharded over `group` (the default group when None)."""

    def fn(target: torch.Tensor, source: torch.Tensor) -> torch.Tensor:
        d = dist.world_size(group)
        tgt, blk, best = target.contiguous()[None], source.contiguous(), None
        for i in range(d):
            near = kops.nearest(tgt, blk[None])[0][0]
            best = near if best is None else torch.minimum(best, near)
            if i < d - 1:
                blk = dist.ring_shift(blk, group)
        return best

    return fn


def ring_knn(group=None, k: int = 10):
    """fn(points [n, 3]) -> (dists [n, k], idx [n, k] int32): the k
    nearest points of the whole sharded cloud (global indices, rank r
    holding rows [r*n, (r+1)*n)), the point itself excluded; dists are
    sqrt(max(d, 1e-16))."""

    def fn(points: torch.Tensor):
        d, r = dist.world_size(group), dist.rank(group)
        pts = points.contiguous()
        n, dev = pts.shape[0], pts.device
        rows = torch.arange(n, device=dev) + r * n
        best_d = torch.full((n, k), float("inf"), dtype=pts.dtype,
                            device=dev)
        best_i = torch.zeros((n, k), dtype=torch.long, device=dev)
        blk, owner = pts, r
        for i in range(d):
            sq = kops.sqdist(pts, blk)                           # [n, m]
            cols = torch.arange(blk.shape[0], device=dev) + owner * n
            sq = torch.where(cols[None] == rows[:, None],
                             torch.full_like(sq, float("inf")), sq)
            cand_d = torch.cat([best_d, sq], 1)
            cand_i = torch.cat([best_i, cols[None].expand(n, -1)], 1)
            by_index = torch.argsort(cand_i, dim=1, stable=True)
            cand_d = torch.gather(cand_d, 1, by_index)
            cand_i = torch.gather(cand_i, 1, by_index)
            order = torch.argsort(cand_d, dim=1, stable=True)[:, :k]
            best_d = torch.gather(cand_d, 1, order)
            best_i = torch.gather(cand_i, 1, order)
            if i < d - 1:
                blk, owner = dist.ring_shift(blk, group), (owner - 1) % d
        return (torch.sqrt(torch.clamp(best_d, min=1e-16)),
                best_i.to(torch.int32))

    return fn
