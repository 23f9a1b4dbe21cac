"""Kernel 4, the nearest source point (`csrc/min_dists.cu`): per pair
as KNN; a distance and an index written per target and source cloud."""

from __future__ import annotations

from portbench.roofline import bound, nbytes

ENTRY = ("pose_estimation_tpu_torch.ops.pointops", "nearest_multi")


def least(target, sources, eps=1e-8) -> float:
    b, n, _ = target.shape
    m = sum(s.shape[1] for s in sources)
    return bound(nbytes(target, *sources) + len(sources) * b * n * 8,
                 {"fp32": b * n * m * 9})
