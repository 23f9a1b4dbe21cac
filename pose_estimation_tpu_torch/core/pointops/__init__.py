"""Point-cloud neighbourhood ops (counterpart of core/pointops)."""

from pose_estimation_tpu_torch.core.pointops.neighbors import (  # noqa: F401
    pairwise_sqdist, knn_indices, knn_indices_cross, gather_neighbors,
    gather_rows, gather_neighbors_max, neighbor_directions, min_dists,
    nearest_index, nearest_index_multi)
