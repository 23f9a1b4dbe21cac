"""Point-cloud ops (counterpart of core/pointops): KNN, nearest, gather,
FPS, pooling."""

from pose_estimation_tpu_torch.core.pointops.neighbors import (  # noqa: F401
    pairwise_sqdist, knn_indices, knn_indices_cross, nearest_index,
    nearest_index_multi, min_dists,
    gather_neighbors, gather_neighbors_max, gather_rows,
    neighbor_directions, farthest_point_sampling,
    random_subsample_pool,
)
