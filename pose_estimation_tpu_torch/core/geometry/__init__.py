"""Geometry in PyTorch (counterpart of core/geometry): rotation
representations, intrinsics and back-projection, allocentric rotations,
affine crops and samplers, Kabsch/Umeyama alignment and its RANSAC."""

from pose_estimation_tpu_torch.core.geometry.rotations import (  # noqa: F401
    quat_normalize, quat_to_matrix, matrix_to_quat,
    axis_angle_to_matrix, matrix_to_axis_angle, skew,
    ortho6d_to_matrix, matrix_to_ortho6d, euler_to_matrix,
    angular_distance, random_rotation, transform_points,
)
from pose_estimation_tpu_torch.core.geometry.intrinsics import (  # noqa: F401
    intrinsic_vec_to_matrix, intrinsic_matrix_to_vec,
    uvd_to_cloud, depth_map_to_cloud, project_points, crop_intrinsics,
)
from pose_estimation_tpu_torch.core.geometry.allocentric import (  # noqa: F401
    allo_to_ego_matrix, ego_to_allo_matrix,
)
from pose_estimation_tpu_torch.core.geometry.warp import (  # noqa: F401
    crop_affine_coords, bilinear_sample, nearest_sample, crop_resize,
)
from pose_estimation_tpu_torch.core.geometry.umeyama import (  # noqa: F401
    kabsch, umeyama_ransac)
