"""Pose solvers (counterpart of core/solvers): EPnP, LM refinement,
batched PnP-RANSAC, differentiable PnP, ICP."""

from pose_estimation_tpu_torch.core.solvers.epnp import (  # noqa: F401
    epnp, epnp_fast)
from pose_estimation_tpu_torch.core.solvers.lm import (  # noqa: F401
    refine_pose_lm, reprojection_residuals)
from pose_estimation_tpu_torch.core.solvers.pnp import (  # noqa: F401
    pnp_ransac, pnp_implicit)
from pose_estimation_tpu_torch.core.solvers.icp import icp_refine  # noqa: F401

# the port's pnp_ransac is batched ([B, n, ...]); the JAX package's
# pnp_ransac_batch is its vmap over instances
pnp_ransac_batch = pnp_ransac
