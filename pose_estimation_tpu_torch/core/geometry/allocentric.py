"""Allocentric <-> egocentric rotations (counterpart of
core/geometry/allocentric.py): the allocentric rotation is the egocentric
one seen from the ray through the object's centre, and the two differ by
the rotation taking the optical axis onto that ray."""

from __future__ import annotations

import torch

from pose_estimation_tpu_torch.core.geometry.rotations import quat_to_matrix


def _ray_quat(translation: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
    """Quaternion rotating the camera ray (0, 0, 1) onto the ray through
    `translation` [..., 3], in the half-angle form normalize([1 + cam.obj,
    cam x obj]), smooth everywhere in front of the camera; in fp32
    whatever the input's dtype."""
    t = translation.float()
    obj = t / torch.sqrt(torch.sum(t * t, -1, keepdim=True) + eps * eps)
    # cam x obj for cam = (0, 0, 1), written out: (-obj_y, obj_x, 0)
    q = torch.stack([1.0 + obj[..., 2], -obj[..., 1], obj[..., 0],
                     torch.zeros_like(obj[..., 0])], -1)
    return q / torch.sqrt(torch.sum(q * q, -1, keepdim=True) + eps * eps)


def allo_to_ego_matrix(translation: torch.Tensor, rot_allo: torch.Tensor,
                       eps: float = 1e-4) -> torch.Tensor:
    """R_ego = R(allo->ego) @ R_allo; translation [..., 3], rot
    [..., 3, 3]. The product in fp32, the result in rot_allo's dtype."""
    rot_a2e = quat_to_matrix(_ray_quat(translation, eps))
    return (rot_a2e @ rot_allo.to(rot_a2e.dtype)).to(rot_allo.dtype)


def ego_to_allo_matrix(translation: torch.Tensor, rot_ego: torch.Tensor,
                       eps: float = 1e-4) -> torch.Tensor:
    """Inverse of allo_to_ego_matrix."""
    rot_a2e = quat_to_matrix(_ray_quat(translation, eps))
    return (rot_a2e.transpose(-1, -2) @ rot_ego.to(rot_a2e.dtype)
            ).to(rot_ego.dtype)
