"""ADD(-S) pose losses and the KRRN loss aggregate (counterpart of
losses/pose_loss.py).

Both ADD forms are computed for every sample and selected per sample by
the symmetry mask, as the JAX package does: the unselected branch still
runs backward, which is why its norm is safe_norm and min_dists clamps
inside the sqrt. The closest-point form runs the nearest-source kernel
(ops.pointops.min_dists) on the card.
"""

from __future__ import annotations

from typing import Mapping

import torch

from pose_estimation_tpu_torch.core.mathsafe import safe_norm
from pose_estimation_tpu_torch.core.pointops import min_dists
from pose_estimation_tpu_torch.losses.map_loss import map_loss


def add_distance(pred_points: torch.Tensor, target_points: torch.Tensor,
                 sym_mask: torch.Tensor) -> torch.Tensor:
    """Per-sample ADD / ADD-S distance: [B, N, 3] x2, sym_mask [B] ->
    [B]. ADD: mean_i |p_i - t_i|; ADD-S: mean_i min_j |p_i - t_j|."""
    direct = safe_norm(pred_points - target_points).mean(-1)
    chamfer = min_dists(pred_points, target_points).mean(-1)
    return torch.where(sym_mask > 0, chamfer, direct)


def pose_loss(pred_r: torch.Tensor, pred_t: torch.Tensor,
              targets: torch.Tensor, model_points: torch.Tensor,
              sym_mask: torch.Tensor) -> torch.Tensor:
    """Model points transformed by (pred_r, pred_t), ADD(-S) against the
    gt-transformed targets, mean over the batch (fp32)."""
    pred_points = (model_points @ pred_r.transpose(-1, -2)
                   + pred_t[:, None, :])
    return add_distance(pred_points, targets, sym_mask).mean()


def krrn_loss(pred: Mapping[str, torch.Tensor],
              gt: Mapping[str, torch.Tensor], weights: Mapping[str, float],
              opt_pose: bool = True) -> dict:
    """The KRRN loss aggregate: xyz l1, normal cosine, region CE over the
    labelled pixels, mask CE over all pixels, and the ADD(-S) pose loss of
    the regressed translation with the gt rotation when opt_pose."""
    valid = gt.get("valid")
    loss_xyz = map_loss("l1", pred["xyz"], gt["xyz"], valid)
    loss_normal = map_loss("cosine", pred["normal"], gt["normal"], valid)
    loss_region = map_loss("ce", pred["region"], gt["region"], valid)
    mask_valid = gt.get("mask_valid")
    if mask_valid is None:
        mask_valid = torch.ones(gt["multi_cls_mask"].shape,
                                device=gt["multi_cls_mask"].device)
    loss_mask = map_loss("ce", pred["mask"], gt["multi_cls_mask"], mask_valid)

    if opt_pose and pred.get("pred_t") is not None:
        loss_add = pose_loss(gt["target_r"], pred["pred_t"], gt["target"],
                             gt["model_points"], gt["sym_mask"])
    else:
        loss_add = torch.zeros((), device=loss_xyz.device)

    total = (weights["weight_xyz"] * loss_xyz
             + weights["weight_region"] * loss_region
             + weights["weight_mask"] * loss_mask
             + weights["weight_normal"] * loss_normal
             + weights["weight_pose"] * loss_add)
    return {
        "loss": total,
        "loss_add": loss_add,
        "loss_xyz": loss_xyz,
        "loss_region": loss_region,
        "loss_normal": loss_normal,
        "loss_mask": loss_mask,
    }
