"""Transparent-pipeline losses (counterpart of losses/transparent_loss.py):
the focal mask loss, the confidence-weighted per-point-hypothesis ADD(-S)
with the allocentric -> egocentric conversion and the axis-symmetry
rotation term, and the aggregate with the normal / depth / mask /
boundary completion terms.

The symmetric objects' chamfer runs kernel 4 (core.pointops.min_dists,
its autograd.Function; the plain version for CPU tensors): every pose
hypothesis of every sample posed on the model points, [B, n x m, 3]
targets against the gt-posed model [B, m, 3] (500,000 x 500 a sample in
the shipped config).
"""

from __future__ import annotations

import torch

from pose_estimation_tpu_torch.core.geometry.allocentric import (
    allo_to_ego_matrix)
from pose_estimation_tpu_torch.core.geometry.rotations import quat_to_matrix
from pose_estimation_tpu_torch.core.mathsafe import safe_norm
from pose_estimation_tpu_torch.core.pointops import min_dists
from pose_estimation_tpu_torch.losses.map_loss import cosine_map, masked_mean

_EPS = 1e-8


def focal_loss(logits: torch.Tensor, target: torch.Tensor, gamma: float = 0.0,
               alpha: torch.Tensor | None = None) -> torch.Tensor:
    """Focal cross entropy over the trailing class axis: logits [..., C],
    target [...] int."""
    logp = torch.log_softmax(logits, dim=-1)
    picked = torch.gather(logp, -1, target.long()[..., None])[..., 0]
    w = (1.0 - torch.exp(picked)) ** gamma
    if alpha is not None:
        w = w * alpha[target.long()]
    return torch.mean(-w * picked)


def confidence_pose_loss(pred_quat, pred_t, pred_c, target, model_points,
                         sym_mask, axis, gt_r, w_conf: float = 0.015,
                         allocentric: bool = True):
    """pred_quat [B, N, 4], pred_t [B, N, 3], pred_c [B, N, 1], target
    [B, M, 3] (the gt-posed model), model_points [B, M, 3], sym_mask [B],
    axis [B, 3] (the object's symmetry-axis weights), gt_r [B, 3, 3] ->
    (loss_add, best distance [B], loss_rot). In fp32 whatever the heads'
    dtype (the pose geometry is ill-conditioned in bf16)."""
    b, n, _ = pred_quat.shape
    pred_quat, pred_t, pred_c = pred_quat.float(), pred_t.float(), \
        pred_c.float()
    base = quat_to_matrix(pred_quat)                       # [B, N, 3, 3]
    if allocentric:
        base = allo_to_ego_matrix(pred_t, base)
    pred = model_points[:, None] @ base.transpose(-1, -2) \
        + pred_t[:, :, None, :]                            # [B, N, M, 3]
    # safe_norm: both branches are computed for every sample, and an
    # exactly-zero distance in the unselected one would give 0 * inf = NaN
    direct = safe_norm(pred - target[:, None], dim=-1).mean(-1)
    flat_pred = pred.reshape(b, n * pred.shape[2], 3).contiguous()
    chamfer = min_dists(flat_pred, target.contiguous()).reshape(
        b, n, -1).mean(-1)
    dis = torch.where(sym_mask[:, None] > 0, chamfer, direct)   # [B, N]

    c = pred_c[..., 0]
    loss_add = torch.mean(dis * c - w_conf * torch.log(c + _EPS))

    cols_pred = base.transpose(-1, -2)            # rows = columns of R
    cols_gt = gt_r.transpose(-1, -2)[:, None]
    cos = torch.sum(cols_pred * cols_gt, -1) / torch.clamp(
        torch.linalg.norm(cols_pred, dim=-1)
        * torch.linalg.norm(cols_gt, dim=-1), min=_EPS)    # [B, N, 3]
    loss_axis = torch.sum(axis[:, None, :] * (1.0 - cos), -1)
    loss_rot = torch.mean(c * loss_axis - w_conf * torch.log(c + _EPS))

    best = torch.argmax(c, dim=1)
    best_dis = torch.gather(dis, 1, best[:, None])[:, 0]
    return loss_add, best_dis, loss_rot


def smooth_l1(pred, target):
    d = torch.abs(pred - target)
    return torch.mean(torch.where(d < 1.0, 0.5 * d * d, d - 0.5))


def transparent_loss(pred: dict, gt: dict, weights: dict,
                     w_conf: float = 0.015) -> dict:
    """The aggregate. pred: quat, trans, conf, normal [B, H, W, 3], depth,
    mask [B, H, W, 1] (and boundary); gt: target, model_points, sym_mask,
    axis, r, normal, depth, mask (and boundary); weights: distance,
    normal, depth, mask, rotation (and boundary). The normal term's mean
    is over the valid pixels of the global batch under a process group
    (map_loss.masked_mean)."""
    loss_add, best_dis, loss_rot = confidence_pose_loss(
        pred["quat"], pred["trans"], pred["conf"], gt["target"],
        gt["model_points"], gt["sym_mask"], gt["axis"], gt["r"],
        w_conf=w_conf)
    valid_n = (gt["normal"] != 0).any(-1)
    loss_n = masked_mean(cosine_map(pred["normal"], gt["normal"]),
                         valid_n.float())
    loss_d = smooth_l1(pred["depth"], gt["depth"])
    loss_m = torch.mean(torch.abs(pred["mask"] - gt["mask"]))
    loss_b = (torch.mean(torch.abs(pred["boundary"] - gt["boundary"]))
              if "boundary" in pred and "boundary" in gt
              else torch.zeros((), device=loss_m.device))
    total = (weights["distance"] * loss_add + weights["normal"] * loss_n
             + weights["depth"] * loss_d + weights["mask"] * loss_m
             + weights["rotation"] * loss_rot
             + weights.get("boundary", 0.0) * loss_b)
    return {"all_loss": total, "loss_add": loss_add, "loss_r": loss_rot,
            "loss_n": loss_n, "loss_m": loss_m, "loss_d": loss_d,
            "loss_b": loss_b, "distance": torch.mean(best_dis)}
