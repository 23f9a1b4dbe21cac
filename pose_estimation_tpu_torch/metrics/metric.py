"""Pose metrics (counterpart of metrics/metric.py): ADD(-S) and the
accept/reject bits, batched."""

from __future__ import annotations

import torch

from pose_estimation_tpu_torch.core.geometry.rotations import (
    angular_distance, transform_points)
from pose_estimation_tpu_torch.core.pointops import min_dists


def add_metric(pred_r, pred_t, gt_r, gt_t, model_points, sym_mask):
    """ADD(-S) distances [B]; symmetric objects use the closest-point
    (ADD-S) form. model_points [B, N, 3]."""
    pred = transform_points(model_points, pred_r, pred_t)
    gt = transform_points(model_points, gt_r, gt_t)
    direct = torch.linalg.norm(pred - gt, dim=-1).mean(-1)
    chamfer = min_dists(pred, gt).mean(-1)
    return torch.where(sym_mask > 0, chamfer, direct)


def rotation_deg(pred_r, gt_r):
    return angular_distance(pred_r, gt_r)


def translation_m(pred_t, gt_t):
    return torch.linalg.norm(pred_t - gt_t, dim=-1)


def pose_accuracy(pred_r, pred_t, gt_r, gt_t, model_points, sym_mask,
                  diameter, add_frac=0.1, deg_thresh=5.0, cm_thresh=0.05):
    """Per-sample accept bits [B] (float 0/1) plus the raw distances."""
    dis = add_metric(pred_r, pred_t, gt_r, gt_t, model_points, sym_mask)
    rdeg = rotation_deg(pred_r, gt_r)
    tm = translation_m(pred_t, gt_t)
    f = lambda c: c.to(torch.float32)
    return {
        "add_dis": dis,
        "rot_deg": rdeg,
        "trans_m": tm,
        "add_ok": f(dis < add_frac * diameter),
        "add_ok_005": f(dis < 0.05 * diameter),
        "add_ok_002": f(dis < 0.02 * diameter),
        "deg_cm_ok": f((rdeg < deg_thresh) & (tm < cm_thresh)),
    }
