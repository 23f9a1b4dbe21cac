"""Pose metrics (counterpart of metrics/metric.py): ADD(-S) and the
accept/reject bits, batched; ADD AUC and the per-object table on the host.
ADD-S runs the nearest-source kernel (core.pointops.min_dists)."""

from __future__ import annotations

import numpy as np
import torch

from pose_estimation_tpu_torch.core.geometry.rotations import (
    angular_distance, transform_points)
from pose_estimation_tpu_torch.core.pointops import min_dists
from pose_estimation_tpu_torch.parallel import dist


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


def add_auc(distances: np.ndarray, max_dis: float = 0.1) -> float:
    """VOC-style ADD AUC: accuracy integrated over distance thresholds in
    [0, max_dis]. Host-side, once per eval epoch."""
    d = np.sort(np.asarray(distances).reshape(-1))
    n = len(d)
    if n == 0:
        return 0.0
    acc = np.cumsum(np.ones(n)) / n
    valid = d < max_dis
    if not valid.any():
        return 0.0
    d = np.concatenate([[0.0], d[valid], [max_dis]])
    acc = np.concatenate([[0.0], acc[valid], [acc[valid][-1]]])
    return float(np.trapezoid(acc, d) / max_dis)


class PerObjectAccumulator:
    """Host-side per-object metric table: feed batched metric dicts and
    class ids; read a per-object and an overall summary. Under a process
    group each rank feeds its shard of the test set and
    `all_reduce_across_processes` merges them before the summary."""

    def __init__(self, num_cls: int):
        self.num_cls = num_cls
        self.reset()

    def reset(self):
        self.count = np.zeros(self.num_cls)
        self.sums = {}
        self.dis_all = [[] for _ in range(self.num_cls)]

    def update(self, cls_ids, metrics: dict):
        cls_ids = np.asarray(cls_ids).reshape(-1)
        onehot = np.eye(self.num_cls)[cls_ids]                  # [B, C]
        self.count += onehot.sum(0)
        for k, v in metrics.items():
            v = np.asarray(v, np.float64).reshape(-1)
            self.sums.setdefault(k, np.zeros(self.num_cls))
            self.sums[k] += (onehot * v[:, None]).sum(0)
        for c, d in zip(cls_ids, np.asarray(metrics["add_dis"]).reshape(-1)):
            self.dis_all[c].append(float(d))

    def all_reduce_across_processes(self):
        """Merge the ranks' tables (JAX metric.py:108-133): counts and sums
        summed, the per-class distance lists (the AUC's input) gathered,
        NaN-padded to the longest for the gather, in rank order. Every
        rank then holds the union; a no-op with one process."""
        if dist.world_size() == 1:
            return self
        self.count = dist.all_gather_array(self.count).sum(0)
        self.sums = {k: dist.all_gather_array(v).sum(0)
                     for k, v in self.sums.items()}
        lens = np.array([len(d) for d in self.dis_all], np.int32)
        all_lens = dist.all_gather_array(lens)                  # [P, C]
        m = max(int(all_lens.max()), 1)
        pad = np.full((self.num_cls, m), np.nan, np.float32)
        for c, d in enumerate(self.dis_all):
            pad[c, :len(d)] = d
        gathered = dist.all_gather_array(pad)                   # [P, C, m]
        self.dis_all = [
            [float(x) for p in range(gathered.shape[0])
             for x in gathered[p, c, :all_lens[p, c]]]
            for c in range(self.num_cls)]
        return self

    def summary(self) -> dict:
        cnt = np.maximum(self.count, 1)
        per_obj = {
            str(c): {
                **{k: float(self.sums[k][c] / cnt[c]) for k in self.sums},
                "auc": add_auc(np.array(self.dis_all[c]) if self.dis_all[c]
                               else np.array([np.inf])),
                "count": int(self.count[c]),
            }
            for c in range(self.num_cls) if self.count[c] > 0
        }
        total = max(self.count.sum(), 1)
        overall = {k: float(self.sums[k].sum() / total) for k in self.sums}
        overall["count"] = int(self.count.sum())
        return {"per_object": per_obj, "overall": overall}
