"""Pose heads (counterpart of models/posenet.py): TBase, the per-point
translation offsets; RotBase, the global rotation code with a mean over
the points; PoseNet, TBase and (enable_rot) two RotBases; and the
confidence-weighted orthogonalisation of the two rotation axes as pure
functions."""

from __future__ import annotations

import torch

from pose_estimation_tpu_torch.core.mathsafe import safe_normalize
from pose_estimation_tpu_torch.models.layers import Dense, MLP1d, Named, Norm
from pose_estimation_tpu_torch.parallel import dist


def dropout(x, rate, generator=None, keep=None):
    """flax's nn.Dropout in training: keep each value with probability
    1 - rate and scale the kept ones by 1 / (1 - rate). The keep mask
    comes from `generator`, or is injected as `keep`, at the global
    batch's shape under a process group (dist.draw_rows): each rank
    keeps its rows of one draw, as the JAX step's one mask over the
    mesh."""
    p = 1.0 - rate
    if keep is None:
        dev = x.device if generator is None else generator.device
        keep = dist.draw_rows(lambda shape: torch.rand(
            shape, generator=generator, device=dev) < p, x.shape)
    else:
        keep = dist.rank_rows(keep)
    return torch.where(keep.to(x.device), x / p, torch.zeros_like(x))


class TBase(Named):
    """Per-point translation offsets [B, N, out_dim]; in training, dropout
    at `rate` before the last Dense."""

    rate = 0.2

    def __init__(self, in_f, norm="gn", out_dim=3, dtype=torch.float32):
        super().__init__()
        self.child(MLP1d(in_f, (1024, 256, 256), norm, final_act=True,
                         dtype=dtype))
        self.child(Dense(256, out_dim, dtype))

    def forward(self, feat, train=False, generator=None, keep=None):
        x = self.MLP1d_0(feat)
        if train:
            x = dropout(x, self.rate, generator, keep)
        return self.Dense_0(x)


class RotBase(Named):
    """Global rotation code [B, out_dim]: per-point MLP, mean over the
    points, Dense 256, Norm, relu, dropout at `rate` in training, Dense."""

    rate = 0.2

    def __init__(self, in_f, out_dim=4, norm="gn", dtype=torch.float32):
        super().__init__()
        self.child(MLP1d(in_f, (1024, 256), norm, final_act=True,
                         dtype=dtype))
        self.child(Dense(256, 256, dtype))
        self.child(Norm(256, norm, dtype=dtype))
        self.child(Dense(256, out_dim, dtype))

    def forward(self, feat, train=False, generator=None, keep=None):
        x = torch.mean(self.MLP1d_0(feat), dim=1)
        x = torch.relu(self.Norm_0(self.Dense_0(x)))
        if train:
            x = dropout(x, self.rate, generator, keep)
        return self.Dense_1(x)


class PoseNet(Named):
    """(rot_green, rot_red, t_res); the rotation codes are None without
    enable_rot."""

    def __init__(self, in_f, enable_rot=False, t_dim=3, norm="gn",
                 dtype=torch.float32, rot_dim=4):
        super().__init__()
        self.enable_rot = enable_rot
        self.child(TBase(in_f, norm, t_dim, dtype))
        if enable_rot:
            self.child(RotBase(in_f, rot_dim, norm, dtype))
            self.child(RotBase(in_f, rot_dim, norm, dtype))

    def forward(self, feat, train=False, generator=None):
        t = self.TBase_0(feat, train, generator)
        if not self.enable_rot:
            return None, None, t
        return (self.RotBase_0(feat, train, generator),
                self.RotBase_1(feat, train, generator), t)


def vertical_rot_vectors(c1, c2, v1, v2, eps=1e-8):
    """Move each of the unit axes v1, v2 [B, 3] away from the other by its
    share of their dot product, by the confidences c1, c2 [B, 1], and
    renormalise: (new v1, new v2)."""
    dot = torch.sum(v1 * v2, -1, keepdim=True)
    w1 = c1 / torch.clamp(c1 + c2, min=eps)
    w2 = c2 / torch.clamp(c1 + c2, min=eps)
    v1_new = safe_normalize(v1 - w2 * dot * v2, eps=eps)
    v2_new = safe_normalize(v2 - w1 * dot * v1, eps=eps)
    return v1_new, v2_new


def rot_mat_y_first(y, x, eps=1e-8):
    """Rotation matrix [B, 3, 3] with columns (x', y, z) from the y axis
    and an x axis: z = x cross y normalised, x' = y cross z."""
    z = safe_normalize(torch.linalg.cross(x, y), eps=eps)
    x_new = torch.linalg.cross(y, z)
    return torch.stack([x_new, y, z], dim=-1)
