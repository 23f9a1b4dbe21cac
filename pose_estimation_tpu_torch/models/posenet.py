"""Translation head (counterpart of models/posenet.py, TBase and PoseNet
with enable_rot=False)."""

from __future__ import annotations

import torch

from pose_estimation_tpu_torch.models.layers import Dense, MLP1d, Named


class TBase(Named):
    """Per-point translation offsets [B, N, out_dim]; dropout is the
    identity at eval."""

    def __init__(self, in_f, norm="gn", out_dim=3, dtype=torch.float32):
        super().__init__()
        self.child(MLP1d(in_f, (1024, 256, 256), norm, final_act=True,
                         dtype=dtype))
        self.child(Dense(256, out_dim, dtype))

    def forward(self, feat):
        return self.Dense_0(self.MLP1d_0(feat))


class PoseNet(Named):
    """(None, None, t_res): the rotation heads are not ported."""

    def __init__(self, in_f, enable_rot=False, t_dim=3, norm="gn",
                 dtype=torch.float32):
        super().__init__()
        if enable_rot:
            raise NotImplementedError("enable_rot is not ported")
        self.child(TBase(in_f, norm, t_dim, dtype))

    def forward(self, feat):
        return None, None, self.TBase_0(feat)
