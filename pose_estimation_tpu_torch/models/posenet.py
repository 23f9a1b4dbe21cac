"""Translation head (counterpart of models/posenet.py, TBase and PoseNet
with enable_rot=False)."""

from __future__ import annotations

import torch

from pose_estimation_tpu_torch.models.layers import Dense, MLP1d, Named


class TBase(Named):
    """Per-point translation offsets [B, N, out_dim]. In training, dropout
    at `rate` before the last Dense, with flax's semantics: keep each value
    with probability 1 - rate and scale the kept ones by 1 / (1 - rate).
    The keep mask comes from `generator`, or is injected as `keep`."""

    rate = 0.2

    def __init__(self, in_f, norm="gn", out_dim=3, dtype=torch.float32):
        super().__init__()
        self.child(MLP1d(in_f, (1024, 256, 256), norm, final_act=True,
                         dtype=dtype))
        self.child(Dense(256, out_dim, dtype))

    def forward(self, feat, train=False, generator=None, keep=None):
        x = self.MLP1d_0(feat)
        if train:
            p = 1.0 - self.rate
            if keep is None:
                dev = x.device if generator is None else generator.device
                keep = torch.rand(x.shape, generator=generator,
                                  device=dev) < p
            x = torch.where(keep.to(x.device), x / p, torch.zeros_like(x))
        return self.Dense_0(x)


class PoseNet(Named):
    """(None, None, t_res): the rotation heads are not ported."""

    def __init__(self, in_f, enable_rot=False, t_dim=3, norm="gn",
                 dtype=torch.float32):
        super().__init__()
        if enable_rot:
            raise NotImplementedError("enable_rot is not ported")
        self.child(TBase(in_f, norm, t_dim, dtype))

    def forward(self, feat, train=False, generator=None):
        return None, None, self.TBase_0(feat, train, generator)
