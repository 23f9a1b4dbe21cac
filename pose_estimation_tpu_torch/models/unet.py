"""UNet backbone of the transparent pipeline (counterpart of
models/unet.py): encoder 64-128-256-512-512, a colour decoder, and a
shared normal/depth trunk split into a normal decoder (its features
L2-normalised over the channels) and a depth decoder. NCHW maps; the
children carry flax's names (layers.Named), so the parameter tree is the
JAX one key for key."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pose_estimation_tpu_torch.core.mathsafe import safe_normalize
from pose_estimation_tpu_torch.models.layers import (
    Conv, Named, Norm, resize_bilinear)


class DoubleConv(Named):
    """(3x3 conv without bias -> GroupNorm -> relu) x 2."""

    def __init__(self, in_ch, features, mid=None, dtype=torch.float32):
        super().__init__()
        mid = mid or features
        self.child(Conv(in_ch, mid, 3, 1, False, dtype))
        self.child(Norm(mid, dtype=dtype))
        self.child(Conv(mid, features, 3, 1, False, dtype))
        self.child(Norm(features, dtype=dtype))

    def forward(self, x):
        x = torch.relu(self.Norm_0(self.Conv_0(x)))
        return torch.relu(self.Norm_1(self.Conv_1(x)))


class Down(Named):
    """2x2 max pool (VALID, stride 2), then DoubleConv."""

    def __init__(self, in_ch, features, dtype=torch.float32):
        super().__init__()
        self.child(DoubleConv(in_ch, features, dtype=dtype))

    def forward(self, x):
        return self.DoubleConv_0(F.max_pool2d(x, 2, 2))


class Up(Named):
    """x1 up-sampled bilinearly to x2's size, [x2, x1] concatenated on the
    channels, then DoubleConv with half the concatenation's width in the
    middle."""

    def __init__(self, in_ch, features, dtype=torch.float32):
        super().__init__()
        self.child(DoubleConv(in_ch, features, mid=in_ch // 2, dtype=dtype))

    def forward(self, x1, x2):
        x1 = resize_bilinear(x1, x2.shape[2], x2.shape[3])
        return self.DoubleConv_0(torch.cat([x2, x1], dim=1))


class UNet(Named):
    """[B, 3, H, W] -> (colour 64, normal 64 L2-normalised, depth 64), each
    [B, 64, H, W]."""

    def __init__(self, dtype=torch.float32):
        super().__init__()
        self.child(DoubleConv(3, 64, dtype=dtype))
        for cin, cout in ((64, 128), (128, 256), (256, 512), (512, 512)):
            self.child(Down(cin, cout, dtype))
        # Up_0-3 colour, Up_4-5 the shared normal/depth trunk, Up_6-7
        # normal, Up_8-9 depth (flax's creation order)
        for cin, cout in ((1024, 256), (512, 128), (256, 64), (128, 64),
                          (1024, 256), (512, 128), (256, 64), (128, 64),
                          (256, 64), (128, 64)):
            self.child(Up(cin, cout, dtype))

    def forward(self, x):
        x1 = self.DoubleConv_0(x)
        x2 = self.Down_0(x1)
        x3 = self.Down_1(x2)
        x4 = self.Down_2(x3)
        x5 = self.Down_3(x4)

        c = self.Up_0(x5, x4)
        c = self.Up_1(c, x3)
        c = self.Up_2(c, x2)
        color = self.Up_3(c, x1)

        nd = self.Up_4(x5, x4)
        nd = self.Up_5(nd, x3)
        n = self.Up_6(nd, x2)
        # safe_normalize: relu features are exactly 0 at some pixels, where
        # a plain norm's gradient is NaN
        normal = safe_normalize(self.Up_7(n, x1), dim=1)
        dd = self.Up_8(nd, x2)
        depth = self.Up_9(dd, x1)
        return color, normal, depth
