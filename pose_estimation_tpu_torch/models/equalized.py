"""Equalized-learning-rate layers (counterpart of models/equalized.py):
the weights are drawn N(0, 1) and scaled at run time by
he_std = gain / sqrt(fan_in), which equalises the effective learning rate
of every layer. TRPESNet's head takes EqualizedDense with
use_equalized."""

from __future__ import annotations

import torch
from torch import nn

from pose_estimation_tpu_torch.models.layers import Conv, Named


class EqualizedDense(nn.Module):
    """flax EqualizedDense over the last axis: `kernel` kept in flax's
    layout [fan_in, features], scaled in fp32 by gain / sqrt(fan_in), then
    cast to the compute dtype, then the product, in that order."""

    def __init__(self, in_f, features, gain=2.0 ** 0.5, use_bias=True,
                 dtype=torch.float32):
        super().__init__()
        self.scale, self.dtype = gain / in_f ** 0.5, dtype
        self.kernel = nn.Parameter(torch.randn(in_f, features))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x):
        y = x.to(self.dtype) @ (self.kernel * self.scale).to(self.dtype)
        return y if self.bias is None else y + self.bias.to(self.dtype)


class EqualizedConv(Named):
    """flax EqualizedConv: a SAME Conv_0 with N(0, 1) weights on the input
    scaled by he_std = gain / sqrt(in_ch * kernel^2) (the convolution is
    linear, so this is the kernel scaled). The scale is a scalar of the
    input's dtype, as JAX's weakly typed Python float becomes."""

    def __init__(self, in_ch, features, kernel=3, stride=1, gain=2.0 ** 0.5,
                 use_bias=True, dtype=torch.float32):
        super().__init__()
        self.scale = gain / (in_ch * kernel * kernel) ** 0.5
        conv = self.child(Conv(in_ch, features, kernel, stride, use_bias,
                               dtype))
        nn.init.normal_(conv.weight)

    def forward(self, x):
        return self.Conv_0(x * torch.tensor(self.scale, dtype=x.dtype,
                                            device=x.device))
