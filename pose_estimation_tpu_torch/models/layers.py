"""Shared building blocks (counterpart of models/layers.py).

Layout: image maps are NCHW inside the port's modules (the KRRN forward
takes and returns NHWC like the JAX package); point features are
[B, N, C]. Every module takes the compute `dtype` the way flax does: its
input and its weights are cast to it, parameters stay fp32.

Submodules are registered under flax's automatic names (Conv_0,
ConvNorm_1, ...) in flax's creation order, so the parameter tree is the
JAX one key for key and convert.flax_to_torch is a renaming plus the
layout changes of each leaf.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


class Named(nn.Module):
    """nn.Module that names its children like flax's compact modules:
    '<ClassName>_<n>' in creation order."""

    def __init__(self):
        super().__init__()
        self._counts: dict[str, int] = {}

    def child(self, module: nn.Module, cls_name: str | None = None):
        cls_name = cls_name or type(module).__name__
        n = self._counts.get(cls_name, 0)
        self._counts[cls_name] = n + 1
        self.add_module(f"{cls_name}_{n}", module)
        return module


def _same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """XLA 'SAME' padding (lo, hi): for an even input and stride 2 it is
    (0, 1), not torch's symmetric (1, 1)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """flax nn.Conv with padding 'SAME' (weight OIHW)."""

    def __init__(self, in_ch, out_ch, kernel, stride=1, bias=True,
                 dtype=torch.float32):
        super().__init__()
        self.stride, self.kernel, self.dtype = stride, kernel, dtype
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None
        nn.init.kaiming_uniform_(self.weight, a=5 ** 0.5)

    def forward(self, x):
        x = x.to(self.dtype)
        ph = _same_pads(x.shape[2], self.kernel, self.stride)
        pw = _same_pads(x.shape[3], self.kernel, self.stride)
        if ph[0] == ph[1] and pw[0] == pw[1]:
            pad = (ph[0], pw[0])
        else:
            x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
            pad = 0
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(x, self.weight.to(self.dtype), b, self.stride, pad)


class ConvTranspose(nn.Module):
    """flax nn.ConvTranspose(k, strides=2, padding='SAME') without bias.

    lax pads the dilated input by (lo, hi) = (2, 2) for k = 4 and (2, 1)
    for k = 3 and correlates with the kernel as stored; torch's
    conv_transpose2d correlates with the spatially flipped kernel, so the
    weight here is the flax kernel flipped in both axes, [in, out, kh, kw]
    (convert.py does the flip). conv_transpose2d with padding k-1-lo pads
    (lo, lo); the output is cropped to 2x the input, which drops the extra
    row and column where hi < lo."""

    def __init__(self, in_ch, out_ch, kernel, dtype=torch.float32):
        super().__init__()
        self.kernel, self.dtype = kernel, dtype
        self.weight = nn.Parameter(torch.empty(in_ch, out_ch, kernel, kernel))
        nn.init.kaiming_uniform_(self.weight, a=5 ** 0.5)
        pad_len = kernel + 2 - 2
        self.lo = kernel - 1 if 2 > kernel - 1 else -(-pad_len // 2)

    def forward(self, x):
        x = x.to(self.dtype)
        h, w = x.shape[2] * 2, x.shape[3] * 2
        y = F.conv_transpose2d(x, self.weight.to(self.dtype), None, 2,
                               self.kernel - 1 - self.lo)
        return y[:, :, :h, :w]


class Dense(nn.Linear):
    """flax nn.Dense over the last axis (weight [out, in])."""

    def __init__(self, in_f, out_f, dtype=torch.float32):
        super().__init__(in_f, out_f)
        self.dtype = dtype

    def forward(self, x):
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype),
                        self.bias.to(self.dtype))


class GroupNorm(nn.GroupNorm):
    """flax nn.GroupNorm: eps 1e-6 (torch's default is 1e-5), statistics
    in fp32, output in the compute dtype. Takes NCHW maps or [B, N, C]
    point features (normalised over N and the group's channels)."""

    def __init__(self, groups, channels, dtype=torch.float32):
        super().__init__(groups, channels, eps=1e-6)
        self.dtype = dtype

    def forward(self, x):
        xf = x.to(self.dtype).float()
        if x.ndim == 3:
            y = F.group_norm(xf.transpose(1, 2), self.num_groups,
                             self.weight, self.bias, self.eps).transpose(1, 2)
        else:
            y = F.group_norm(xf, self.num_groups, self.weight, self.bias,
                             self.eps)
        return y.to(self.dtype)


def _groups(channels: int, groups: int = 32) -> int:
    g = min(groups, channels)
    while channels % g:
        g -= 1
    return g


class Norm(Named):
    """'gn' only in the port (the 'bn' parity option is not ported)."""

    def __init__(self, channels, kind="gn", groups=32, dtype=torch.float32):
        super().__init__()
        if kind != "gn":
            raise NotImplementedError(f"norm={kind!r}: only 'gn' is ported")
        self.child(GroupNorm(_groups(channels, groups), channels, dtype))

    def forward(self, x):
        return self.GroupNorm_0(x)


def resize_bilinear(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """NCHW bilinear up-sampling. For integer up-sampling ratios this is
    jax.image.resize('bilinear'): half-pixel centres, and at the border
    jax's renormalised triangle kernel and torch's clamped source
    coordinate pick the same edge pixel."""
    if h < x.shape[2] or w < x.shape[3]:
        raise ValueError("resize_bilinear: down-sampling differs from "
                         "jax.image.resize (antialiasing); not supported")
    if (h, w) == tuple(x.shape[2:]):
        return x
    return F.interpolate(x, size=(h, w), mode="bilinear",
                         align_corners=False)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    return resize_bilinear(x, x.shape[2] * 2, x.shape[3] * 2)


class ConvNorm(Named):
    """Conv (no bias) + Norm + optional ReLU."""

    def __init__(self, in_ch, features, kernel=3, stride=1, use_relu=True,
                 norm="gn", dtype=torch.float32):
        super().__init__()
        self.use_relu = use_relu
        self.child(Conv(in_ch, features, kernel, stride, False, dtype))
        self.child(Norm(features, norm, dtype=dtype))

    def forward(self, x):
        x = self.Norm_0(self.Conv_0(x))
        return torch.relu(x) if self.use_relu else x


class ConvTransposeNorm(Named):
    """Stride-2 ConvTranspose + Norm + ReLU."""

    def __init__(self, in_ch, features, kernel=4, norm="gn",
                 dtype=torch.float32):
        super().__init__()
        self.child(ConvTranspose(in_ch, features, kernel, dtype))
        self.child(Norm(features, norm, dtype=dtype))

    def forward(self, x):
        return torch.relu(self.Norm_0(self.ConvTranspose_0(x)))


class BasicBlock(Named):
    """Two 3x3 ConvNorms + residual (1x1 projection when shapes differ)."""

    def __init__(self, in_ch, features, stride=1, norm="gn",
                 dtype=torch.float32):
        super().__init__()
        self.child(ConvNorm(in_ch, features, 3, stride, True, norm, dtype))
        self.child(ConvNorm(features, features, 3, 1, False, norm, dtype))
        self.project = stride != 1 or in_ch != features
        if self.project:
            self.child(ConvNorm(in_ch, features, 1, stride, False, norm,
                                dtype))

    def forward(self, x):
        y = self.ConvNorm_1(self.ConvNorm_0(x))
        res = self.ConvNorm_2(x) if self.project else x
        return torch.relu(y + res)


class Bottleneck(Named):
    """1x1 -> 3x3 -> 1x1 (x4) + residual."""

    def __init__(self, in_ch, features, stride=1, norm="gn",
                 dtype=torch.float32):
        super().__init__()
        out_ch = features * 4
        self.child(ConvNorm(in_ch, features, 1, 1, True, norm, dtype))
        self.child(ConvNorm(features, features, 3, stride, True, norm, dtype))
        self.child(ConvNorm(features, out_ch, 1, 1, False, norm, dtype))
        self.project = stride != 1 or in_ch != out_ch
        if self.project:
            self.child(ConvNorm(in_ch, out_ch, 1, stride, False, norm, dtype))

    def forward(self, x):
        y = self.ConvNorm_2(self.ConvNorm_1(self.ConvNorm_0(x)))
        res = self.ConvNorm_3(x) if self.project else x
        return torch.relu(y + res)


class MLP1d(Named):
    """Per-point MLP over the channel axis of [B, N, C]."""

    def __init__(self, in_f, features: Sequence[int], norm="gn",
                 final_act=False, dtype=torch.float32):
        super().__init__()
        self.layers = []
        for i, f in enumerate(features):
            dense = self.child(Dense(in_f, f, dtype))
            last = i == len(features) - 1
            nrm = (self.child(Norm(f, norm, dtype=dtype))
                   if norm and (not last or final_act) else None)
            self.layers.append((dense, nrm, not last or final_act))
            in_f = f

    def forward(self, x):
        for dense, nrm, act in self.layers:
            x = dense(x)
            if act:
                if nrm is not None:
                    x = nrm(x)
                x = torch.relu(x)
        return x
