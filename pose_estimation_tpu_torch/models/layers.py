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

from pose_estimation_tpu_torch.ops import resize
from pose_estimation_tpu_torch.parallel import dist


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


def _same_pads(size: int, k: int, stride: int,
               dilation: int = 1) -> tuple[int, int]:
    """XLA 'SAME' padding (lo, hi) of a window of k taps `dilation`
    apart, over its extent dilation * (k - 1) + 1: for an even input and
    stride 2 it is (0, 1), not torch's symmetric (1, 1)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + dilation * (k - 1) + 1 - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """flax nn.Conv with padding 'SAME' (weight OIHW), kernel_dilation
    `dilation`."""

    def __init__(self, in_ch, out_ch, kernel, stride=1, bias=True,
                 dtype=torch.float32, dilation=1):
        super().__init__()
        self.stride, self.kernel, self.dtype = stride, kernel, dtype
        self.dilation = dilation
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None
        nn.init.kaiming_uniform_(self.weight, a=5 ** 0.5)

    def forward(self, x):
        x = x.to(self.dtype)
        ph = _same_pads(x.shape[2], self.kernel, self.stride, self.dilation)
        pw = _same_pads(x.shape[3], self.kernel, self.stride, self.dilation)
        if ph[0] == ph[1] and pw[0] == pw[1]:
            pad = (ph[0], pw[0])
        else:
            x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
            pad = 0
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(x, self.weight.to(self.dtype), b, self.stride, pad,
                        self.dilation)


def max_pool_same(x: torch.Tensor, k: int = 3, stride: int = 2
                  ) -> torch.Tensor:
    """NCHW nn.max_pool(x, (k, k), strides=(stride, stride),
    padding="SAME"): XLA's (lo, hi) padding with -inf, which on an even
    input is (0, 1), where max_pool2d(padding=1) would shift the windows
    by a pixel."""
    ph = _same_pads(x.shape[2], k, stride)
    pw = _same_pads(x.shape[3], k, stride)
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=float("-inf"))
    return F.max_pool2d(x, k, stride)


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
    in fp32, output in the compute dtype. Takes NCHW maps, [B, N, C]
    point features (normalised over N and the group's channels) or [B, C]
    vectors."""

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


class LayerNorm(nn.Module):
    """flax nn.LayerNorm over the last axis: eps 1e-6 (torch's default is
    1e-5), the statistics in fp32 with flax's fast variance E[x^2] -
    E[x]^2 clamped at 0, (x - mean) * (rsqrt(var + eps) * scale) + bias
    in fp32, the output in the compute dtype."""

    eps = 1e-6

    def __init__(self, features, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        mean = xf.mean(-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mean * mean,
                          min=0.0)
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.weight)
        return (y + self.bias).to(self.dtype)


def _groups(channels: int, groups: int = 32) -> int:
    g = min(groups, channels)
    while channels % g:
        g -= 1
    return g


class BatchNorm(nn.Module):
    """flax nn.BatchNorm(momentum=0.9), eps 1e-5, over the channel axis of
    NCHW maps (dim 1), [B, N, C] point features or [B, C] vectors (the
    last dim). In training (`self.training`, which KRRN sets from its
    `train` argument) it normalises with the batch statistics, in fp32 over
    every other axis, the variance E[x^2] - E[x]^2 clamped at 0 (flax's
    fast variance), and moves the running statistics to 0.9 running + 0.1
    batch with that biased variance; out of training it reads them and
    changes nothing. The output is in the compute dtype. Unlike
    nn.BatchNorm2d it keeps no num_batches_tracked and puts no unbiased
    variance in running_var: the state is flax's params and batch_stats,
    leaf for leaf (convert.py).

    Under a process group the training statistics are the global batch's,
    as in the JAX step (one program over the mesh): E[x] and E[x^2] of
    every rank, in one buffer a layer, are averaged over the group by
    dist.group_mean, whose backward averages the gradients that reach
    them, so the step's averaged gradient is the one-process gradient at
    the global batch. Every rank holds as many rows, so the mean of the
    ranks' means is the global mean. Eval reads the running statistics,
    with no collective."""

    momentum, eps = 0.9, 1e-5

    def __init__(self, channels, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x):
        x = x.to(self.dtype)
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        ch = 1 if x.ndim == 4 else x.ndim - 1
        axes = [d for d in range(x.ndim) if d != ch]
        shape = [-1 if d == ch else 1 for d in range(x.ndim)]
        if self.training:
            mean, meansq = xf.mean(axes), (xf * xf).mean(axes)
            if dist.is_initialized():
                c = mean.shape[0]
                mean, meansq = dist.group_mean(
                    torch.cat([mean, meansq])).split(c)
            var = torch.clamp(meansq - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean
                                        + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)
        return y.to(self.dtype)


class Norm(Named):
    """BatchNorm_0 for 'bn', else GroupNorm_0, as the JAX Norm."""

    def __init__(self, channels, kind="gn", groups=32, dtype=torch.float32):
        super().__init__()
        norm = (BatchNorm(channels, dtype) if kind == "bn" else
                GroupNorm(_groups(channels, groups), channels, dtype))
        self.child(norm)
        self.name = f"{type(norm).__name__}_0"

    def forward(self, x):
        return getattr(self, self.name)(x)


def resize_bilinear(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """NCHW bilinear up-sampling, jax.image.resize('bilinear') at any
    up-sampling ratio (PSPModule's 3 -> 32 and 6 -> 32 too): half-pixel
    centres, the same two source pixels and weights, and at the border
    jax's renormalised triangle kernel and torch's clamped source
    coordinate pick the same edge pixel; the two round the weights apart
    (tests/test_torch_pspnet.py holds them within 1e-5). The op is
    ops.resize's: F.interpolate on the CPU, the CUDA kernel on the card."""
    if h < x.shape[2] or w < x.shape[3]:
        raise ValueError("resize_bilinear: down-sampling differs from "
                         "jax.image.resize (antialiasing); not supported")
    if (h, w) == tuple(x.shape[2:]):
        return x
    return resize.resize_bilinear(x, h, w)


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
