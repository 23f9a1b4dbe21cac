"""Plain building blocks of the reference models, in float32.

Image maps are NCHW, point features [B, N, C]. A module takes a
`Precision`: the rounding applied wherever the measured program casts to
its activation dtype. Precision("fp32") rounds nothing, which is the
reference; Precision("fp8") rounds through float8 e4m3, which is the
control that the comparison has to reject. Children are registered as
'<ClassName>_<n>' in creation order, so a state dict of these modules has
the keys of the program's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

FP8_MAX = 448.0


class Precision:
    """Callable rounding of activations: 'fp32' (none), 'bf16' (its
    gradient rounded alike, as a bfloat16 backward rounds it) or 'fp8'
    (e4m3, saturating at its largest finite value). The result is
    fp32."""

    def __init__(self, mode: str = "fp32"):
        self.mode = mode

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if self.mode == "fp32":
            return x
        if self.mode == "bf16":
            return x.to(torch.bfloat16).float()
        if self.mode == "fp8":
            # straight through: float8 values forward, the gradient kept in
            # fp32 (an unscaled float8 gradient would underflow to 0)
            y = x.clamp(-FP8_MAX, FP8_MAX).to(torch.float8_e4m3fn).float()
            return x + (y - x).detach()
        raise ValueError(f"precision {self.mode!r}")


FP32 = Precision("fp32")


class Named(nn.Module):
    def __init__(self):
        super().__init__()
        self._counts: dict[str, int] = {}

    def child(self, module: nn.Module, cls_name: str | None = None):
        cls_name = cls_name or type(module).__name__
        n = self._counts.get(cls_name, 0)
        self._counts[cls_name] = n + 1
        self.add_module(f"{cls_name}_{n}", module)
        return module


def same_pads(size: int, k: int, stride: int, dilation: int = 1):
    """'SAME' padding (lo, hi): for an even input and stride 2 it is
    (0, 1)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + dilation * (k - 1) + 1 - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """2-D convolution with 'SAME' padding; weight [out, in, k, k]."""

    def __init__(self, in_ch, out_ch, kernel, stride=1, bias=True, q=FP32):
        super().__init__()
        self.stride, self.kernel, self.q = stride, kernel, q
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kernel, kernel))
        self.bias = nn.Parameter(torch.empty(out_ch)) if bias else None

    def forward(self, x):
        q = self.q
        x = q(x)
        ph = same_pads(x.shape[2], self.kernel, self.stride)
        pw = same_pads(x.shape[3], self.kernel, self.stride)
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
        b = None if self.bias is None else q(self.bias)
        return q(F.conv2d(x, q(self.weight), b, self.stride))


class ConvTranspose(nn.Module):
    """Stride-2 transposed convolution with 'SAME' padding, no bias; the
    weight [in, out, k, k] is correlated flipped, as conv_transpose2d
    does, and the output cropped to twice the input."""

    def __init__(self, in_ch, out_ch, kernel, q=FP32):
        super().__init__()
        self.kernel, self.q = kernel, q
        self.weight = nn.Parameter(torch.empty(in_ch, out_ch, kernel, kernel))
        self.lo = kernel - 1 if kernel - 1 < 2 else -(-kernel // 2)

    def forward(self, x):
        q = self.q
        x = q(x)
        h, w = x.shape[2] * 2, x.shape[3] * 2
        y = F.conv_transpose2d(x, q(self.weight), None, 2,
                               self.kernel - 1 - self.lo)
        return q(y[:, :, :h, :w])


class Dense(nn.Module):
    """Affine map over the last axis, weight [out, in]."""

    def __init__(self, in_f, out_f, q=FP32):
        super().__init__()
        self.q = q
        self.weight = nn.Parameter(torch.empty(out_f, in_f))
        self.bias = nn.Parameter(torch.empty(out_f))

    def forward(self, x):
        q = self.q
        return q(F.linear(q(x), q(self.weight), q(self.bias)))


class GroupNorm(nn.Module):
    """Group normalisation, eps 1e-6, statistics in fp32; NCHW maps or
    [B, N, C] point features (over N and the group's channels)."""

    eps = 1e-6

    def __init__(self, groups, channels, q=FP32):
        super().__init__()
        self.groups, self.q = groups, q
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        x = self.q(x)
        if x.ndim == 3:
            y = F.group_norm(x.transpose(1, 2), self.groups, self.weight,
                             self.bias, self.eps).transpose(1, 2)
        else:
            y = F.group_norm(x, self.groups, self.weight, self.bias,
                             self.eps)
        return self.q(y)


def groups_for(channels: int, groups: int = 32) -> int:
    g = min(groups, channels)
    while channels % g:
        g -= 1
    return g


class Norm(Named):
    """GroupNorm_0 (the configurations here use group normalisation)."""

    def __init__(self, channels, kind="gn", q=FP32):
        super().__init__()
        if kind != "gn":
            raise ValueError(f"norm {kind!r}: the reference has group "
                             "normalisation only")
        self.child(GroupNorm(groups_for(channels), channels, q))

    def forward(self, x):
        return self.GroupNorm_0(x)


def resize_bilinear(x, h, w):
    """Bilinear up-sampling with half-pixel centres."""
    if (h, w) == tuple(x.shape[2:]):
        return x
    return F.interpolate(x, size=(h, w), mode="bilinear",
                         align_corners=False)


def upsample2x(x):
    return resize_bilinear(x, x.shape[2] * 2, x.shape[3] * 2)


class ConvNorm(Named):
    def __init__(self, in_ch, features, kernel=3, stride=1, use_relu=True,
                 norm="gn", q=FP32):
        super().__init__()
        self.use_relu = use_relu
        self.child(Conv(in_ch, features, kernel, stride, False, q))
        self.child(Norm(features, norm, q))

    def forward(self, x):
        x = self.Norm_0(self.Conv_0(x))
        return torch.relu(x) if self.use_relu else x


class ConvTransposeNorm(Named):
    def __init__(self, in_ch, features, kernel=4, norm="gn", q=FP32):
        super().__init__()
        self.child(ConvTranspose(in_ch, features, kernel, q))
        self.child(Norm(features, norm, q))

    def forward(self, x):
        return torch.relu(self.Norm_0(self.ConvTranspose_0(x)))


class BasicBlock(Named):
    def __init__(self, in_ch, features, stride=1, norm="gn", q=FP32):
        super().__init__()
        self.q = q
        self.child(ConvNorm(in_ch, features, 3, stride, True, norm, q))
        self.child(ConvNorm(features, features, 3, 1, False, norm, q))
        self.project = stride != 1 or in_ch != features
        if self.project:
            self.child(ConvNorm(in_ch, features, 1, stride, False, norm, q))

    def forward(self, x):
        y = self.ConvNorm_1(self.ConvNorm_0(x))
        res = self.ConvNorm_2(x) if self.project else x
        return torch.relu(self.q(y + res))


class Bottleneck(Named):
    def __init__(self, in_ch, features, stride=1, norm="gn", q=FP32):
        super().__init__()
        self.q = q
        out_ch = features * 4
        self.child(ConvNorm(in_ch, features, 1, 1, True, norm, q))
        self.child(ConvNorm(features, features, 3, stride, True, norm, q))
        self.child(ConvNorm(features, out_ch, 1, 1, False, norm, q))
        self.project = stride != 1 or in_ch != out_ch
        if self.project:
            self.child(ConvNorm(in_ch, out_ch, 1, stride, False, norm, q))

    def forward(self, x):
        y = self.ConvNorm_2(self.ConvNorm_1(self.ConvNorm_0(x)))
        res = self.ConvNorm_3(x) if self.project else x
        return torch.relu(self.q(y + res))


class MLP1d(Named):
    """Per-point MLP over the channel axis of [B, N, C]."""

    def __init__(self, in_f, features, norm="gn", final_act=False, q=FP32):
        super().__init__()
        self.layers = []
        for i, f in enumerate(features):
            dense = self.child(Dense(in_f, f, q))
            last = i == len(features) - 1
            nrm = (self.child(Norm(f, norm, q))
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


def safe_norm(x, dim=-1, keepdim=False, eps=1e-8):
    return torch.sqrt(torch.clamp(torch.sum(x * x, dim=dim, keepdim=keepdim),
                                  min=eps * eps))


def safe_normalize(x, dim=-1, eps=1e-8):
    return x / safe_norm(x, dim=dim, keepdim=True, eps=eps)
