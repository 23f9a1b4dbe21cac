"""Bilinear up-sampling of NCHW maps (half-pixel centres,
align_corners=False), contiguous or channels-last: a hand-written CUDA
kernel beside its plain version.

  resize_bilinear
           csrc/resize.cu (`pose_resize_bilinear`). It replaces no TPU
           kernel: the JAX package leaves jax.image.resize to XLA. Every
           resize of the port goes through it (models/layers.py): HRNet's
           fuse layers and its concat, the KRRN heads' and PSPNet's
           upsample2x, the UNet's up blocks and PSPNet's pyramid priors.
           ATen's kernel for a contiguous NCHW map runs one thread per
           output pixel of one plane, each walking all N * C planes: a few
           blocks on a card of 132 SMs at HRNet's small branches. The
           kernel cuts the whole output into chunks of 16 bytes, one a
           thread, and computes ATen's arithmetic in ATen's order, so it
           equals F.interpolate bit for bit, in the input's layout (the
           BatchNorm models' maps are channels-last from their NHWC
           input on, as with F.interpolate).

`resize_bilinear` is the wrapper: the plain version for CPU tensors, the
kernel for CUDA tensors (or an exception; there is no fallback), with
autograd's own backward (aten's upsample_bilinear2d_backward, what
F.interpolate's gradient runs). It counts its launches.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from pose_estimation_tpu_torch.ops import _build
from pose_estimation_tpu_torch.utils.profiling import spanned

# csrc/resize.cu's dtype codes
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
THREADS = 256
VECTOR_BYTES = 16


class LaunchPlan(NamedTuple):
    """The kernel's grid for one output of `total` elements: `blocks` of
    `threads` threads, thread t writing elements [t * vec, t * vec + vec)
    of the output in memory order (those below `total`); the last chunk
    holds `tail` elements, stored one by one, where `tail` > 0."""
    blocks: int
    threads: int
    vec: int
    tail: int
    total: int


def launch_plan(total: int, element_size: int) -> LaunchPlan:
    """The grid for an output of `total` elements of `element_size` bytes:
    16 bytes a thread, THREADS threads a block, as few blocks as cover the
    output."""
    vec = VECTOR_BYTES // element_size
    chunks = -(-total // vec)
    return LaunchPlan(-(-chunks // THREADS), THREADS, vec, total % vec, total)


def resize_bilinear_plain(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[N, C, H, W] -> [N, C, h, w]: F.interpolate, bilinear, half-pixel
    centres."""
    return F.interpolate(x, size=(h, w), mode="bilinear",
                         align_corners=False)


def _launch(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """The kernel on a contiguous map (N * C images of one lane) or a
    channels-last one (N images of C lanes); the output in its layout."""
    n, c, hi, wi = x.shape
    if x.is_contiguous():
        layout, images, lanes = torch.contiguous_format, n * c, 1
    else:
        layout, images, lanes = torch.channels_last, n, c
    out = torch.empty((n, c, h, w), dtype=x.dtype, device=x.device,
                      memory_format=layout)
    plan = launch_plan(out.numel(), x.element_size())
    rc = _build.launch(_build.library().pose_resize_bilinear, x.device,
                       x.data_ptr(), out.data_ptr(), images, lanes, hi, wi,
                       h, w, _DTYPES[x.dtype], plan.vec, plan.blocks,
                       plan.threads)
    _build.check(rc, "pose_resize_bilinear")
    resize_bilinear.launches += 1
    return out


class _Resize(torch.autograd.Function):
    """The kernel forward; the backward is the one autograd runs for
    F.interpolate (no TPU kernel stands behind either)."""

    @staticmethod
    def forward(ctx, x, h, w):
        ctx.in_size = tuple(x.shape)
        return _launch(x, h, w)

    @staticmethod
    def backward(ctx, g):
        gx = torch.ops.aten.upsample_bilinear2d_backward(
            g, list(g.shape[2:]), list(ctx.in_size), False, None, None)
        return gx, None, None


@spanned("op.resize_bilinear")
def resize_bilinear(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[N, C, H, W] -> [N, C, h, w], bilinear with half-pixel centres:
    F.interpolate(align_corners=False) at any ratio, differentiable in x."""
    if x.device.type == "cpu":
        return resize_bilinear_plain(x, h, w)
    if x.device.type != "cuda":
        raise ValueError(f"resize_bilinear: tensor on {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"resize_bilinear: float32, bfloat16 or float16, got "
                        f"{x.dtype}")
    if x.ndim != 4:
        raise ValueError(f"resize_bilinear: [N, C, H, W] maps, got "
                         f"{tuple(x.shape)}")
    if not (x.is_contiguous()
            or x.is_contiguous(memory_format=torch.channels_last)):
        raise ValueError("resize_bilinear: the map must be contiguous or "
                         "channels-last")
    if h < 1 or w < 1 or x.numel() == 0:
        raise ValueError(f"resize_bilinear: {tuple(x.shape)} -> ({h}, {w})")
    return _Resize.apply(x, h, w)


resize_bilinear.launches = 0
