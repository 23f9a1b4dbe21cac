"""Kernel 6, bilinear up-sampling of NCHW maps (`csrc/resize.cu`): bytes
only, the input read once and the [N, C, h, w] output written once in
the input's dtype (`chip_smoke.py:check_resize`'s bound)."""

from __future__ import annotations

from portbench.roofline import bound, nbytes

ENTRY = ("pose_estimation_tpu_torch.ops.resize", "resize_bilinear")


def least(x, h, w) -> float:
    n, c = x.shape[:2]
    return bound(nbytes(x) + n * c * h * w * x.element_size(), {})
