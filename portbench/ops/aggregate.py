"""Kernel 5, the wide-table aggregate (`csrc/gcn.cu` `wide_agg_kernel`):
inputs read once, the fp32 output written once; per (point, slot,
support, channel) a D-term dot (2D - 1), relu, product and max, then the
support sums: packed bf16x2 operations for a bf16 table, fp32 otherwise.
Without a table (the theta-only form, which launches kernel 2), one
stream of kernel 2's least time."""

from __future__ import annotations

import torch

from portbench.ops import surface_multi
from portbench.roofline import bound, nbytes

ENTRY = ("pose_estimation_tpu_torch.ops.gcn", "aggregate")


def least(nd, dirs, feats, idx, support_num) -> float:
    if feats is None:
        return surface_multi.least([nd], [dirs], support_num)
    b, n, k, d = nd.shape
    so, s = dirs.shape[-1], support_num
    kind = "bf16_packed" if feats.dtype == torch.bfloat16 else "fp32"
    return bound(nbytes(nd, dirs, feats, idx) + b * n * (so // s) * 4,
                 {kind: b * n * k * so * (2 * d + 2)
                  + b * n * (so // s) * (s - 1)})
