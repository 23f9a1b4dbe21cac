"""Kernel 1, the fused linear aggregate (`csrc/gcn.cu`): the support
table X @ W + b once per point (a bf16 table on the tensor cores, fp32 on
the CUDA cores), then per (point, slot, stream, support, channel) dot
(5), relu, product and max, and the support sums; inputs read once, the
fp32 output written once."""

from __future__ import annotations

import torch

from portbench.roofline import bound, nbytes

ENTRY = ("pose_estimation_tpu_torch.ops.gcn", "linear_multi")


def least(nds, dirs_list, xs, ws, bs, idx, support_num) -> float:
    b, n, k = idx.shape
    m, cin = xs[0].shape[1:]
    so, st, s = ws[0].shape[-1], len(nds), support_num
    table = "bf16_tensor" if xs[0].dtype == torch.bfloat16 else "fp32"
    ops = {"fp32": b * n * k * st * so * 8 + b * n * st * (so // s) * (s - 1)
           + b * m * st * so}
    ops[table] = ops.get(table, 0) + 2 * b * m * cin * so * st
    return bound(nbytes(*nds, *dirs_list, *xs, *ws, *bs, idx)
                 + b * n * st * (so // s) * 4, ops)
