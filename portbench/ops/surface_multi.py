"""Kernel 2, the fused surface aggregate (`csrc/gcn.cu`
`surface_kernel`): per (point, slot, stream, support, channel) dot (5),
relu and max, then the support sums, in fp32; the fp32 output written
once."""

from __future__ import annotations

from portbench.roofline import bound, nbytes

ENTRY = ("pose_estimation_tpu_torch.ops.gcn", "surface_multi")


def least(nds, dirs_list, support_num) -> float:
    b, n, k, _ = nds[0].shape
    so, st, s = dirs_list[0].shape[-1], len(nds), support_num
    return bound(nbytes(*nds, *dirs_list) + b * n * st * (so // s) * 4,
                 {"fp32": b * n * k * st * so * 7
                  + b * n * st * (so // s) * (s - 1)})
