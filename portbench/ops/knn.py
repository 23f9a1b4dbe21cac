"""Kernel 3, KNN (`csrc/knn.cu`): per pair, the dot (5), the norms' sum
and -2 dot (3) and one compare, in fp32; the keys (and other queries)
read, the int32 indices written."""

from __future__ import annotations

from portbench.roofline import bound, nbytes

ENTRY = ("pose_estimation_tpu_torch.ops.pointops", "knn")


def least(queries, keys, k, exclude_self=False) -> float:
    b, nq, _ = queries.shape
    nk = keys.shape[1]
    same = queries.data_ptr() == keys.data_ptr()
    return bound(nbytes(keys) + (0 if same else nbytes(queries))
                 + b * nq * k * 4, {"fp32": b * nq * nk * 9})
