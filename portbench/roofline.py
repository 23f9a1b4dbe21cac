"""The least time the card could take for an op call, from the call's own
shapes (the arithmetic of chip_smoke.py's `bound`, `linear_bytes`,
`linear_ops` and `aggregate_bound`, and of its KNN, nearest-source and
surface checks, frozen here): the larger of the bytes over the memory
rate (each input read once, each output written once) and the operations
over the peak rate of their type. Published peaks of one NVIDIA H100 SXM
(dense): 3.35 TB/s; 67 TFLOP/s fp32 outside the tensor cores; 989
TFLOP/s bf16 on the tensor cores; 133.8 T/s packed bf16x2 on the CUDA
cores."""

from __future__ import annotations

import torch

HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"fp32": 67e12, "bf16_tensor": 989e12, "bf16_packed": 133.8e12}
BF16_DENSE_FLOP_S = 989e12


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound(n_bytes: float, ops: dict) -> float:
    """Seconds: max(bytes / HBM rate, sum of ops / their peak rate)."""
    t_ops = sum(n / PEAK_OPS_S[kind] for kind, n in ops.items())
    return max(n_bytes / HBM_BYTES_S, t_ops)


def knn_bound(queries, keys, k, exclude_self=False) -> float:
    """Per pair: dot (5), the norms' sum and -2 dot (3), one compare; the
    keys (and other queries) read, the int32 indices written."""
    b, nq, _ = queries.shape
    nk = keys.shape[1]
    same = queries.data_ptr() == keys.data_ptr()
    return bound(nbytes(keys) + (0 if same else nbytes(queries))
                 + b * nq * k * 4, {"fp32": b * nq * nk * 9})


def nearest_bound(target, sources, eps=1e-8) -> float:
    """Per pair as knn_bound; a distance and an index written per target
    and source cloud."""
    b, n, _ = target.shape
    m = sum(s.shape[1] for s in sources)
    return bound(nbytes(target, *sources) + len(sources) * b * n * 8,
                 {"fp32": b * n * m * 9})


def surface_bound(nds, dirs_list, support_num) -> float:
    """Per (point, slot, stream, support, channel): dot (5), relu, max;
    then the support sums; the fp32 output written once."""
    b, n, k, _ = nds[0].shape
    so, st, s = dirs_list[0].shape[-1], len(nds), support_num
    return bound(nbytes(*nds, *dirs_list) + b * n * st * (so // s) * 4,
                 {"fp32": b * n * k * st * so * 7
                  + b * n * st * (so // s) * (s - 1)})


def linear_bound(nds, dirs_list, xs, ws, bs, idx, support_num) -> float:
    """The support table X @ W + b once per point (a bf16 table on the
    tensor cores, fp32 on the CUDA cores), then per (point, slot, stream,
    support, channel) dot (5), relu, product and max, and the support
    sums; inputs read once, the fp32 output written once."""
    b, n, k = idx.shape
    m, cin = xs[0].shape[1:]
    so, st, s = ws[0].shape[-1], len(nds), support_num
    table = "bf16_tensor" if xs[0].dtype == torch.bfloat16 else "fp32"
    ops = {"fp32": b * n * k * st * so * 8 + b * n * st * (so // s) * (s - 1)
           + b * m * st * so}
    ops[table] = ops.get(table, 0) + 2 * b * m * cin * so * st
    return bound(nbytes(*nds, *dirs_list, *xs, *ws, *bs, idx)
                 + b * n * st * (so // s) * 4, ops)


def aggregate_bound(nd, dirs, feats, idx, support_num) -> float:
    """Inputs read once, the fp32 output written once; per (point, slot,
    support, channel) a D-term dot (2D - 1), relu, product and max, then
    the support sums: packed bf16x2 operations for a bf16 table, fp32
    otherwise. Without a table, one stream of surface_bound."""
    if feats is None:
        return surface_bound([nd], [dirs], support_num)
    b, n, k, d = nd.shape
    so, s = dirs.shape[-1], support_num
    kind = "bf16_packed" if feats.dtype == torch.bfloat16 else "fp32"
    return bound(nbytes(nd, dirs, feats, idx) + b * n * (so // s) * 4,
                 {kind: b * n * k * so * (2 * d + 2)
                  + b * n * (so // s) * (s - 1)})


# op entry point -> least seconds of a call, from its arguments
BOUNDS = {"linear_multi": linear_bound, "surface_multi": surface_bound,
          "aggregate": aggregate_bound, "knn": knn_bound,
          "nearest_multi": nearest_bound}
