"""K nearest neighbours: the hand-written CUDA kernel and its plain version.

Kernel: csrc/knn.cu (`pose_knn`). It replaces
pose_estimation_tpu/ops/pallas_pointops.py:_knn_kernel and serves both the
self searches of FusionNetLite (fusion.py:118,148,158) and the cross
searches of PoolLayer (gcn3d.py:146). What bounds it on the card, and its
design, are described at the top of the source.

`knn` is the wrapper: the plain PyTorch version for CPU tensors, the
kernel for CUDA tensors (or an exception; there is no fallback).
"""

from __future__ import annotations

import torch

from pose_estimation_tpu_torch.ops import _build


def sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(|a|^2 + |b|^2) - 2 a.b for [..., n, 3], [..., m, 3] -> [..., n, m],
    with the dot products summed as (x + y) + z: the kernel's order."""
    a0, a1, a2 = a[..., :, None, 0], a[..., :, None, 1], a[..., :, None, 2]
    b0, b1, b2 = b[..., None, :, 0], b[..., None, :, 1], b[..., None, :, 2]
    inner = a0 * b0 + a1 * b1 + a2 * b2
    na = a0 * a0 + a1 * a1 + a2 * a2
    nb = b0 * b0 + b1 * b1 + b2 * b2
    return (na + nb) - 2.0 * inner


def knn_plain(queries: torch.Tensor, keys: torch.Tensor, k: int,
              exclude_self: bool) -> torch.Tensor:
    """[B, m, 3], [B, n, 3] -> [B, m, k] int32: the kk = k (+1) smallest
    distances, ties to the lower index (a stable sort, as lax.top_k),
    then the first column dropped when exclude_self."""
    d = sqdist(queries, keys)
    kk = k + 1 if exclude_self else k
    idx = torch.sort(d, dim=-1, stable=True).indices[..., :kk]
    if exclude_self:
        idx = idx[..., 1:]
    return idx.to(torch.int32)


def knn(queries: torch.Tensor, keys: torch.Tensor, k: int,
        exclude_self: bool = False) -> torch.Tensor:
    """KNN indices [B, m, k] int32 of `keys` for each query."""
    if queries.device.type == "cpu" and keys.device.type == "cpu":
        return knn_plain(queries, keys, k, exclude_self)
    if queries.device.type != "cuda" or keys.device != queries.device:
        raise ValueError(f"knn: tensors on {queries.device} / {keys.device}")
    for name, t in (("queries", queries), ("keys", keys)):
        if t.dtype != torch.float32:
            raise TypeError(f"knn: {name} must be float32, got {t.dtype}")
        if t.ndim != 3 or t.shape[-1] != 3:
            raise ValueError(f"knn: {name} must be [B, n, 3], got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"knn: {name} must be contiguous")
    b, nq, _ = queries.shape
    nk = keys.shape[1]
    if keys.shape[0] != b:
        raise ValueError("knn: batch sizes differ")
    kk = k + 1 if exclude_self else k
    out = torch.empty((b, nq, k), dtype=torch.int32, device=queries.device)
    lib = _build.library()
    with torch.cuda.device(queries.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.pose_knn(queries.data_ptr(), keys.data_ptr(),
                          out.data_ptr(), b, nq, nk, kk,
                          1 if exclude_self else 0, stream)
    _build.check(rc, "pose_knn")
    knn.launches += 1
    return out


knn.launches = 0
