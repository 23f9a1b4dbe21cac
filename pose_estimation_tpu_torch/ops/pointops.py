"""Point-cloud kernels: K nearest neighbours and the nearest source point,
each a hand-written CUDA kernel beside its plain version.

  knn      csrc/knn.cu (`pose_knn`), replacing pose_estimation_tpu/ops/
           pallas_pointops.py:_knn_kernel: the self searches of
           FusionNetLite (fusion.py:118,148,158) and the cross searches of
           PoolLayer (gcn3d.py:146).
  nearest_multi
           csrc/min_dists.cu (`pose_min_dists`), replacing
           pallas_pointops.py:_min_dists_kernel: distance to and index of
           the nearest point of each of up to 4 source clouds that share
           the targets, in one launch. `nearest` is its one-cloud form;
           `min_dists` (ADD-S, the symmetric pose loss) puts that in a
           torch.autograd.Function; `nearest_index_multi` (the fusion nets'
           two up-sampling maps) takes the indices.
What bounds each kernel on the card, and its design, are described at the
top of its source. In short: the searches are small, and a sorted top-kk
per thread is bound by its insertions, so knn gives each query a group of
8-32 lanes (chosen to fill the card): a first scan bounds the kk-th
distance, a second keeps the few keys within the bound, and each keeps
the rank it has among them in (distance, index) order, ties to the lower
index; nearest_multi gives each target a group of 1-32 lanes (chosen to
fill the card) that split the sources, and merges their minima by warp
shuffles in torch.min's order.

`knn` and `nearest_multi` are the wrappers: the plain PyTorch version for
CPU tensors, the kernel for CUDA tensors (or an exception; there is no
fallback). Each counts its launches.
"""

from __future__ import annotations

import torch

from pose_estimation_tpu_torch.ops import _build
from pose_estimation_tpu_torch.ops.limits import KNN_MAX_KK
from pose_estimation_tpu_torch.utils.profiling import spanned


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


@spanned("op.knn")
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
    if not 1 <= kk <= min(KNN_MAX_KK, nk):
        raise ValueError(f"knn: the kernel takes 1 <= k{' + 1' * exclude_self}"
                         f" <= {KNN_MAX_KK} neighbours and no more than the "
                         f"{nk} keys, got k={k}")
    out = torch.empty((b, nq, k), dtype=torch.int32, device=queries.device)
    rc = _build.launch(_build.library().pose_knn, queries.device,
                       queries.data_ptr(), keys.data_ptr(), out.data_ptr(),
                       b, nq, nk, kk, 1 if exclude_self else 0)
    _build.check(rc, "pose_knn")
    knn.launches += 1
    return out


knn.launches = 0


def _check_clouds(name, target, sources):
    for t in [target, *sources]:
        if t.device.type != "cuda" or t.device != target.device:
            raise ValueError(f"{name}: tensors on {target.device} / "
                             f"{t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: clouds must be float32, got {t.dtype}")
        if t.ndim != 3 or t.shape[-1] != 3:
            raise ValueError(f"{name}: clouds must be [B, n, 3], got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: clouds must be contiguous")
        if t.shape[0] != target.shape[0]:
            raise ValueError(f"{name}: batch sizes differ")


# targets per block of nearest_plain: its [B, chunk, m] distances and their
# temporaries stay bounded (the transparent loss has n = 500,000)
NEAREST_PLAIN_CHUNK = 1 << 16


def nearest_plain(target: torch.Tensor, source: torch.Tensor,
                  eps: float = 1e-8, chunk: int = NEAREST_PLAIN_CHUNK):
    """[B, n, 3], [B, m, 3] -> (sqrt(max(min_j d, eps^2)) [B, n] fp32,
    argmin_j d [B, n] int32), d the expanded-form squared distance of
    `sqdist`; ties go to the lower index (torch.min, like jnp.argmin).
    The targets go in blocks of `chunk`: each row's minimum stands alone,
    so the result is the same bits for any chunk."""
    dists, idxs = [], []
    for t in target.split(chunk, dim=1):
        best, idx = torch.min(sqdist(t, source), dim=-1)
        dists.append(torch.sqrt(torch.clamp(best, min=eps * eps)))
        idxs.append(idx.to(torch.int32))
    if len(dists) == 1:
        return dists[0], idxs[0]
    return torch.cat(dists, 1), torch.cat(idxs, 1)


def nearest_multi_plain(target: torch.Tensor, sources, eps: float = 1e-8):
    """nearest_plain of `target` against each source cloud in turn."""
    return [nearest_plain(target, s, eps) for s in sources]


# source clouds per launch (csrc/min_dists.cu MD_MAX_CLOUDS)
_MAX_CLOUDS = 4


@spanned("op.nearest_multi")
def nearest_multi(target: torch.Tensor, sources, eps: float = 1e-8):
    """Distance to, and index of, the nearest point of each source cloud
    for every target, all clouds in one launch: a list of ([B, n] fp32,
    [B, n] int32), one pair per cloud. No gradient: `min_dists` carries
    one."""
    sources = list(sources)
    if target.device.type == "cpu" and all(s.device.type == "cpu"
                                           for s in sources):
        return nearest_multi_plain(target, sources, eps)
    if not 1 <= len(sources) <= _MAX_CLOUDS:
        raise ValueError(f"nearest_multi: 1 to {_MAX_CLOUDS} source clouds, "
                         f"got {len(sources)}")
    _check_clouds("nearest_multi", target, sources)
    b, n, _ = target.shape
    c = len(sources)
    dist = torch.empty((c, b, n), dtype=torch.float32, device=target.device)
    idx = torch.empty((c, b, n), dtype=torch.int32, device=target.device)
    pad = [None] * (_MAX_CLOUDS - c)
    rc = _build.launch(_build.library().pose_min_dists, target.device,
                       target.data_ptr(), *[s.data_ptr() for s in sources],
                       *pad, *[s.shape[1] for s in sources], *([0] * len(pad)),
                       c, dist.data_ptr(), idx.data_ptr(), b, n, eps * eps)
    _build.check(rc, "pose_min_dists")
    nearest_multi.launches += 1
    return list(zip(dist.unbind(0), idx.unbind(0)))


nearest_multi.launches = 0


def nearest(target: torch.Tensor, source: torch.Tensor, eps: float = 1e-8):
    """Distance to, and index of, the nearest source point of each target:
    ([B, n] fp32, [B, n] int32); nearest_multi with one cloud."""
    return nearest_multi(target, [source], eps)[0]


def nearest_index(target: torch.Tensor, source: torch.Tensor) -> torch.Tensor:
    """Index [B, n] int32 of the nearest source point of each target."""
    return nearest(target, source)[1]


def nearest_index_multi(target: torch.Tensor, sources) -> list:
    """Indices [B, n] int32 of the nearest point of each source cloud, one
    launch for all clouds."""
    return [i for _, i in nearest_multi(target, sources)]


class _MinDists(torch.autograd.Function):
    """min_dists with the gradient jax.grad gives through
    neighbors.min_dists (sqrt(max(min_j d, eps^2)), d in expanded form):

      d target_i = g_i (t_i - s_idx_i) / dist_i   where best_i > eps^2,
                   0 where the clamp is active;
      d source   = -(d target), scatter-added at idx.

    The divisor is the forward's own distance, and best_i is recomputed in
    the forward's operation order, so the clamp test sees the value the
    forward clamped. Exactly tied minima: JAX splits the gradient evenly
    between them, this form gives it all to the lower index."""

    @staticmethod
    def forward(ctx, target, source, eps):
        dist, idx = nearest(target, source, eps)
        ctx.save_for_backward(target, source, dist, idx)
        ctx.eps = eps
        return dist

    @staticmethod
    def backward(ctx, g):
        target, source, dist, idx = ctx.saved_tensors
        rows = idx.long()[..., None].expand(-1, -1, 3)
        s = torch.gather(source, 1, rows)
        t0, t1, t2 = target.unbind(-1)
        s0, s1, s2 = s.unbind(-1)
        best = ((t0 * t0 + t1 * t1 + t2 * t2) + (s0 * s0 + s1 * s1 + s2 * s2)
                - 2.0 * (t0 * s0 + t1 * s1 + t2 * s2))
        live = (best > ctx.eps * ctx.eps)[..., None]
        gt = torch.where(live, g[..., None] * (target - s) / dist[..., None],
                         torch.zeros_like(target))
        gs = None
        if ctx.needs_input_grad[1]:
            gs = torch.zeros_like(source).scatter_add_(1, rows, -gt)
        return (gt if ctx.needs_input_grad[0] else None), gs, None


def min_dists(target: torch.Tensor, source: torch.Tensor,
              eps: float = 1e-8) -> torch.Tensor:
    """Distance [B, n] from each target point to its nearest source point,
    clamped at eps inside the sqrt (grad-safe at coincident points);
    differentiable in both clouds."""
    return _MinDists.apply(target, source, eps)
