"""Fused 3D-GCN aggregates: the hand-written CUDA kernels and their plain
versions.

  surface_multi  out_si = sum_s max_k relu(nd_si . dirs_si)
                 kernel csrc/gcn.cu:surface_kernel, replacing
                 pose_estimation_tpu/ops/pallas_gcn.py:_surface_multi_kernel
  linear_multi   out_si = sum_s max_k relu(nd_si . dirs_si)
                                     * (X_si[idx] @ W_si + b_si)
                 kernels csrc/gcn.cu:table_kernel + linear_agg_kernel,
                 replacing pallas_gcn.py:_linear_multi_kernel
  aggregate_linear / aggregate
                 the per-stream forms (gcn_aggregate_linear / gcn_aggregate
                 of the JAX package), plain PyTorch: level 2's 9-D
                 ConvLayers and the wide ConvLayer path use them.

Streams share one KNN graph idx [B, N, K]. Inputs: nds list of [B, N, K, D]
unit directions, dirs_list list of [D, S*O] normalised kernels, xs list of
[B, M, Cin], ws list of [Cin, S*O], bs list of [S*O]. Outputs: list of
[B, N, O] float32.

Numerics (the plain versions define them; the kernels follow them):
  surface  nd and dirs rounded to bf16, theta = bf16(fp32 dot), the sum
           over supports in fp32 rounded to bf16 - what the JAX package's
           XLA path computes (_fwd_xla runs theta-only aggregates in bf16).
  linear   inputs in the dtype of xs (fp32 or bf16); the support table
           T = X @ W + b accumulates in fp32 and is stored in that dtype;
           theta, the product, the max and the sum are fp32.
Dot products of 3 terms are summed as (x + y) + z, supports in order.

The wrappers take the plain version for CPU tensors only; a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import torch

from pose_estimation_tpu_torch.ops import _build

_BF16 = torch.bfloat16


def _theta(nd_k: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """relu(<nd_k, dirs>) for nd_k [B, N, D] and dirs [D, C] -> [B, N, C],
    summed over D from the first term on (the kernels' order)."""
    acc = nd_k[..., 0:1] * dirs[0]
    for d in range(1, dirs.shape[0]):
        acc = acc + nd_k[..., d:d + 1] * dirs[d]
    return acc


def _sum_supports(acc: torch.Tensor, support_num: int) -> torch.Tensor:
    parts = acc.reshape(*acc.shape[:-1], support_num, -1)
    out = parts[..., 0, :]
    for s in range(1, support_num):
        out = out + parts[..., s, :]
    return out


def _rows(table: torch.Tensor, idx_k: torch.Tensor) -> torch.Tensor:
    """table [B, M, C], idx_k [B, N] -> [B, N, C]."""
    i = idx_k.to(torch.int64)[..., None].expand(*idx_k.shape,
                                                table.shape[-1])
    return torch.gather(table, 1, i)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def surface_multi_plain(nds, dirs_list, support_num: int):
    outs = []
    for nd, dirs in zip(nds, dirs_list):
        nd = nd.to(_BF16).float()
        dirs = dirs.to(_BF16).float()
        acc = None
        for kk in range(nd.shape[2]):
            th = torch.relu(_theta(nd[:, :, kk], dirs).to(_BF16).float())
            acc = th if acc is None else torch.maximum(acc, th)
        outs.append(_sum_supports(acc, support_num).to(_BF16).float())
    return outs


def linear_multi_plain(nds, dirs_list, xs, ws, bs, idx, support_num: int):
    dt = xs[0].dtype
    outs = []
    for nd, dirs, x, w, b in zip(nds, dirs_list, xs, ws, bs):
        table = (x.to(dt).float() @ w.to(dt).float() + b.float()).to(dt)
        nd = nd.to(dt).float()
        dirs = dirs.to(dt).float()
        acc = None
        for kk in range(idx.shape[-1]):
            th = torch.relu(_theta(nd[:, :, kk], dirs))
            val = th * _rows(table, idx[..., kk]).float()
            acc = val if acc is None else torch.maximum(acc, val)
        outs.append(_sum_supports(acc, support_num))
    return outs


def aggregate_linear(nd, dirs, x, w_support, b_support, idx,
                     support_num: int) -> torch.Tensor:
    """One stream of linear_multi for any direction dim D (level 2's 9-D
    ConvLayers): the XLA gcn_aggregate_linear, with arithmetic in x's
    dtype like the JAX package. Plain PyTorch on every device."""
    dt = x.dtype
    nd, dirs = nd.to(dt), dirs.to(dt)
    w_support, b_support = w_support.to(dt), b_support.to(dt)
    acc = None
    for kk in range(idx.shape[-1]):
        th = torch.relu(_theta(nd[:, :, kk], dirs))
        val = th * (_rows(x, idx[..., kk]) @ w_support + b_support)
        acc = val if acc is None else torch.maximum(acc, val)
    return _sum_supports(acc, support_num).float()


def aggregate(nd, dirs, feats, idx, support_num: int) -> torch.Tensor:
    """One stream of the wide-table aggregate (the XLA gcn_aggregate):
    feats [B, M, S*O] support table gathered per slot. Plain PyTorch."""
    dt = feats.dtype
    nd, dirs = nd.to(dt), dirs.to(dt)
    acc = None
    for kk in range(idx.shape[-1]):
        val = torch.relu(_theta(nd[:, :, kk], dirs)) * _rows(
            feats, idx[..., kk])
        acc = val if acc is None else torch.maximum(acc, val)
    return _sum_supports(acc, support_num).float()


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _on_cpu(*ts) -> bool:
    return all(t.device.type == "cpu" for t in ts)


def _check_cuda(name, ts, dev):
    for t in ts:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")


def surface_multi(nds, dirs_list, support_num: int):
    """Multi-stream ConvSurface aggregate -> list of [B, N, O] fp32."""
    if _on_cpu(*nds, *dirs_list):
        return surface_multi_plain(nds, dirs_list, support_num)
    dev = nds[0].device
    _check_cuda("surface_multi", list(nds) + list(dirs_list), dev)
    streams = len(nds)
    b, n, k, d = nds[0].shape
    so = dirs_list[0].shape[-1]
    if d != 3 or any(t.shape != nds[0].shape for t in nds):
        raise ValueError("surface_multi: nds must share one [B, N, K, 3] shape")
    if any(t.shape != (3, so) for t in dirs_list) or so % support_num:
        raise ValueError("surface_multi: dirs must be [3, S*O]")
    for t in list(nds) + list(dirs_list):
        if t.dtype not in (torch.float32, _BF16):
            raise TypeError(f"surface_multi: dtype {t.dtype}")
    o = so // support_num
    nd = torch.stack(nds, dim=3).to(_BF16).contiguous()       # [B,N,K,St,3]
    dirs = torch.stack(dirs_list).to(_BF16).contiguous()      # [St,3,S*O]
    out = torch.empty((b, n, streams * o), dtype=torch.float32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        rc = lib.pose_gcn_surface(nd.data_ptr(), dirs.data_ptr(),
                                  out.data_ptr(), b * n, k, streams,
                                  support_num, o,
                                  torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "pose_gcn_surface")
    surface_multi.launches += 1
    return [out[..., si * o:(si + 1) * o] for si in range(streams)]


surface_multi.launches = 0


def linear_multi(nds, dirs_list, xs, ws, bs, idx, support_num: int):
    """Multi-stream narrow ConvLayer aggregate sharing one gather ->
    list of [B, N, O] fp32."""
    ts = list(nds) + list(dirs_list) + list(xs) + list(ws) + list(bs) + [idx]
    if _on_cpu(*ts):
        return linear_multi_plain(nds, dirs_list, xs, ws, bs, idx,
                                  support_num)
    dev = idx.device
    _check_cuda("linear_multi", ts, dev)
    dt = xs[0].dtype
    if dt not in (torch.float32, _BF16):
        raise TypeError(f"linear_multi: dtype {dt}")
    if idx.dtype != torch.int32 or idx.ndim != 3 or not idx.is_contiguous():
        raise ValueError("linear_multi: idx must be contiguous [B, N, K] int32")
    streams = len(nds)
    b, n, k = idx.shape
    m, cin = xs[0].shape[1], xs[0].shape[2]
    so = ws[0].shape[-1]
    if any(t.shape != (b, n, k, 3) for t in nds):
        raise ValueError("linear_multi: nds must be [B, N, K, 3]")
    if any(t.shape != (b, m, cin) or t.dtype != dt for t in xs):
        raise ValueError("linear_multi: xs must share one [B, M, Cin] shape "
                         "and dtype")
    if (any(t.shape != (cin, so) for t in ws)
            or any(t.shape != (so,) for t in bs)
            or any(t.shape != (3, so) for t in dirs_list)
            or so % support_num):
        raise ValueError("linear_multi: ws [Cin, S*O], bs [S*O], dirs "
                         "[3, S*O] expected")
    o = so // support_num
    nd = torch.stack(nds, dim=3).to(dt).contiguous()          # [B,N,K,St,3]
    dirs = torch.stack(dirs_list).to(dt).contiguous()         # [St,3,S*O]
    x = torch.cat(xs, dim=-1).contiguous()                    # [B,M,St*Cin]
    w = torch.stack(ws).to(dt).contiguous()                   # [St,Cin,S*O]
    bias = torch.stack(bs).float().contiguous()               # [St,S*O]
    table = torch.empty((b, m, streams, so), dtype=dt, device=dev)
    out = torch.empty((b, n, streams * o), dtype=torch.float32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        rc = lib.pose_gcn_linear(
            idx.data_ptr(), nd.data_ptr(), dirs.data_ptr(), x.data_ptr(),
            w.data_ptr(), bias.data_ptr(), table.data_ptr(), out.data_ptr(),
            b, n, m, k, streams, cin, support_num, o,
            1 if dt == _BF16 else 0, torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "pose_gcn_linear")
    linear_multi.launches += 1
    return [out[..., si * o:(si + 1) * o] for si in range(streams)]


linear_multi.launches = 0
