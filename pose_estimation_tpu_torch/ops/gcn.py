"""Fused 3D-GCN aggregates: the hand-written CUDA kernels and their plain
versions.

  surface_multi  out_si = sum_s max_k relu(nd_si . dirs_si)
                 kernel csrc/gcn.cu:surface_kernel, replacing
                 pose_estimation_tpu/ops/pallas_gcn.py:_surface_multi_kernel:
                 a block per stream and tile of points with the tile's nd in
                 shared memory, a thread per 2 channels of all supports
                 with its direction weights in registers, bound by the fp32
                 issue rate; it reads each stream's tensors as they come
  linear_multi   out_si = sum_s max_k relu(nd_si . dirs_si)
                                     * (X_si[idx] @ W_si + b_si)
                 replacing pallas_gcn.py:_linear_multi_kernel with two
                 passes: the support table X @ W + b once per point
                 (csrc/gcn.cu:table_wgmma_kernel on the tensor cores in
                 bf16, bound by writing the table; table_kernel on the
                 CUDA cores in fp32), then linear_agg_kernel, bound by
                 gathering K table rows per point from L2 and by the fp32
                 issue rate: each thread reads 16 bytes of a row per slot
                 with several slots' loads in flight
  aggregate      out = sum_s max_k relu(nd . dirs) * F[idx], one stream,
                 D = 3 or 9, the support table F [B, M, S*O] given
                 kernel csrc/gcn.cu:wide_agg_kernel, replacing
                 pallas_gcn.py:_agg_kernel (gcn_aggregate of the JAX
                 package): the wide ConvLayer path (the full FusionNet's
                 fm_4 at S <= 3). A thread owns 16 bytes of a table row
                 and gathers them with 16-byte loads, several slots in
                 flight; bf16 runs as packed bf16x2 arithmetic. It reads
                 nd, dirs and a strided table as they come. Without a
                 table it is one stream of surface_multi (ConvSurface
                 called without parts).
  aggregate_linear
                 the per-stream narrow form (gcn_aggregate_linear of the
                 JAX package), plain PyTorch: level 2's 9-D narrow
                 ConvLayers use it.

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
           theta, the product, the max and the sum are fp32 (the kernel
           contracts theta into FMAs: ~1 fp32 ulp).
  aggregate  every op in the table's dtype, as the XLA gcn_aggregate: in
           bf16 each product and sum of theta, the product with F and
           each support sum is rounded to bf16.
Dot products of D terms are summed as ((x + y) + z) + ..., supports in
order. relu and the max over k propagate NaN (torch.relu, torch.maximum;
max.NaN in the kernels). Kernels 2 and 5 equal their plain versions bit
for bit (a zero's sign aside).

The wrappers take the plain version for CPU tensors only (ordinary
autograd through it); a CUDA tensor launches the kernel or raises. On the
card each kernel sits in a torch.autograd.Function whose backward re-runs
the plain version on the saved inputs and takes its vector-Jacobian
product, as the JAX package's custom_vjp backwards re-run the XLA forward
(pallas_gcn.py:410-416,560-563).
"""

from __future__ import annotations

import torch

from pose_estimation_tpu_torch.ops import _build
from pose_estimation_tpu_torch.ops.limits import (
    LINEAR_MAX_ROW_BYTES, SURF_MAX_K, SURF_MAX_STREAMS)
from pose_estimation_tpu_torch.utils.profiling import spanned

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


def _theta_only_check(nd):
    if nd.shape[-1] != 3:
        raise ValueError("aggregate without a feature table takes 3-D "
                         f"directions only (ConvSurface), got D={nd.shape[-1]}")


def aggregate_plain(nd, dirs, feats, idx, support_num: int) -> torch.Tensor:
    """One stream of the wide-table aggregate (the XLA gcn_aggregate):
    feats [B, M, S*O] support table gathered per slot, every op in feats'
    dtype. feats=None is ConvSurface's theta-only form, which is one
    stream of surface_multi_plain (3-D directions only)."""
    if feats is None:
        _theta_only_check(nd)
        return surface_multi_plain([nd], [dirs], support_num)[0]
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


def _split(out: torch.Tensor, streams: int):
    o = out.shape[-1] // streams
    return [out[..., si * o:(si + 1) * o] for si in range(streams)]


def _groups(ts, streams: int):
    return [list(ts[i:i + streams]) for i in range(0, len(ts), streams)]


def _recompute_vjp(plain, ts, needs, g):
    """The backward of both Functions: re-run the plain version on the
    saved inputs with autograd on, and take its vector-Jacobian product
    with g (the XLA recompute of pallas_gcn._linear_multi_bwd and
    _surface_multi_bwd)."""
    leaves = [t.detach().requires_grad_(need and t.is_floating_point())
              for t, need in zip(ts, needs)]
    inputs = [t for t in leaves if t.requires_grad]
    with torch.enable_grad():
        out = torch.cat(plain(leaves), -1)
    grads = iter(torch.autograd.grad(out, inputs, g))
    return [next(grads) if t.requires_grad else None for t in leaves]


def _surface_launch(nds, dirs_list, support_num: int) -> torch.Tensor:
    """The kernel reads each stream's nd and dirs from its own tensor, fp32
    or bf16 as it comes, and rounds them to bf16 itself."""
    streams = len(nds)
    b, n, k, _ = nds[0].shape
    o = dirs_list[0].shape[-1] // support_num
    dev = nds[0].device
    nds = [t.contiguous() for t in nds]
    dirs = [t.contiguous() for t in dirs_list]
    mask = 0
    for i, (a, d) in enumerate(zip(nds, dirs)):
        mask |= ((a.dtype == _BF16) << i
                 | (d.dtype == _BF16) << (SURF_MAX_STREAMS + i))
    pad = [None] * (SURF_MAX_STREAMS - streams)
    out = torch.empty((b, n, streams * o), dtype=torch.float32, device=dev)
    rc = _build.launch(_build.library().pose_gcn_surface, dev,
                       *[t.data_ptr() for t in nds], *pad,
                       *[t.data_ptr() for t in dirs], *pad, mask,
                       out.data_ptr(), b * n, k, streams, support_num, o)
    _build.check(rc, "pose_gcn_surface")
    surface_multi.launches += 1
    return out


class _SurfaceMulti(torch.autograd.Function):
    """Forward: the kernel, [B, N, streams*O]. Backward: the plain
    version's vector-Jacobian product (there is no backward kernel: the
    JAX package has none either)."""

    @staticmethod
    def forward(ctx, support_num, streams, *ts):
        ctx.support_num, ctx.streams = support_num, streams
        ctx.save_for_backward(*ts)
        nds, dirs_list = _groups(ts, streams)
        return _surface_launch(nds, dirs_list, support_num)

    @staticmethod
    def backward(ctx, g):
        s, st = ctx.support_num, ctx.streams
        plain = lambda ts: surface_multi_plain(*_groups(ts, st), s)
        return (None, None, *_recompute_vjp(plain, ctx.saved_tensors,
                                            ctx.needs_input_grad[2:], g))


@spanned("op.surface_multi")
def surface_multi(nds, dirs_list, support_num: int):
    """Multi-stream ConvSurface aggregate -> list of [B, N, O] fp32,
    differentiable in nds and dirs."""
    if _on_cpu(*nds, *dirs_list):
        return surface_multi_plain(nds, dirs_list, support_num)
    dev = nds[0].device
    _check_cuda("surface_multi", list(nds) + list(dirs_list), dev)
    streams = len(nds)
    d = nds[0].shape[-1]
    so = dirs_list[0].shape[-1]
    if d != 3 or any(t.shape != nds[0].shape for t in nds):
        raise ValueError("surface_multi: nds must share one [B, N, K, 3] shape")
    if (streams > SURF_MAX_STREAMS
            or not 1 <= nds[0].shape[2] <= SURF_MAX_K):
        raise ValueError(f"surface_multi: the kernel takes at most "
                         f"{SURF_MAX_STREAMS} streams and K <= {SURF_MAX_K}")
    if any(t.shape != (3, so) for t in dirs_list) or so % support_num:
        raise ValueError("surface_multi: dirs must be [3, S*O]")
    for t in list(nds) + list(dirs_list):
        if t.dtype not in (torch.float32, _BF16):
            raise TypeError(f"surface_multi: dtype {t.dtype}")
    out = _SurfaceMulti.apply(support_num, streams, *nds, *dirs_list)
    return _split(out, streams)


surface_multi.launches = 0


class _LinearMulti(torch.autograd.Function):
    """Forward: the kernels, [B, N, streams*O]. Backward: the plain
    version's vector-Jacobian product; idx gets no gradient."""

    @staticmethod
    def forward(ctx, support_num, streams, *ts):
        ctx.support_num, ctx.streams = support_num, streams
        ctx.save_for_backward(*ts)
        nds, dirs_list, xs, ws, bs = _groups(ts[:-1], streams)
        return _linear_launch(nds, dirs_list, xs, ws, bs, ts[-1], support_num)

    @staticmethod
    def backward(ctx, g):
        s, st = ctx.support_num, ctx.streams
        plain = lambda ts: linear_multi_plain(*_groups(ts[:-1], st), ts[-1], s)
        return (None, None, *_recompute_vjp(plain, ctx.saved_tensors,
                                            ctx.needs_input_grad[2:], g))


@spanned("op.linear_multi")
def linear_multi(nds, dirs_list, xs, ws, bs, idx, support_num: int):
    """Multi-stream narrow ConvLayer aggregate sharing one gather ->
    list of [B, N, O] fp32, differentiable in nds, dirs, xs, ws and bs."""
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
    # pass B: one thread per 16 bytes of a table row, at most 512 a block
    most = LINEAR_MAX_ROW_BYTES // xs[0].element_size()
    if (so // support_num) % 8 or so > most:
        raise ValueError(f"linear_multi: the kernel takes O a multiple of 8 "
                         f"and S*O <= {most} in {dt}, got S={support_num}, "
                         f"S*O={so}")
    out = _LinearMulti.apply(support_num, streams, *ts)
    return _split(out, streams)


linear_multi.launches = 0


# The bf16 table pass (csrc/gcn.cu:table_wgmma_kernel) computes 128 table
# columns per block in k chunks of 64, and reads W transposed and padded to
# those multiples (gcn.cu WG_BN, WG_BK).
_WG_N, _WG_K = 128, 64


def _wgmma_weights(ws, dt):
    """ws list of [Cin, S*O] -> [streams, S*O, Cin] in dt, k-contiguous
    (wgmma's k-major B operand), zero-padded to the kernel's tiles."""
    cin, so = ws[0].shape
    shape = (len(ws), -(-so // _WG_N) * _WG_N, -(-cin // _WG_K) * _WG_K)
    w = torch.zeros(shape, dtype=dt, device=ws[0].device)
    w[:, :so, :cin] = torch.stack(ws).transpose(1, 2)
    return w


def _linear_launch(nds, dirs_list, xs, ws, bs, idx, support_num: int):
    dt = xs[0].dtype
    dev = idx.device
    streams = len(nds)
    b, n, k = idx.shape
    m = xs[0].shape[1]
    so = ws[0].shape[-1]
    cin = xs[0].shape[2]
    o = so // support_num
    nd = torch.stack(nds, dim=3).to(dt).contiguous()          # [B,N,K,St,3]
    # [St,3,S*O], rounded to dt and handed over in fp32
    dirs = torch.stack(dirs_list).to(dt).float().contiguous()
    x = torch.cat(xs, dim=-1).contiguous()                    # [B,M,St*Cin]
    w = (_wgmma_weights(ws, dt) if dt == _BF16
         else torch.stack(ws).to(dt).contiguous())            # [St,Cin,S*O]
    bias = torch.stack(bs).float().contiguous()               # [St,S*O]
    table = torch.empty((b, m, streams, so), dtype=dt, device=dev)
    out = torch.empty((b, n, streams * o), dtype=torch.float32, device=dev)
    rc = _build.launch(
        _build.library().pose_gcn_linear, dev, idx.data_ptr(),
        nd.data_ptr(), dirs.data_ptr(), x.data_ptr(), w.data_ptr(),
        bias.data_ptr(), table.data_ptr(), out.data_ptr(), b, n, m, k,
        streams, cin, support_num, o, 1 if dt == _BF16 else 0)
    _build.check(rc, "pose_gcn_linear")
    linear_multi.launches += 1
    return out


def _aggregate_launch(nd, dirs, feats, idx, support_num: int):
    """The kernel reads nd and dirs as they come (fp32 or bf16) and the
    table through its strides (the wide ConvLayer passes a column slice of
    X @ W + b), so nothing is cast or copied here."""
    b, n, k, d = nd.shape
    so = feats.shape[2]
    o = so // support_num
    nd, dirs = nd.contiguous(), dirs.contiguous()
    if feats.stride(2) != 1:
        feats = feats.contiguous()
    mask = (nd.dtype == _BF16) | (dirs.dtype == _BF16) << 1
    out = torch.empty((b, n, o), dtype=torch.float32, device=feats.device)
    rc = _build.launch(
        _build.library().pose_gcn_aggregate, feats.device, idx.data_ptr(),
        nd.data_ptr(), dirs.data_ptr(), mask, feats.data_ptr(),
        feats.stride(0), feats.stride(1), out.data_ptr(), b, n, k, d,
        support_num, o, 1 if feats.dtype == _BF16 else 0)
    _build.check(rc, "pose_gcn_aggregate")
    aggregate.launches += 1
    return out


class _Aggregate(torch.autograd.Function):
    """Forward: the wide-table kernel, [B, N, O]. Backward: the plain
    version's vector-Jacobian product (the JAX package has no backward
    kernel for it either); idx gets no gradient."""

    @staticmethod
    def forward(ctx, support_num, nd, dirs, feats, idx):
        ctx.support_num = support_num
        ctx.save_for_backward(nd, dirs, feats, idx)
        return _aggregate_launch(nd, dirs, feats, idx, support_num)

    @staticmethod
    def backward(ctx, g):
        s = ctx.support_num
        plain = lambda ts: [aggregate_plain(*ts, s)]
        return (None, *_recompute_vjp(plain, ctx.saved_tensors,
                                      ctx.needs_input_grad[1:], g))


@spanned("op.aggregate")
def aggregate(nd, dirs, feats, idx, support_num: int) -> torch.Tensor:
    """Per-stream wide-table aggregate -> [B, N, O] fp32, differentiable
    in nd, dirs and feats: nd [B, N, K, D] (D = 3 or 9), dirs [D, S*O],
    feats [B, M, S*O] fp32 or bf16, idx [B, N, K] int32. feats=None is
    the theta-only form (gcn_aggregate without a table): one stream of
    surface_multi, whose kernel it launches on the card."""
    if feats is None:
        _theta_only_check(nd)
        return surface_multi([nd], [dirs], support_num)[0]
    ts = [nd, dirs, feats, idx]
    if _on_cpu(*ts):
        return aggregate_plain(nd, dirs, feats, idx, support_num)
    _check_cuda("aggregate", ts, feats.device)
    dt = feats.dtype
    if dt not in (torch.float32, _BF16):
        raise TypeError(f"aggregate: dtype {dt}")
    for t in (nd, dirs):
        if t.dtype not in (torch.float32, _BF16):
            raise TypeError(f"aggregate: dtype {t.dtype}")
    if idx.dtype != torch.int32 or idx.ndim != 3 or not idx.is_contiguous():
        raise ValueError("aggregate: idx must be contiguous [B, N, K] int32")
    b, n, k = idx.shape
    d = nd.shape[-1]
    so = dirs.shape[-1]
    if d not in (3, 9) or nd.shape != (b, n, k, d):
        raise ValueError("aggregate: nd must be [B, N, K, D], D = 3 or 9")
    if (dirs.shape != (d, so) or feats.ndim != 3 or feats.shape[0] != b
            or feats.shape[2] != so or so % support_num):
        raise ValueError("aggregate: dirs [D, S*O] and feats [B, M, S*O] "
                         "expected")
    return _Aggregate.apply(support_num, nd, dirs, feats, idx)


aggregate.launches = 0
