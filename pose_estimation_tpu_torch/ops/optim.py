"""The train step's Ranger update over every leaf at once: a hand-written
CUDA kernel beside its plain version.

  ranger_apply
           csrc/ranger.cu (`pose_ranger_apply`). It replaces no TPU
           kernel: the JAX package leaves its optax chain (the NaN guard,
           clip_by_global_norm, centralisation, RAdam, the learning rate,
           Lookahead) to XLA's fusion. The plain chain launches about 28
           kernels a leaf, ~4,200 a step for the transparent models, and
           leaves the card idle through most of them. What bounds the
           update is bytes (the gradient read twice, the moments and the
           parameter read and written, the slow weight on a sync step);
           the kernel streams them in three launches after one copy of a
           pointer table, however many leaves the model has.

`ranger_apply` is the wrapper: the plain version for CPU tensors (the
guard, train.optim.ranger_chain, the add), the kernel for CUDA tensors (or
an exception; there is no fallback). It counts its launches: the table's
copy and the three kernels.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from pose_estimation_tpu_torch.convert import flax_axis0_dim
from pose_estimation_tpu_torch.ops import _build
from pose_estimation_tpu_torch.train.optim import (Ranger, nan_guard,
                                                   ranger_chain)
from pose_estimation_tpu_torch.utils.profiling import spanned

# csrc/ranger.cu's layout of the plan
THREADS = 256
LEAF_INTS, TASK_INTS, CHUNK_INTS = 8, 12, 4
TASK_ELEMS = 8192        # gradient elements a reduction task reads, about
CHUNK = 4096             # elements an update block writes
LAUNCHES = 4             # the table's copy and three kernels
CONTIGUOUS, CHANNELS_LAST = 0, 1
_BIG = 2 ** 31 - 1


class Leaf(NamedTuple):
    """One leaf as the plan sees it: its elements, its centralisation
    groups (0: none) and the stride of one group index in the parameter's
    (contiguous) order and in the gradient's memory order, the gradient's
    layout, and for a channels-last gradient [O, I, H, W] its I and H * W."""
    numel: int
    groups: int
    inner: int
    inner_grad: int
    layout: int
    lanes: int
    hw: int


class Plan(NamedTuple):
    """make_plan's arrays: leaf rows, reduction tasks, update chunks, the
    offsets of each group's partial sums in `slots` (csr) and the slots,
    and each group's mean factor."""
    leaves: np.ndarray
    tasks: np.ndarray
    chunks: np.ndarray
    csr: np.ndarray
    slots: np.ndarray
    factor: np.ndarray


def leaf_of(name: str, p: torch.Tensor, g: torch.Tensor) -> Leaf:
    """The plan's view of leaf `name` (a state_dict key) with parameter
    `p` (contiguous) and gradient `g` (contiguous or channels-last):
    centralisation groups along convert.flax_axis0_dim for rank > 1."""
    layout = CONTIGUOUS if g.is_contiguous() else CHANNELS_LAST
    lanes = hw = 0
    if layout == CHANNELS_LAST:
        lanes, hw = p.shape[1], p.shape[2] * p.shape[3]
    if p.ndim <= 1:
        return Leaf(p.numel(), 0, 1, 1, layout, lanes, hw)
    keep = flax_axis0_dim(name)
    inner = math.prod(p.shape[keep + 1:])
    return Leaf(p.numel(), p.shape[keep], inner,
                g.stride(keep) if layout == CHANNELS_LAST else inner,
                layout, lanes, hw)


def make_plan(leaves: list) -> Plan:
    """The plan of a model's leaves (Leaf tuples, in the order of the
    pointer table).

    Reduction tasks read a leaf's gradient in its memory order. Element m
    is in group (m // inner_grad) % groups, so a leaf is `outer` rows of
    row = groups * inner_grad elements whose columns each lie in one
    group: a task is a tile of up to THREADS columns over a run of rows,
    column c in group (c0 + c) // gdiv. Where groups are contiguous runs
    (rank <= 1 leaves: no group; one group; one row), a task is a run of
    at most TASK_ELEMS elements in one group (rows of THREADS, the last
    cut at n). Each task writes its groups' partial sums to `ngroups`
    consecutive slots from `slot`. Update chunks are CHUNK elements of one
    leaf (its last shorter)."""
    leaf_rows, tasks, chunks, members, factor = [], [], [], [], []
    gbase = 0
    for li, lf in enumerate(leaves):
        if lf.numel < 1 or lf.numel >= _BIG:
            raise ValueError(f"ranger_apply: a leaf of {lf.numel} elements")
        leaf_rows.append([lf.numel, lf.groups, lf.inner, gbase, lf.layout,
                          lf.lanes, lf.hw, 0])
        for s in range(0, lf.numel, CHUNK):
            chunks.append([li, s, min(CHUNK, lf.numel - s), 0])
        row = lf.groups * lf.inner_grad
        outer = lf.numel // row if lf.groups else 1
        if lf.groups <= 1 or outer == 1:
            size = lf.inner_grad if lf.groups > 1 else lf.numel
            for j in range(max(lf.groups, 1)):
                for s in range(j * size, (j + 1) * size, TASK_ELEMS):
                    n = min(TASK_ELEMS, (j + 1) * size - s)
                    grouped = lf.groups > 0
                    tasks.append([li, s, THREADS, THREADS,
                                  -(-n // THREADS), n, 0, 0, 0,
                                  len(members) if grouped else 0,
                                  int(grouped), 0])
                    if grouped:
                        members.append(gbase + j)
        else:
            for c0 in range(0, row, THREADS):
                cols = min(THREADS, row - c0)
                lanes = THREADS // cols
                rows = max(lanes, TASK_ELEMS // cols // lanes * lanes)
                first = c0 // lf.inner_grad
                last = (c0 + cols - 1) // lf.inner_grad
                for r0 in range(0, outer, rows):
                    tasks.append([li, r0 * row + c0, row, cols,
                                  min(rows, outer - r0), _BIG, c0,
                                  lf.inner_grad, 0, len(members),
                                  last - first + 1, 0])
                    members.extend(range(gbase + first, gbase + last + 1))
        factor += [np.float32(lf.groups) / np.float32(lf.numel)] * lf.groups
        gbase += lf.groups
    members = np.asarray(members, dtype=np.int64)
    order = np.argsort(members, kind="stable")     # by group, task order
    csr = np.searchsorted(members[order], np.arange(gbase + 1))
    return Plan(np.asarray(leaf_rows, np.int32).reshape(-1, LEAF_INTS),
                np.asarray(tasks, np.int32).reshape(-1, TASK_INTS),
                np.asarray(chunks, np.int32).reshape(-1, CHUNK_INTS),
                csr.astype(np.int32), order.astype(np.int32),
                np.asarray(factor, np.float32))


class _DevicePlan(NamedTuple):
    ints: torch.Tensor       # leaves, tasks, chunks, csr, slots
    factor: torch.Tensor
    counts: tuple            # n_leaves, n_tasks, n_chunks, n_groups, n_slots


_plans: dict = {}


def _upload(a: np.ndarray, dev) -> torch.Tensor:
    """a on `dev`, copied from pinned memory on the current stream
    without waiting for it."""
    return torch.from_numpy(a).pin_memory().to(dev, non_blocking=True)


def _device_plan(key, leaves: list, dev) -> _DevicePlan:
    """make_plan(leaves) on `dev`, kept under `key` (the device, and each
    leaf's name, shape and gradient layout)."""
    plan = make_plan(leaves)
    ints = np.concatenate([plan.leaves.ravel(), plan.tasks.ravel(),
                           plan.chunks.ravel(), plan.csr, plan.slots])
    if len(_plans) >= 8:
        _plans.clear()
    _plans[key] = _DevicePlan(
        _upload(ints, dev), _upload(plan.factor, dev),
        (len(plan.leaves), len(plan.tasks), len(plan.chunks),
         len(plan.factor), len(plan.slots)))
    return _plans[key]


def ranger_apply_plain(params: dict, grads: dict, opt_state: dict,
                       loss: torch.Tensor, **scalars):
    """The guard, train.optim.ranger_chain and the add, leaf by leaf:
    the parameters updated in place, opt_state's count, mu, nu and slow
    replaced; (gnorm, finite)."""
    grads, gnorm, finite = nan_guard(grads, loss)
    updates, new = ranger_chain(grads, opt_state, params, **scalars)
    for k, p in params.items():
        p.add_(updates[k])
    opt_state.update(new)
    return gnorm, finite


def _layout(g: torch.Tensor):
    """The gradient layouts the kernel reads: contiguous and, for a 4-D
    leaf, channels-last (cuDNN's weight gradient of an NHWC activation);
    None for any other."""
    if g.is_contiguous():
        return CONTIGUOUS
    if g.ndim == 4 and g.is_contiguous(memory_format=torch.channels_last):
        return CHANNELS_LAST
    return None


def _launch(params: dict, grads: dict, opt_state: dict, loss: torch.Tensor,
            *, grad_clip, weight_decay, count, c1, c2, r, step_size,
            lr_scale, sync):
    dev = loss.device
    if loss.numel() != 1:
        raise ValueError("ranger_apply: the loss must be one value")
    index, f32 = loss.get_device(), torch.float32     # -1 on the CPU
    mus, nus, slows = (opt_state[k] for k in ("mu", "nu", "slow"))
    ptrs, key, copies = [], [index], []
    for name, p in params.items():         # every check before any launch
        g, shape = grads[name], p.shape
        for t in (p, mus[name], nus[name], slows[name]):
            if (t.dtype is not f32 or t.get_device() != index
                    or t.shape != shape or not t.is_contiguous()):
                raise ValueError(
                    f"ranger_apply: {name}: the parameter and its state "
                    f"must be contiguous float32 {tuple(shape)} on {dev}, "
                    f"got {t.dtype} {tuple(t.shape)} on {t.device}")
        if g.dtype is not f32 or g.get_device() != index or g.shape != shape:
            raise ValueError(f"ranger_apply: gradient of {name}: {g.dtype} "
                             f"{tuple(g.shape)} on {g.device}, parameter "
                             f"float32 {tuple(shape)} on {dev}")
        layout = _layout(g)
        if layout is None:
            copies.append(len(key) - 1)
        key.append((name, shape, layout))
        ptrs += (g.data_ptr(), p.data_ptr(), mus[name].data_ptr(),
                 nus[name].data_ptr(), slows[name].data_ptr())
    if copies:                   # another layout: one copy each
        grads = dict(grads)
        for i in copies:
            name = key[i + 1][0]
            grads[name] = grads[name].contiguous()
            ptrs[5 * i] = grads[name].data_ptr()
            key[i + 1] = (name, key[i + 1][1], CONTIGUOUS)
    if loss.dtype is not f32:
        loss = loss.float()
    plan = _plans.get(tuple(key))
    if plan is None:
        plan = _device_plan(tuple(key), [
            leaf_of(name, p, grads[name]) for name, p in params.items()], dev)
    n_leaves, n_tasks, n_chunks, n_groups, n_slots = plan.counts
    table = _upload(np.asarray(ptrs, dtype=np.int64), dev)
    ws = torch.empty(4 + n_tasks + n_slots + n_groups, dtype=torch.float32,
                     device=dev)
    gnorm = torch.empty((), dtype=torch.float32, device=dev)
    finite = torch.empty((), dtype=torch.bool, device=dev)
    f = np.float32
    b1, b2 = f(Ranger.b1), f(Ranger.b2)
    rc = _build.launch(
        _build.library().pose_ranger_apply, dev, table.data_ptr(),
        plan.ints.data_ptr(), plan.factor.data_ptr(), ws.data_ptr(),
        loss.data_ptr(), gnorm.data_ptr(), finite.data_ptr(), n_leaves,
        n_tasks, n_chunks, n_groups, n_slots, float(f(grad_clip or 0.0)),
        int(bool(grad_clip)), float(f(weight_decay or 0.0)), float(b1),
        float(f(1 - Ranger.b1)), float(b2), float(f(1 - Ranger.b2)),
        float(f(1) / f(c1)), float(f(1) / f(c2)),
        float(f(r if r is not None else 0.0)), int(r is not None),
        float(f(Ranger.eps)), float(f(step_size)), float(f(lr_scale)),
        int(bool(sync)), float(f(Ranger.alpha)))
    _build.check(rc, "pose_ranger_apply")
    ranger_apply.launches += LAUNCHES
    opt_state["count"] = count
    return gnorm, finite


@spanned("op.ranger_apply")
def ranger_apply(params: dict, grads: dict, opt_state: dict,
                 loss: torch.Tensor, *, grad_clip, weight_decay, count, c1,
                 c2, r, step_size, lr_scale, sync):
    """One Ranger step with the NaN guard (Ranger.step_args gives the
    keywords): the parameters (a dict of the model's leaves) and
    opt_state's mu, nu and slow updated in place from `grads`, its count
    set to `count`; (gnorm, finite), 0-d tensors on the device: the
    global norm before the clip, and whether it and `loss` are finite (if
    not, the step ran on zeroed gradients)."""
    scalars = dict(grad_clip=grad_clip, weight_decay=weight_decay,
                   count=count, c1=c1, c2=c2, r=r, step_size=step_size,
                   lr_scale=lr_scale, sync=sync)
    if loss.device.type == "cpu":
        return ranger_apply_plain(params, grads, opt_state, loss, **scalars)
    if loss.device.type != "cuda":
        raise ValueError(f"ranger_apply: tensors on {loss.device}")
    return _launch(params, grads, opt_state, loss, **scalars)


ranger_apply.launches = 0
