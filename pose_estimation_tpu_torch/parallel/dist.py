"""Data parallelism across processes (counterpart of parallel/mesh.py).

One process per card, launched by torchrun (which sets RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR and MASTER_PORT) or by explicit arguments to
`distributed_init`. The semantics are those of the JAX package's
multi-process mesh: each process holds `train.batch_size` rows, the
global batch is batch_size x world_size, and every reduction of the train
step runs over the global batch:

  the gradient         averaged in one flat buffer before the NaN guard,
                       so its norm and the skip decision are global
                       (train.train_step);
  BatchNorm            the batch statistics averaged over the group,
                       differentiably (models.layers.BatchNorm);
  the map losses       masked means over the global batch: the count of
                       valid pixels is summed over the group
                       (losses.map_loss);
  the step's metrics   averaged over the group, so rank 0 logs the
                       global values;
  random draws with a  drawn at the global batch's shape from the
  batch axis           generator, which is the same on every rank; each
                       rank keeps its rows (`draw_rows`): the dropout
                       masks, the RANSAC subsets;
  the eval table       merged once per eval (metrics.metric).

Every rank holds the same number of rows, so a mean over the global batch
is the mean of the ranks' means. No group, or a group of one, changes
nothing: every collective of a group of one is an identity, and the
arithmetic around it (a division or a product by 1) is exact.

make_mesh and shard_batch are not ported: they place global arrays over
devices, and a rank here already holds its own rows. `check_mesh` holds
cfg.mesh against the group instead. A failed collective raises; nothing
falls back to one process or to the CPU.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as tdist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors


def is_initialized() -> bool:
    return tdist.is_available() and tdist.is_initialized()


def world_size(group=None) -> int:
    return tdist.get_world_size(group) if is_initialized() else 1


def rank(group=None) -> int:
    return tdist.get_rank(group) if is_initialized() else 0


def is_primary() -> bool:
    return rank() == 0


def local_rank(global_rank: int | None = None) -> int:
    """This process's card on its node: torchrun's LOCAL_RANK, else the
    rank (this process's, or `global_rank`) modulo the node's cards (one
    node)."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    r = rank() if global_rank is None else global_rank
    return r % max(torch.cuda.device_count(), 1)


def distributed_init(backend: str | None = None,
                     init_method: str | None = None,
                     world_size: int | None = None,
                     rank: int | None = None) -> bool:
    """Join the process group (the init_process_group rendezvous of the
    reference's DDP runtime, version/transparent/train.py:1223-1229).

    A no-op that returns False without group arguments and without
    torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK), as the JAX
    package's distributed_init without a coordinator. `backend` defaults
    to NCCL when there is a card and gloo without one; gloo on CUDA
    tensors is what two processes sharing one card take (NCCL refuses
    two ranks on one device). With explicit arguments, `init_method`
    ("tcp://host:port", "file:///path") and both `world_size` and `rank`
    are needed. Returns True once the group exists."""
    if is_initialized():
        return True
    explicit = (init_method, world_size, rank) != (None, None, None)
    if not explicit and not all(k in os.environ for k in
                                ("RANK", "WORLD_SIZE", "LOCAL_RANK")):
        return False
    if explicit and None in (init_method, world_size, rank):
        raise ValueError("distributed_init: init_method, world_size and "
                         "rank go together")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(local_rank(rank))
    if explicit:
        tdist.init_process_group(backend, init_method=init_method,
                                 world_size=world_size, rank=rank)
    else:                                 # torchrun's environment
        tdist.init_process_group(backend, init_method="env://")
    return True


def destroy() -> None:
    if is_initialized():
        tdist.destroy_process_group()


def barrier() -> None:
    if not is_initialized():
        return
    if tdist.get_backend() == "nccl":
        tdist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        tdist.barrier()


def check_mesh(mesh) -> None:
    """Raise ValueError, naming the field, unless the group gives the
    layout of `mesh` (configs.schema.MeshConfig): dcn x data ranks,
    data = -1 meaning every rank, model = 1 (tensor sharding is not
    ported)."""
    n = world_size()
    if mesh.model != 1:
        raise ValueError(f"mesh.model={mesh.model}: tensor sharding is not "
                         "ported; the group shards the batch only "
                         "(mesh.model=1)")
    if mesh.dcn < 1 or n % mesh.dcn:
        raise ValueError(f"mesh.dcn={mesh.dcn} does not divide the group's "
                         f"{n} ranks")
    data = n // mesh.dcn if mesh.data == -1 else mesh.data
    if data * mesh.dcn != n:
        raise ValueError(f"mesh.data={mesh.data} x mesh.dcn={mesh.dcn} is "
                         f"not the group's {n} ranks (mesh.data=-1 takes "
                         "every rank)")


def _comm_device() -> torch.device:
    """Where host data goes for a collective: the current card for NCCL,
    the CPU for gloo."""
    if tdist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """x summed over the group (a new tensor, no gradient); x without a
    group."""
    if not is_initialized():
        return x
    y = x.detach().clone()
    tdist.all_reduce(y)
    return y


def all_reduce_mean(tensors: list) -> list:
    """The tensors averaged over the group in place, through one flat
    buffer per dtype (one collective each, not one per tensor). The
    results are copied back into the tensors rather than handed out as
    views of the buffer: the CPU's vectorised reductions round by the
    address, and a group of one must give the bits of no group."""
    tensors = list(tensors)
    if not is_initialized():
        return tensors
    n = world_size()
    groups: dict = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    for ts in groups.values():
        flat = _flatten_dense_tensors(ts)
        tdist.all_reduce(flat)
        flat.div_(n)
        torch._foreach_copy_(ts, _unflatten_dense_tensors(flat, ts))
    return tensors


def mean_dict(values: dict) -> dict:
    """A dict of 0-d tensors averaged over the group in one collective
    (new tensors); `values` itself without a group."""
    if not is_initialized():
        return values
    return dict(zip(values, all_reduce_mean([v.clone()
                                             for v in values.values()])))


class _GroupMean(torch.autograd.Function):
    """The mean over the group, whose backward is the mean over the group
    of the incoming gradients: rank r's statistics feed every rank's loss,
    and the step averages the ranks' gradients."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone(memory_format=torch.contiguous_format)
        tdist.all_reduce(y)
        return y.div_(world_size())

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        tdist.all_reduce(g)
        return g.div_(world_size())


def group_mean(x: torch.Tensor) -> torch.Tensor:
    """Differentiable mean of x over the group; x without a group."""
    return _GroupMean.apply(x) if is_initialized() else x


def rank_rows(x: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a global-batch array: rows [r*b, (r+1)*b) of
    its world_size*b rows."""
    n = world_size()
    if n == 1:
        return x
    if x.shape[0] % n:
        raise ValueError(f"rank_rows: {x.shape[0]} rows do not split over "
                         f"{n} ranks")
    b = x.shape[0] // n
    return x[rank() * b:(rank() + 1) * b]


def draw_rows(draw, shape) -> torch.Tensor:
    """draw(global shape) -> this rank's rows: a random draw with a batch
    axis made at the global batch's shape, [world_size * shape[0],
    *shape[1:]], so that every rank consumes the same draws from its
    generator and the ranks together hold one process's draw."""
    shape = tuple(shape)
    return rank_rows(draw((shape[0] * world_size(),) + shape[1:]))


def all_gather_array(a: np.ndarray) -> np.ndarray:
    """[world_size, *a.shape]: every rank's `a` (same shape and dtype on
    every rank), in rank order; a[None] without a group."""
    a = np.ascontiguousarray(a)
    if not is_initialized():
        return a[None]
    t = torch.from_numpy(a).to(_comm_device())
    parts = [torch.empty_like(t) for _ in range(world_size())]
    tdist.all_gather(parts, t)
    return np.stack([p.cpu().numpy() for p in parts])


def ring_shift(x: torch.Tensor, group=None) -> torch.Tensor:
    """x sent to the next rank of the ring while the previous rank's is
    received (dist.batch_isend_irecv): rank r returns rank r-1's x. Every
    rank's x has the same shape. gloo moves host memory, so a CUDA tensor
    goes through the host on that backend."""
    n, r = world_size(group), rank(group)
    peer = (lambda i: i) if group is None else (
        lambda i: tdist.get_global_rank(group, i))
    staged = tdist.get_backend(group) == "gloo" and x.is_cuda
    send = x.cpu() if staged else x.contiguous()
    recv = torch.empty_like(send)
    ops = [tdist.P2POp(tdist.isend, send, peer((r + 1) % n), group),
           tdist.P2POp(tdist.irecv, recv, peer((r - 1) % n), group)]
    for req in tdist.batch_isend_irecv(ops):
        req.wait()
    return recv.to(x.device) if staged else recv
