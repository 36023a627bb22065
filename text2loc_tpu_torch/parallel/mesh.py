"""Data-parallel process groups and the collectives the port's DP paths
share (port of text2loc_tpu/parallel/mesh.py over torch.distributed).

A Mesh is one process's view of a 1-D data-parallel group (axis "dp"):
the group, this process's rank, the group's size and the device this
process computes on. One process drives one rank; the ranks run the same
program on their own rows of each batch (SPMD).

The JAX package's batch_sharding / replicated_sharding (NamedShardings of
a device mesh) have no counterpart: a torch process holds its own tensors,
so a batch is sharded by each rank keeping its rows (shard_batch) and a
tensor is replicated by every rank holding the same values
(parallel.train.replicate_state).

Collectives run where the group's backend takes them: NCCL on the mesh's
CUDA device, gloo on the host. A tensor held elsewhere is staged there and
back: CUDA tensors under a gloo group (two ranks on one card, which NCCL
refuses), a host tensor (Adam's step count) under NCCL.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of a data-parallel group. `calls` counts this
    process's collectives by kind (all_reduce, all_gather, broadcast)."""

    group: object
    rank: int
    size: int
    device: torch.device
    backend: str
    axis_name: str = "dp"
    calls: collections.Counter = dataclasses.field(
        default_factory=collections.Counter, compare=False, repr=False)


def make_mesh(num_devices: int = -1, axis_name: str = "dp", device=None,
              backend: Optional[str] = None, init_method: Optional[str] = None,
              rank: Optional[int] = None, world_size: Optional[int] = None) -> Mesh:
    """The Mesh of the default process group, which is initialized here if
    it is not yet: from torchrun's environment (init_method None: env://,
    RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT), or from `init_method`
    (e.g. file:///path) with `rank` and `world_size`.

    `device`: this rank's device (default: cuda:LOCAL_RANK). `backend`:
    "nccl" for a CUDA device and "gloo" for the CPU unless given (gloo on a
    CUDA device serves several ranks on one card). `num_devices`: the world
    size the caller expects, -1 for any; another raises. A failure to
    initialize raises."""
    if device is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: expected 'nccl' or 'gloo'")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"the NCCL backend needs a CUDA device, got {device}")
    if dist.is_initialized() and dist.get_backend() != backend:
        raise ValueError(f"the default process group runs {dist.get_backend()}, not "
                         f"{backend}")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=init_method or "env://",
                                rank=-1 if rank is None else rank,
                                world_size=-1 if world_size is None else world_size)
    size = dist.get_world_size()
    if num_devices not in (-1, size):
        raise ValueError(f"a mesh of {num_devices} devices asked for in a world of {size} "
                         "processes (one process drives one rank)")
    return Mesh(group=dist.group.WORLD, rank=dist.get_rank(), size=size, device=device,
                backend=backend, axis_name=axis_name)


def _comm_device(mesh: Mesh) -> torch.device:
    return mesh.device if mesh.backend == "nccl" else torch.device("cpu")


def _in_place(collective, t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """collective(tensor) on `t` where the backend takes it, `t` updated."""
    dev = _comm_device(mesh)
    if t.device == dev and t.is_contiguous():
        collective(t)
    else:
        staged = t.to(dev).contiguous()
        collective(staged)
        t.copy_(staged)
    return t


def all_reduce_(t: torch.Tensor, mesh: Mesh, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """All-reduce `t` in place over the mesh (SUM by default); returns it."""
    mesh.calls["all_reduce"] += 1
    return _in_place(lambda x: dist.all_reduce(x, op=op, group=mesh.group), t, mesh)


def all_gather(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """[size, *t.shape]: every rank's `t` (all alike in shape), in rank order."""
    mesh.calls["all_gather"] += 1
    src = t.detach().to(_comm_device(mesh)).contiguous()
    parts = [torch.empty_like(src) for _ in range(mesh.size)]
    dist.all_gather(parts, src, group=mesh.group)
    return torch.stack(parts).to(t.device)


def broadcast_(t: torch.Tensor, mesh: Mesh, src: int = 0) -> torch.Tensor:
    """Overwrite `t` in place with rank `src`'s; returns it."""
    mesh.calls["broadcast"] += 1
    return _in_place(lambda x: dist.broadcast(x, src=src, group=mesh.group), t, mesh)


def barrier(mesh: Mesh) -> None:
    """Wait for every rank (an all-reduce of one element, which both
    backends take on any device)."""
    all_reduce_(torch.zeros(1, device=mesh.device), mesh)


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.rows = mesh, x.shape[0]
        return all_gather(x, mesh).reshape((mesh.size * x.shape[0],) + x.shape[1:])

    @staticmethod
    def backward(ctx, grad):
        mesh, b = ctx.mesh, ctx.rows
        grad = all_reduce_(grad.contiguous().clone(), mesh)
        return grad[mesh.rank * b:(mesh.rank + 1) * b], None


def all_gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """[size * B, ...]: every rank's [B, ...] rows, concatenated in rank
    order. Backward: the gathered gradient summed over the ranks, this
    rank's rows kept (each rank's loss share reaches every rank's rows)."""
    return _AllGatherRows.apply(x, mesh)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return all_reduce_(x.detach().clone(), mesh)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.contiguous().clone(), ctx.mesh), None


def all_reduce_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of `x` over the ranks; backward, the gradient summed over
    the ranks (every rank's loss share depends on the sum)."""
    return _AllReduceSum.apply(x, mesh)


def global_sums(mesh: Optional[Mesh], *tensors):
    """Each tensor summed over the ranks, in one all-reduce (autograd flows
    through); the tensors as given without a mesh."""
    if mesh is None:
        return tensors
    flat = all_reduce_sum(torch.cat([t.reshape(-1) for t in tensors]), mesh)
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].reshape(t.shape))
        at += t.numel()
    return tuple(out)


def local_draw(draw, shape, mesh: Optional[Mesh]):
    """draw(shape) without a mesh; with one, draw((size * B, ...)) at the
    global batch's shape (every rank's generator alike, so every rank draws
    the same values and its generator advances as a single device's would)
    and keep this rank's B rows."""
    shape = tuple(shape)
    if mesh is None:
        return draw(shape)
    b = shape[0]
    return draw((mesh.size * b,) + shape[1:])[mesh.rank * b:(mesh.rank + 1) * b]


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """This rank's rows of a host batch that every rank holds alike: rows
    [rank * B / size, (rank + 1) * B / size) of every [B, ...] entry. B must
    divide by the mesh size (training drops the remainder, evaluation pads
    the last batch)."""
    out = {}
    for k, v in batch.items():
        b = v.shape[0]
        if b % mesh.size:
            raise ValueError(f"batch dim {b} of {k!r} not divisible by mesh size "
                             f"{mesh.size}")
        n = b // mesh.size
        out[k] = v[mesh.rank * n:(mesh.rank + 1) * n]
    return out


def shard_batch_multihost(batch: dict, mesh: Mesh) -> dict:
    """For an input pipeline where each rank reads only its own rows: the
    batch as given, after checking that every rank holds as many rows."""
    sizes = {v.shape[0] for v in batch.values()}
    if len(sizes) != 1:
        raise ValueError(f"entries of the local batch differ in rows: {sorted(sizes)}")
    (b,) = sizes
    span = torch.tensor([b, -b], dtype=torch.float64, device=mesh.device)
    hi, neg_lo = all_reduce_(span, mesh, op=dist.ReduceOp.MAX).tolist()
    if hi != -neg_lo:
        raise ValueError(f"ranks hold local batches of {int(-neg_lo)} to {int(hi)} rows; "
                         "each must hold as many")
    return batch


@contextlib.contextmanager
def use_mesh(model: torch.nn.Module, mesh: Optional[Mesh]):
    """Within the context, every module of `model` that computes across the
    batch does so over `mesh`: MaskedBatchNorm's and the training SA
    level's statistics are global, Dropout draws at the global batch's
    shape. The previous settings come back on exit. Without a mesh,
    nothing changes."""
    if mesh is None:
        yield
        return
    saved = [(m, m.mesh) for m in model.modules() if hasattr(m, "mesh")]
    try:
        for m, _ in saved:
            m.mesh = mesh
        yield
    finally:
        for m, old in saved:
            m.mesh = old
