"""The (data, model) device mesh on ``torch.distributed`` (the port of
``recsys_tpu/parallel/mesh.py``).

A JAX mesh is one controller over many devices; here, in PyTorch's idiom,
each device is one process of a ``torch.distributed`` process group.
``init_distributed`` joins the group that ``torchrun`` describes in its
environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``), or starts one of
world size 1 (the one-chip case); NCCL serves a CUDA device, gloo the CPU.
``make_mesh`` lays the ranks out as a ``DeviceMesh`` of shape (data, model)
named ``("data", "model")``: rank r sits at (r // model, r % model), as
``devices.reshape(data, model)`` places them in the JAX package.

The collectives here run over one axis of the mesh.  Under gloo a CUDA
tensor is staged through the host (``Mesh.stage``), and a bf16 tensor
moves as float16 bits (or is summed in f32), so every path also runs with
several ranks on one card.  ``AllReduceSum``, ``AllToAll`` and ``AllGatherCols``
are the ones with a gradient, each a ``torch.autograd.Function`` with its
backward written out.

Inside ``with mesh.tally() as ops:`` every collective of this rank on
``mesh`` adds one ``count`` and its result's bytes to ``ops[kind]``, under
the kind names of the XLA HLO the JAX package counts
(``tools/comm_bytes.py``): ``all-reduce``, ``all-gather``, ``all-to-all``,
and ``collective-permute`` for a broadcast (one rank's value sent to the
others).  Bytes are the result's in its own dtype and shape, whatever gloo
stages; with no tally open a collective counts nothing.

Batches: under the GLOBAL data contract every rank holds the global batch
and keeps its data rows (``shard_batch``); under the LOCAL contract each
rank is given only the rows of its data shard, and keeps them all.
"""
from __future__ import annotations

import contextlib
import os

import torch
import torch.distributed as dist

from recsys_tpu_torch.kernels import default_device

DATA_AXIS = "data"
MODEL_AXIS = "model"


def init_distributed(device=None, backend: str | None = None, init_method: str | None = None,
                     rank: int | None = None, world_size: int | None = None) -> tuple[int, int]:
    """Join the process group, or start it; returns (rank, world size).

    Once a group exists this only reports it.  ``rank``/``world_size``
    default to torchrun's ``RANK``/``WORLD_SIZE`` (0 and 1 without them);
    ``init_method`` to ``env://`` under torchrun, and without it a world
    of one process needs none.  ``backend`` defaults to NCCL for a CUDA
    ``device`` (the card unless the caller names another), gloo else; an
    NCCL rank takes the card ``LOCAL_RANK`` names."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    dev = default_device(device)
    env = os.environ
    if rank is None:
        rank, world_size = int(env.get("RANK", 0)), int(env.get("WORLD_SIZE", 1))
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl":
        torch.cuda.set_device(int(env.get("LOCAL_RANK", rank % torch.cuda.device_count())))
    if init_method is None and "MASTER_ADDR" in env:
        init_method = "env://"
    if init_method is None:
        if world_size != 1:
            raise ValueError(f"a world of {world_size} processes needs an init_method "
                             "(or torchrun's environment)")
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    else:
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world_size)
    return rank, world_size


class Mesh:
    """The (data, model) mesh of the process group's ranks, this process's
    place in it, and each axis's process group (from the ``DeviceMesh``
    ``device_mesh``).  ``shape`` is {axis: size}, as the JAX mesh's."""

    def __init__(self, data: int, model: int):
        world = dist.get_world_size()
        if data * model != world:
            raise ValueError(f"mesh {data}x{model} != {world} processes")
        from torch.distributed.device_mesh import init_device_mesh

        self.stage = dist.get_backend() == "gloo"
        self.shape = {DATA_AXIS: data, MODEL_AXIS: model}
        self.device_mesh = init_device_mesh("cpu" if self.stage else "cuda", (data, model),
                                            mesh_dim_names=(DATA_AXIS, MODEL_AXIS))
        self.rank = dist.get_rank()
        self._coords = {DATA_AXIS: self.rank // model, MODEL_AXIS: self.rank % model}
        self._tally = None  # {kind: {'count', 'bytes'}} while a tally is open

    @contextlib.contextmanager
    def tally(self):
        """Count this rank's collectives on the mesh inside the block: yields
        {kind: {'count': calls, 'bytes': result bytes}}, filled as they run."""
        if self._tally is not None:
            raise RuntimeError("a tally is already open on this mesh")
        self._tally = ops = {}
        try:
            yield ops
        finally:
            self._tally = None

    def _count(self, kind: str, numel: int, dtype: torch.dtype) -> None:
        if self._tally is not None:
            e = self._tally.setdefault(kind, {"count": 0, "bytes": 0})
            e["count"] += 1
            e["bytes"] += numel * dtype.itemsize

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        """This rank's coordinate on ``axis``."""
        return self._coords[axis]

    def group(self, axis: str):
        return self.device_mesh.get_group(axis)

    def ranks(self, axis: str) -> list[int]:
        """The global ranks of this rank's group on ``axis``, in order."""
        data, model = self.shape[DATA_AXIS], self.shape[MODEL_AXIS]
        if axis == DATA_AXIS:
            return [d * model + self._coords[MODEL_AXIS] for d in range(data)]
        return [self._coords[DATA_AXIS] * model + m for m in range(model)]

    def __repr__(self) -> str:
        return f"Mesh(data={self.shape[DATA_AXIS]}, model={self.shape[MODEL_AXIS]})"


def make_mesh(data: int | None = None, model: int = 1, device=None) -> Mesh:
    """A (data, model) mesh over the process group (started with
    ``init_distributed(device)`` when there is none); ``data`` defaults
    to the rest of the world after ``model``."""
    init_distributed(device)
    world = dist.get_world_size()
    if data is None:
        data = world // model
    return Mesh(data, model)


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def shard_batch(batch: dict, mesh: Mesh | None) -> dict:
    """This rank's part of a global host batch (GLOBAL contract): the rows
    of its data shard of every array, and the ``embaux*`` arrays of the
    fused update's prep whole (they describe the global batch)."""
    if mesh is None:
        return dict(batch)
    n, d = mesh.size(DATA_AXIS), mesh.index(DATA_AXIS)
    out = {}
    for k, x in batch.items():
        if k.startswith("embaux"):
            out[k] = x
            continue
        b = len(x)
        if b % n:
            raise ValueError(f"{k}: {b} rows do not split over a data axis of {n}")
        out[k] = x[d * (b // n):(d + 1) * (b // n)]
    return out


# -- collectives over one axis of the mesh --------------------------------

def _wire(x: torch.Tensor, mesh: Mesh, reduce: bool = False):
    """(the tensor to hand the backend, the function that brings a result
    back to x's device and dtype): gloo takes CUDA tensors through the
    host, and bf16 as the bits of a float16 tensor (gloo moves float16 but
    not bf16 or int16), or as f32 where it sums."""
    dtype, device = x.dtype, x.device
    y = x.cpu() if mesh.stage and device.type == "cuda" else x
    if dtype == torch.bfloat16 and mesh.stage:
        y = y.float() if reduce else y.view(torch.float16)

    def back(z):
        if dtype == torch.bfloat16 and mesh.stage:
            z = z.to(dtype) if reduce else z.view(dtype)
        return z.to(device)

    return y.contiguous(), back


def all_reduce(x: torch.Tensor, mesh: Mesh, axis: str, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """The sum (or ``op``) of ``x`` over ``axis``, a new tensor."""
    mesh._count("all-reduce", x.numel(), x.dtype)
    y, back = _wire(x, mesh, reduce=True)
    y = y.clone() if y.data_ptr() == x.data_ptr() else y
    dist.all_reduce(y, op=op, group=mesh.group(axis))
    return back(y)


def all_gather(x: torch.Tensor, mesh: Mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """The ranks' ``x`` of ``axis`` concatenated along ``dim``, in axis order."""
    mesh._count("all-gather", x.numel() * mesh.size(axis), x.dtype)
    y, back = _wire(x, mesh)
    parts = [torch.empty_like(y) for _ in range(mesh.size(axis))]
    dist.all_gather(parts, y, group=mesh.group(axis))
    return back(torch.cat(parts, dim=dim))


def all_to_all(x: torch.Tensor, mesh: Mesh, axis: str, async_op: bool = False):
    """The equal-split exchange of ``x``'s leading axis over ``axis``: part
    j of x goes to rank j, and part j of the result came from rank j.
    Returns (result, wait): ``wait()`` must run before the result is read
    (with ``async_op``, the exchange runs meanwhile; staged through the
    host it has already run)."""
    mesh._count("all-to-all", x.numel(), x.dtype)
    y, back = _wire(x, mesh)
    out = torch.empty_like(y)
    if async_op and not mesh.stage:
        work = dist.all_to_all_single(out, y, group=mesh.group(axis), async_op=True)
        return out, work.wait
    dist.all_to_all_single(out, y, group=mesh.group(axis))
    out = back(out)
    return out, lambda: None


def broadcast_(x: torch.Tensor, mesh: Mesh, axis: str | None = None) -> None:
    """Overwrite ``x`` in place with its value on the first rank of this
    rank's ``axis`` group (of the whole world when ``axis`` is None)."""
    mesh._count("collective-permute", x.numel(), x.dtype)
    y, back = _wire(x, mesh)
    if axis is None:
        dist.broadcast(y, src=0)
    else:
        dist.broadcast(y, src=mesh.ranks(axis)[0], group=mesh.group(axis))
    if y.data_ptr() != x.data_ptr():
        x.copy_(back(y))


class AllReduceSum(torch.autograd.Function):
    """Sum over an axis whose ranks each hold a part (a masked local
    gather); the result is replicated over the axis.  Backward: each part's
    gradient is the result's, unchanged: every rank of the axis computes
    the same loss from the same result, counted once, so summing the
    gradient over the axis again would multiply it by the axis size."""

    @staticmethod
    def forward(ctx, x, mesh: Mesh, axis: str):
        return all_reduce(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class AllToAll(torch.autograd.Function):
    """``all_to_all`` with a gradient: the equal-split exchange is a
    permutation of the parts, and its transpose is the same exchange."""

    @staticmethod
    def forward(ctx, x, mesh: Mesh, axis: str):
        ctx.mesh, ctx.axis = mesh, axis
        out, wait = all_to_all(x, mesh, axis)
        wait()
        return out

    @staticmethod
    def backward(ctx, g):
        out, wait = all_to_all(g.contiguous(), ctx.mesh, ctx.axis)
        wait()
        return out, None, None


class AllGatherCols(torch.autograd.Function):
    """The ranks' column slices of ``axis`` concatenated along the last
    dimension, replicated over the axis.  Backward: this rank's slice of
    the result's gradient (every rank computes the same loss from it)."""

    @staticmethod
    def forward(ctx, x, mesh: Mesh, axis: str):
        ctx.lo, ctx.width = mesh.index(axis) * x.shape[-1], x.shape[-1]
        return all_gather(x.contiguous(), mesh, axis, dim=x.dim() - 1)

    @staticmethod
    def backward(ctx, g):
        return g[..., ctx.lo:ctx.lo + ctx.width], None, None
