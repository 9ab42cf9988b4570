"""The device mesh of the port: the ranks of a ``torch.distributed`` process group
(counterpart of the JAX ``parallel/mesh.py``).

One process drives one device. A :class:`Mesh` names the process group its ranks
form, the axes (``("data",)`` by default) and their shape, this rank, its device and
the group's backend: NCCL on the card, gloo where the caller names it (the CPU tests,
and two ranks sharing one card, which NCCL refuses). Collectives go through the
mesh's methods, which skip nothing: a mesh over a process group runs every
collective, a world of one included; only a mesh made where no process group was
initialized (one process, no launcher) has no group, and its collectives are the
identity.

JAX's ``batch_sharding`` and ``replicated_sharding`` describe where GSPMD places the
shards of one logical array. A torch tensor lives whole on one device of one
process, so there is nothing to describe: a batch is sharded by taking this rank's
slice (:func:`shard_batch`), and replicated state is the same tensor on every rank
(:func:`parallel.distributed.make_global`). Neither name is ported.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist

from artist_style_transfer_tpu_torch.utils.device import resolve_device

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """The ranks of one process group laid out as ``shape`` over ``axis_names``."""

    group: object | None  # a torch.distributed ProcessGroup; None without one (a world of one)
    axis_names: tuple[str, ...]
    shape: tuple[int, ...]
    rank: int  # this process's rank in the group
    device: torch.device  # this rank's device
    backend: str | None  # "nccl", "gloo", or None without a group

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def axis_size(self, axis: str) -> int:
        """Ranks on ``axis``; 1 when the mesh has no such axis."""
        return self.shape[self.axis_names.index(axis)] if axis in self.axis_names else 1

    def all_reduce_(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """Sum (or max, ``op="max"``) ``t`` over the ranks, in place; returns ``t``."""
        if self.group is not None:
            dist.all_reduce(t, op=_OPS[op], group=self.group)
        return t

    def all_gather(self, t: torch.Tensor) -> list[torch.Tensor]:
        """Every rank's ``t`` (the same shape and dtype on each), in rank order."""
        if self.group is None:
            return [t]
        out = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(out, t.contiguous(), group=self.group)
        return out

    def broadcast_(self, t: torch.Tensor) -> torch.Tensor:
        """Rank 0's ``t`` on every rank, in place; returns ``t``."""
        if self.group is not None:
            dist.broadcast(t, src=dist.get_global_rank(self.group, 0), group=self.group)
        return t

    def broadcast_object(self, obj):
        """Rank 0's ``obj`` (any picklable value) on every rank."""
        if self.group is None:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=dist.get_global_rank(self.group, 0),
                                   group=self.group,
                                   device=self.device if self.backend == "nccl" else None)
        return box[0]

    def barrier(self) -> None:
        if self.group is not None:
            if self.backend == "nccl":
                dist.barrier(group=self.group, device_ids=[self.device.index or 0])
            else:
                dist.barrier(group=self.group)


def make_mesh(
    shape: tuple[int, ...] | None = None,
    axis_names: tuple[str, ...] = ("data",),
    devices: list[int] | None = None,
    device: str | torch.device | None = None,
) -> Mesh:
    """A mesh over the ranks ``devices`` (default: the whole world) of the initialized
    process group; ``shape`` defaults to all of them on the first axis.

    ``device`` is this rank's device (``None``: CUDA, the current one; the CPU only when
    asked for). A shape that needs more ranks than ``devices`` holds raises
    ``ValueError``; one that needs fewer takes the first of them, as JAX takes the
    first devices, and a rank outside those raises. Without an initialized process
    group the world is this one process.
    """
    world = dist.get_world_size() if dist.is_initialized() else 1
    me = dist.get_rank() if dist.is_initialized() else 0
    ranks = list(range(world)) if devices is None else [int(r) for r in devices]
    if shape is None:
        shape = (len(ranks),) + (1,) * (len(axis_names) - 1)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} does not match axis names {axis_names}")
    n = math.prod(shape)
    if n > len(ranks):
        raise ValueError(f"mesh shape {shape} needs {n} devices, have {len(ranks)}")
    ranks = ranks[:n]
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    group, backend = None, None
    if dist.is_initialized():
        group = dist.group.WORLD if ranks == list(range(world)) else dist.new_group(ranks)
        if me not in ranks:
            raise ValueError(f"rank {me} is not one of the mesh's ranks {ranks}")
        backend = dist.get_backend(group)
        if backend == "nccl" and dev.type != "cuda":
            raise ValueError(f"an NCCL mesh runs on CUDA devices, not on {dev}")
    return Mesh(group, tuple(axis_names), shape, ranks.index(me), dev, backend)


def spatial_size(mesh: Mesh | None, axis: str = "space") -> int:
    """Ranks on the spatial (image-rows) mesh axis; 1 when absent."""
    return 1 if mesh is None else mesh.axis_size(axis)


def shard_batch(x, mesh: Mesh | None):
    """This rank's equal slice of axis 0 of ``x`` (a tensor or an array); ``x`` as it
    is when ``mesh`` is None. The mesh's size must divide the batch."""
    if mesh is None:
        return x
    n = mesh.size
    if x.shape[0] % n:
        raise ValueError(f"batch of {x.shape[0]} does not divide over the {n}-rank mesh")
    b = x.shape[0] // n
    return x[mesh.rank * b : (mesh.rank + 1) * b]


def data_parallel(mesh: Mesh | None) -> Mesh | None:
    """``mesh`` for a data-parallel path, which shards batches over every rank:
    a mesh with an axis other than 'data' larger than 1 raises ``NotImplementedError``."""
    if mesh is not None and any(s > 1 for a, s in zip(mesh.axis_names, mesh.shape)
                                if a != "data"):
        raise NotImplementedError(
            f"a mesh with axes {dict(zip(mesh.axis_names, mesh.shape))}: training and "
            "evaluation over an axis other than 'data' (a 'space' axis of image rows) come "
            "with ROADMAP Queue 1 item 12b; use a 'data' mesh")
    return mesh
