"""The device mesh of the port: the ranks of a ``torch.distributed`` process group
(counterpart of the JAX ``parallel/mesh.py``).

One process drives one device. A :class:`Mesh` names the process group its ranks
form, the axes (``("data",)`` by default) and their shape, this rank, its device and
the group's backend: NCCL on the card, gloo where the caller names it (the CPU tests,
and two ranks sharing one card, which NCCL refuses). Collectives go through the
mesh's methods, which skip nothing: a mesh over a process group runs every
collective, a world of one included; only a mesh made where no process group was
initialized (one process, no launcher), and a one-rank line of a mesh of several
axes, have no group, and their collectives are the identity. Each collective runs in the
span ``mesh.collective`` (:func:`utils.trace.span`), on a running profiler's clock.

The ranks lie row-major over ``shape``, as JAX's ``make_mesh`` reshapes its devices:
on a ('data', 'space') mesh of shape (d, s) rank ``i_data * s + i_space``.
:meth:`Mesh.axis_mesh` is the mesh of the ranks that share this rank's coordinates
on every other axis, whose collectives run over that one axis; ``make_mesh`` creates
every such group on every rank, in one order (``dist.new_group`` is collective).

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
from artist_style_transfer_tpu_torch.utils.trace import span

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
    # {axis: the one-axis mesh of this rank's line along it}, for a mesh of several axes
    lines: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def axis_size(self, axis: str) -> int:
        """Ranks on ``axis``; 1 when the mesh has no such axis."""
        return self.shape[self.axis_names.index(axis)] if axis in self.axis_names else 1

    def coord(self, axis: str) -> int:
        """This rank's coordinate on ``axis`` (row-major over ``shape``); 0 without it."""
        if axis not in self.axis_names:
            return 0
        i = self.axis_names.index(axis)
        return self.rank // math.prod(self.shape[i + 1:]) % self.shape[i]

    def axis_mesh(self, axis: str) -> Mesh:
        """The ranks that share this rank's coordinates on every axis but ``axis``, as a
        one-axis mesh whose collectives run over ``axis`` alone: the mesh itself when it
        has that one axis, a mesh of this rank alone when ``axis`` is absent or 1 long."""
        if self.axis_names == (axis,):
            return self
        if self.axis_size(axis) == 1:
            return Mesh(None, (axis,), (1,), 0, self.device, None)
        require_ranks(self)
        return self.lines[axis]

    def all_reduce_(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """Sum (or max, ``op="max"``) ``t`` over the ranks, in place; returns ``t``."""
        if self.group is not None:
            with span("mesh.collective"):
                dist.all_reduce(t, op=_OPS[op], group=self.group)
        return t

    def all_gather(self, t: torch.Tensor) -> list[torch.Tensor]:
        """Every rank's ``t`` (the same shape and dtype on each), in rank order."""
        if self.group is None:
            return [t]
        out = [torch.empty_like(t) for _ in range(self.size)]
        with span("mesh.collective"):
            dist.all_gather(out, t.contiguous(), group=self.group)
        return out

    def broadcast_(self, t: torch.Tensor) -> torch.Tensor:
        """Rank 0's ``t`` on every rank, in place; returns ``t``."""
        if self.group is not None:
            with span("mesh.collective"):
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
    group, backend, lines = None, None, {}
    if dist.is_initialized():
        group = dist.group.WORLD if ranks == list(range(world)) else dist.new_group(ranks)
        lines = _axis_lines(shape, axis_names, ranks, me, group, dev)
        if me not in ranks:
            raise ValueError(f"rank {me} is not one of the mesh's ranks {ranks}")
        backend = dist.get_backend(group)
        if backend == "nccl" and dev.type != "cuda":
            raise ValueError(f"an NCCL mesh runs on CUDA devices, not on {dev}")
    return Mesh(group, tuple(axis_names), shape, ranks.index(me), dev, backend, lines)


def _axis_lines(shape: tuple[int, ...], axis_names: tuple[str, ...], ranks: list[int],
                me: int, group, dev: torch.device) -> dict[str, Mesh]:
    """{axis: the one-axis mesh of ``me``'s line along it} for a mesh of several axes.

    Every rank of the world creates the group of every line of more than one rank and
    fewer than all, axis by axis, lines in row-major order, so the collective
    ``new_group`` calls pair up; a line of all the mesh's ranks takes ``group``."""
    if len(shape) < 2:
        return {}
    n = math.prod(shape)
    lines = {}
    for i, axis in enumerate(axis_names):
        stride = math.prod(shape[i + 1:])
        for first in range(n):
            if first // stride % shape[i]:
                continue  # not the first rank of its line
            line = [ranks[first + k * stride] for k in range(shape[i])]
            if shape[i] == 1:
                g = None
            else:
                g = group if shape[i] == n else dist.new_group(line)
            if me in line:
                lines[axis] = Mesh(g, (axis,), (shape[i],), line.index(me), dev,
                                   None if g is None else dist.get_backend(g))
    return lines


def require_ranks(mesh: Mesh | None) -> Mesh | None:
    """``mesh``, when its process group holds the ranks its shape needs; else
    ``ValueError`` (a shape over a smaller group would make every collective the
    identity on ranks that do not exist)."""
    if mesh is not None:
        have = 1 if mesh.group is None else dist.get_world_size(mesh.group)
        if mesh.size > have:
            raise ValueError(f"mesh shape {mesh.shape} needs {mesh.size} ranks; its process "
                             f"group holds {have}")
    return mesh


def spatial_size(mesh: Mesh | None, axis: str = "space") -> int:
    """Ranks on the spatial (image-rows) mesh axis; 1 when absent."""
    return 1 if mesh is None else mesh.axis_size(axis)


def shard_batch(x, mesh: Mesh | None):
    """This rank's equal slice of axis 0 of ``x`` (a tensor or an array), by its
    coordinate on every axis but 'space' (whose ranks share one slice, JAX's
    ``P("data", "space")``); ``x`` as it is when ``mesh`` is None. The slices must
    divide the batch."""
    if mesh is None:
        return x
    n = data_size(mesh)
    if x.shape[0] % n:
        raise ValueError(f"batch of {x.shape[0]} does not divide over the {n}-rank mesh")
    b = x.shape[0] // n
    i = 0  # this rank's slice: its row-major coordinates on every axis but 'space'
    for axis, size in zip(mesh.axis_names, mesh.shape):
        if axis != "space":
            i = i * size + mesh.coord(axis)
    return x[i * b : (i + 1) * b]


def check_mesh(mesh: Mesh | None) -> Mesh | None:
    """``mesh`` for any entry point of the port, which shards batches over 'data' and
    image rows over 'space': a mesh with another axis larger than 1 raises
    ``NotImplementedError``, one whose shape exceeds its process group ``ValueError``."""
    if mesh is not None and any(s > 1 for a, s in zip(mesh.axis_names, mesh.shape)
                                if a not in ("data", "space")):
        raise NotImplementedError(
            f"a mesh with axes {dict(zip(mesh.axis_names, mesh.shape))}: the port shards "
            "over 'data' and 'space' alone")
    return require_ranks(mesh)


def data_size(mesh: Mesh | None) -> int:
    """The number of data slices: the mesh's ranks over its 'space' ranks (1 without a
    mesh)."""
    return 1 if mesh is None else mesh.size // spatial_size(mesh)
