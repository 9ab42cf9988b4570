"""Multi-process set-up for data-parallel runs (counterpart of the JAX
``parallel/distributed.py``).

Every process calls :func:`initialize_multihost` before it touches a device; it
joins the process group and binds the process to its GPU, and the same
``make_mesh()`` then sees every rank. :func:`make_global` makes replicated state
equal on every rank, :func:`per_host_batch_slice` names this process's slice of a
global batch. :func:`launch` (in :mod:`parallel.launch`) starts N local ranks.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from artist_style_transfer_tpu_torch.parallel.mesh import Mesh

DEFAULT_PORT = 29500  # torchrun's MASTER_PORT default


def _env_int(*names: str) -> int | None:
    for name in names:
        if name in os.environ:
            return int(os.environ[name])
    return None


def _cluster_detected() -> bool:
    """True when the environment shows a cluster of more than one process.

    A marker alone is not enough: a single-host TPU VM exports
    ``TPU_WORKER_HOSTNAMES`` with one entry, and 1-task Slurm, MPI or torchrun
    jobs export their variables too, so the check asks for evidence of several
    workers (JAX's rule, with torchrun's ``WORLD_SIZE`` added).
    """
    hostnames = os.environ.get("TPU_WORKER_HOSTNAMES", "")
    if len([h for h in hostnames.split(",") if h.strip()]) > 1:
        return True
    if os.environ.get("MEGASCALE_COORDINATOR_ADDRESS"):
        return True
    for count_var in ("SLURM_NTASKS", "OMPI_COMM_WORLD_SIZE", "WORLD_SIZE"):
        try:
            if int(os.environ.get(count_var, "1")) > 1:
                return True
        except ValueError:
            pass
    return False


def initialize_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str = "nccl",
) -> bool:
    """Join the process group from the arguments or the environment; returns True when
    the world holds more than one process.

    A no-op that returns False in a single process, so CLIs may call it
    unconditionally. The environment: JAX's ``COORDINATOR_ADDRESS`` (host:port),
    ``NUM_PROCESSES`` and ``PROCESS_ID``, or torchrun's ``MASTER_ADDR`` /
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK`` and ``LOCAL_RANK``; Slurm's and Open
    MPI's task count and rank where those are absent. A cluster of several processes
    with no coordinator address raises. With ``backend="nccl"`` the process binds
    the GPU of its local rank (``LOCAL_RANK``, Slurm's or MPI's local id; 0 by
    default) before it joins.
    """
    if dist.is_initialized():  # joined already (a launcher did it): nothing to do
        return dist.get_world_size() > 1
    env = os.environ
    if coordinator_address is None:
        coordinator_address = env.get("COORDINATOR_ADDRESS")
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', DEFAULT_PORT)}"
    if num_processes is None:
        num_processes = _env_int("NUM_PROCESSES", "WORLD_SIZE", "SLURM_NTASKS",
                                 "OMPI_COMM_WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("PROCESS_ID", "RANK", "SLURM_PROCID", "OMPI_COMM_WORLD_RANK")
    local_rank = _env_int("LOCAL_RANK", "SLURM_LOCALID", "OMPI_COMM_WORLD_LOCAL_RANK")

    if coordinator_address is None:
        if not _cluster_detected() and not (num_processes or 1) > 1:
            return False
        raise RuntimeError(
            "a cluster of several processes is detected but no coordinator address is "
            "set: export COORDINATOR_ADDRESS (host:port) or MASTER_ADDR and MASTER_PORT")
    if num_processes is None or process_id is None:
        raise ValueError("initialize_multihost needs the number of processes and this "
                         "process's id (NUM_PROCESSES / WORLD_SIZE, PROCESS_ID / RANK)")
    if backend == "nccl":
        torch.cuda.set_device(local_rank or 0)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    return dist.get_world_size() > 1


def _broadcast_tree(mesh: Mesh, tree):
    if isinstance(tree, torch.nn.Module):
        for t in list(tree.parameters()) + list(tree.buffers()):
            with torch.no_grad():
                mesh.broadcast_(t.data)
        return tree
    if isinstance(tree, torch.Tensor):
        with torch.no_grad():
            return mesh.broadcast_(tree.data if tree.requires_grad else tree)
    if isinstance(tree, np.ndarray):
        t = mesh.broadcast_(torch.as_tensor(np.ascontiguousarray(tree)).to(mesh.device))
        return t.cpu().numpy()
    if isinstance(tree, dict):
        return {k: _broadcast_tree(mesh, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_broadcast_tree(mesh, v) for v in tree]
        return out if isinstance(tree, list) else type(tree)(out)
    return tree  # plain values are the same on every rank by construction


def make_global(mesh: Mesh | None, tree):
    """Rank 0's values of the replicated state ``tree`` on every rank.

    ``tree`` nests dicts, lists and tuples of tensors (updated in place, on the
    mesh's device), numpy arrays (returned anew) and modules (their parameters and
    buffers updated in place); anything else is passed through. Under JAX this
    lifts host-local arrays to global ones; here each rank already holds its own
    copy, and the broadcast makes the copies equal, so a rank whose copy was made
    differently (another seed, another file) cannot train apart. A world of one, or
    ``mesh=None``, passes through untouched.
    """
    if mesh is None or mesh.size == 1:
        return tree
    return _broadcast_tree(mesh, tree)


def per_host_batch_slice(global_batch: int) -> tuple[int, int]:
    """(host_batch, offset) of this process's slice of a global batch."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    i = dist.get_rank() if dist.is_initialized() else 0
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by {n} hosts")
    host = global_batch // n
    return host, i * host
