"""Start N ranks on one host, one process each, joined in one process group.

``launch(fn, n, *args, backend=..., device=...)`` spawns ``n`` processes with the
``spawn`` start method (never ``fork``: the parent may already hold CUDA or
threads), joins them over ``tcp://localhost:<free port>``, calls
``fn(mesh, *args)`` in each with a :class:`Mesh` over all of them, and returns
their results in rank order. ``fn`` must be importable by name (a module-level
function: a spawned child imports it anew), and so must its arguments and
result, which cross as plain pickled bytes: each rank gets its own copy of every
tensor (torch's multiprocessing pickler would instead move CPU tensors into
shared memory, and the ranks would update one model between them);
:mod:`parallel.workers` holds the functions the tests and ``chip_smoke.py`` use. A rank that raises or dies fails the launch with its
traceback, and the others are stopped; no rank outlives the call.

Like every entry point of the port, it runs on the card unless asked otherwise:
by default rank r drives ``cuda:r`` over NCCL, and it raises where CUDA is absent.
gloo is used only where the caller names it: the CPU (``device="cpu",
backend="gloo"``), or several ranks on one card (``device="cuda:0",
backend="gloo"``), which NCCL refuses as a duplicate GPU.
"""

from __future__ import annotations

import datetime
import pickle
import queue as queue_mod
import socket
import time
import traceback

import torch
import torch.multiprocessing as mp

from artist_style_transfer_tpu_torch.utils.device import resolve_device


def free_port() -> int:
    """A TCP port on localhost that no process listens on at this moment."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _child(payload: bytes, rank: int, world: int, port: int, backend: str, device: str,
           threads: int | None, timeout_s: float, results) -> None:
    import torch.distributed as dist

    from artist_style_transfer_tpu_torch.parallel.mesh import make_mesh

    try:
        fn, args = pickle.loads(payload)
        if threads:
            torch.set_num_threads(threads)
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev.index if dev.index is not None else 0)
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                                world_size=world, rank=rank,
                                timeout=datetime.timedelta(seconds=timeout_s))
        try:
            out = fn(make_mesh(device=dev), *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, pickle.dumps(out)))
    except BaseException:  # reported to the parent, which fails the launch
        results.put((rank, False, traceback.format_exc()))


def launch(fn, nprocs: int, *args, backend: str = "nccl", device: str | None = None,
           threads: int | None = 1, timeout_s: float = 600.0) -> list:
    """Run ``fn(mesh, *args)`` on ``nprocs`` local ranks; returns their results by rank.

    ``device`` is every rank's device: ``None`` or ``"cuda"`` puts rank r on card r
    (raising without CUDA), ``"cuda:0"`` puts every rank on that card, ``"cpu"`` on
    the CPU. ``backend`` is the process group's, NCCL unless named (an NCCL group on
    the CPU raises ``ValueError``). ``threads`` sets each rank's intra-op threads
    (None: torch's default). Raises ``RuntimeError`` with the first failing rank's
    traceback, or when ``timeout_s`` passes.
    """
    if nprocs < 1:
        raise ValueError(f"nprocs must be >= 1, got {nprocs}")
    dev = resolve_device(device)
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"an NCCL group runs on CUDA devices, not on {dev}; "
                         "name backend='gloo' for the CPU")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    devices = [str(dev) if dev.index is not None or dev.type != "cuda" else f"cuda:{r}"
               for r in range(nprocs)]
    payload = pickle.dumps((fn, args))
    procs = [ctx.Process(target=_child, args=(payload, r, nprocs, port, backend, devices[r],
                                              threads, timeout_s, results),
                         daemon=True)
             for r in range(nprocs)]
    for p in procs:
        p.start()
    out: dict[int, object] = {}
    failure = None
    deadline = time.monotonic() + timeout_s
    try:
        while len(out) < nprocs and failure is None:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue_mod.Empty:
                if time.monotonic() > deadline:
                    failure = f"launch of {nprocs} ranks timed out after {timeout_s} s"
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode not in (None, 0)]
                if dead and failure is None:
                    # Give a dying rank's report a moment to arrive before naming the exit.
                    try:
                        rank, ok, value = results.get(timeout=5.0)
                    except queue_mod.Empty:
                        failure = (f"rank {dead[0]} exited with code {procs[dead[0]].exitcode} "
                                   "without a result")
                        continue
                else:
                    continue
            if ok:
                out[rank] = pickle.loads(value)
            else:
                failure = f"rank {rank} failed:\n{value}"
    finally:
        for p in procs:
            if failure is not None and p.is_alive():
                p.terminate()
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    if failure is not None:
        raise RuntimeError(failure)
    return [out[r] for r in range(nprocs)]
