"""Device prefetch: overlap the host-to-device copy of the next batches with compute
(counterpart of the JAX ``data/prefetch.py``).

The resident training path keeps its corpus on the device; this iterator
serves a streamed corpus. On CUDA each host batch is staged in pinned
(page-locked) memory and copied with ``non_blocking=True`` on a copy stream
of its own, ``buffer_size`` batches ahead, so the copy of batch k+1 runs
while step k computes on the consumer's stream; a helper thread does the
staging and launches the copies. Before a batch is yielded, the consumer's
stream waits on its copy's event, and the tensor is marked as used there
(``record_stream``), so the caching allocator does not hand its memory to
the copy stream while the consumer's kernels may still read it. Each pinned
buffer stays referenced until its copy has completed.

On the CPU it is a plain pass-through with the same bounded look-ahead and
no pinning.

Under a mesh (``sharding=``, a :class:`parallel.mesh.Mesh`) every process's stream
yields its host-local slice of each global batch, as a multi-process JAX mesh's
does, and each slice goes to that rank's device: the mesh's, which must be the
``device`` asked for. Where JAX assembles the slices into one global array, here
each rank's step takes its slice as it is (``train.loop``'s streamed step).
"""

from __future__ import annotations

import collections
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Iterable, Iterator

import numpy as np
import torch

from artist_style_transfer_tpu_torch.parallel.mesh import Mesh
from artist_style_transfer_tpu_torch.utils.device import resolve_device, same_device


def device_prefetch(
    batches: Iterable,
    buffer_size: int = 2,
    device: str | torch.device | None = None,
    sharding=None,
) -> Iterator[torch.Tensor]:
    """Yield each batch as a tensor on ``device`` (``None``: CUDA), keeping
    ``buffer_size`` copies in flight.

    Checks run at call time, not at the first ``next()``: ``buffer_size < 1``
    would yield nothing (silent data loss, not "no prefetch") and raises, and so
    does a ``sharding`` mesh whose rank lives on another device than ``device``.
    """
    if buffer_size < 1:
        raise ValueError(f"buffer_size must be >= 1, got {buffer_size}")
    dev = resolve_device(device)
    if sharding is not None:
        if not isinstance(sharding, Mesh):
            raise TypeError(f"sharding must be a parallel.mesh.Mesh, got {type(sharding).__name__}")
        if not same_device(sharding.device, dev):
            raise ValueError(f"this rank's device is {sharding.device}, not {dev}")
    stage = _CudaStage(dev) if dev.type == "cuda" else _HostStage(dev)
    return _prefetch(iter(batches), buffer_size, stage)


class _HostStage:
    """The CPU: the batch as a tensor, nothing in flight."""

    def __init__(self, dev: torch.device):
        self.dev = dev

    def put(self, batch) -> torch.Tensor:
        return torch.as_tensor(np.asarray(batch), device=self.dev)

    def take(self, item: torch.Tensor) -> torch.Tensor:
        return item

    def finish(self) -> None:
        pass


class _CudaStage:
    """Pinned staging and non-blocking copies on a dedicated stream of ``dev``, launched by
    one helper thread: staging a batch in pinned memory is a host copy of the whole
    batch (1-5 ms for 2.4 MB on the H100 machine's host), which would otherwise add to
    the training loop's own thread, the one that launches every kernel."""

    def __init__(self, dev: torch.device):
        self.dev = dev
        self.stream = torch.cuda.Stream(device=dev)
        self.helper = ThreadPoolExecutor(max_workers=1, thread_name_prefix="h2d")
        self.in_flight: list[tuple[torch.cuda.Event, torch.Tensor]] = []  # (copy done, pinned)

    def put(self, batch) -> Future:
        return self.helper.submit(self._stage, np.asarray(batch))

    def _stage(self, batch: np.ndarray) -> tuple[torch.Tensor, torch.cuda.Event]:
        # Only this thread touches in_flight: a pinned buffer is dropped once its copy
        # has completed, never while the copy may still read it.
        self.in_flight = [(ev, buf) for ev, buf in self.in_flight if not ev.query()]
        host = torch.as_tensor(batch).pin_memory()
        with torch.cuda.stream(self.stream):
            out = host.to(self.dev, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self.stream)
        self.in_flight.append((done, host))
        return out, done

    def take(self, item: Future) -> torch.Tensor:
        out, done = item.result()
        consumer = torch.cuda.current_stream(self.dev)
        consumer.wait_event(done)
        out.record_stream(consumer)
        return out

    def finish(self) -> None:
        self.helper.shutdown(wait=True, cancel_futures=True)
        self.stream.synchronize()  # no copy may outlive its pinned buffer
        self.in_flight.clear()


def _prefetch(it: Iterator, buffer_size: int, stage) -> Iterator[torch.Tensor]:
    queue = collections.deque()
    try:
        for batch in it:
            queue.append(stage.put(batch))
            if len(queue) == buffer_size:
                break
        while queue:
            out = stage.take(queue.popleft())
            for batch in it:  # refill by one
                queue.append(stage.put(batch))
                break
            yield out
    finally:
        stage.finish()
