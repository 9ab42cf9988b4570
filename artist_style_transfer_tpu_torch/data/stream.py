"""Streamed content corpus: batches decoded from a directory as training runs, for
corpora the device does not hold (counterpart of the JAX ``data/stream.py``).

``train(content_stream=...)`` takes any callable ``epoch -> iterable of
(B, H, W, 3) BGR [0,255] host batches``; :func:`content_file_stream` is the
standard one over a directory of images (the reference's ``images/content/``,
dataset.py:90-111, decoded batch by batch instead of all up front). It yields
exactly the JAX stream's batches for the same arguments:

- the same file list, capped by a ``np.random.default_rng([seed])`` permutation,
  and the same per-epoch order, ``default_rng([seed, epoch])``;
- each of ``num`` processes decodes its ``batch_size / num`` slice of every
  global batch (``_procs=(num, index)``, by default the process group's world
  size and rank, ``(1, 0)`` without one);
- a ragged final batch is kept when the processes divide it, else dropped
  with a warning;
- a file no decoder reads raises: processes pick rows from the shared list by
  position, and a skip on one would desynchronise the global batches.

Where the JAX stream decodes each batch inside ``next()`` (under ``jit`` that
overlaps the device), here the training loop's own thread launches the
kernels, so a decode inside ``next()`` would add to every step. Batches are
therefore decoded ahead on a thread pool, at most ``DECODE_AHEAD`` of them in
flight, and yielded in order. Decode is ``data.datasets``'s policy: the native
pool where available, else OpenCV.
"""

from __future__ import annotations

import collections
import os
import warnings
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np

from artist_style_transfer_tpu_torch.data.datasets import (
    DECODE_THREADS,
    decode_files,
    decoder_route,
)

DECODE_AHEAD = 2 * DECODE_THREADS  # batches decoded ahead of the one the loop takes


class ContentFileStream:
    """The ``content_stream`` callable of :func:`content_file_stream`; ``decoder`` names
    the route it decodes by (``"native"`` or ``"cv2"``)."""

    def __init__(self, paths: list[str], batch_size: int, height: int, width: int, seed: int,
                 nproc: int, pid: int):
        self.paths, self.batch_size = paths, batch_size
        self.height, self.width, self.seed = height, width, seed
        self.nproc, self.pid = nproc, pid
        self.host_batch = batch_size // nproc
        n = len(paths)
        self.tail = n % batch_size
        self.keep_tail = self.tail != 0 and self.tail % nproc == 0
        self.decoder = decoder_route()

    def batch_paths(self, epoch: int) -> list[list[str]]:
        """This process's files of each batch of ``epoch``, in order."""
        n, b, tail = len(self.paths), self.batch_size, self.tail
        order = np.random.default_rng(np.array([self.seed, epoch], np.uint64)).permutation(n)
        local = [order[s : s + b][self.pid * self.host_batch : (self.pid + 1) * self.host_batch]
                 for s in range(0, n - tail, b)]
        if self.keep_tail:
            per = tail // self.nproc
            local.append(order[n - tail :][self.pid * per : (self.pid + 1) * per])
        return [[self.paths[i] for i in idx] for idx in local]

    def decode(self, paths: list[str]) -> np.ndarray:
        # One batch a pool thread: its files are decoded one after the other.
        images = decode_files(paths, self.height, self.width, False, {}, threads=False)
        for path, im in zip(paths, images):
            if im is None:
                raise RuntimeError(
                    f"undecodable content file {path!r}: streaming processes index a shared "
                    "file list, so a skip would desynchronize the global batch")
        return np.stack(images).astype(np.float32)

    def __call__(self, epoch: int):
        """The batches of ``epoch``, decoded ahead on the thread pool."""
        todo = collections.deque(self.batch_paths(epoch))
        pending: collections.deque[Future] = collections.deque()
        pool = ThreadPoolExecutor(max_workers=DECODE_THREADS, thread_name_prefix="decode")
        try:
            while todo or pending:
                while todo and len(pending) < DECODE_AHEAD:
                    pending.append(pool.submit(self.decode, todo.popleft()))
                yield pending.popleft().result()
        finally:
            pool.shutdown(wait=True, cancel_futures=True)


def content_file_stream(
    content_dir: str,
    batch_size: int,
    rescale_height: int,
    rescale_width: int,
    *,
    content_data_size: int | None = None,
    seed: int = 2,
    _procs: tuple[int, int] | None = None,
) -> ContentFileStream:
    """A ``train(content_stream=...)`` callable over the images of ``content_dir``.

    ``batch_size`` is the global batch; each of the ``_procs[0]`` processes yields
    its ``batch_size / num`` slice (``num`` must divide it); ``_procs`` defaults to
    the ``torch.distributed`` world size and rank (JAX ``process_count`` and
    ``process_index``). ``content_data_size`` caps the corpus after a seeded shuffle,
    so the subset is the same every epoch.
    """
    files = sorted(os.listdir(content_dir))
    if content_data_size is not None:
        first = np.random.default_rng(np.array([seed], np.uint64)).permutation(len(files))
        files = [files[i] for i in first[:content_data_size]]
    paths = [os.path.join(content_dir, f) for f in files]
    if not paths:
        raise ValueError(f"no files in {content_dir!r}")
    if _procs is None:
        import torch.distributed as dist

        _procs = (dist.get_world_size(), dist.get_rank()) if dist.is_initialized() else (1, 0)
    nproc, pid = _procs
    if batch_size % nproc:
        raise ValueError(f"batch_size={batch_size} not divisible by {nproc} processes")
    stream = ContentFileStream(paths, batch_size, rescale_height, rescale_width, seed, nproc, pid)
    if stream.tail and not stream.keep_tail:
        warnings.warn(f"dropping ragged final batch of {stream.tail} (not divisible by "
                      f"{nproc} processes)", stacklevel=2)
    return stream
