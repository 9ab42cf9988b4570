"""Micro-batching stylization server (counterpart of the JAX ``infer/serve.py``).

The reference has no serving story: ``inference.py`` is a run-once script
(inference.py:1-166). This module is the long-lived form, with no dependency
beyond the port:

- :class:`StylizeServer`, a background-thread micro-batcher. ``submit()``
  returns a ``concurrent.futures.Future``; the worker groups queued requests by
  (model, H, W) (padding would shift the instance-norm statistics), takes the
  oldest key first, waits at most ``max_wait_ms`` for a batch of ``max_batch``,
  and runs it through :func:`infer.stylize.stylize` or, for a quantized model,
  :func:`infer.stylize.stylize_int8` (kernel K2 on the card).
- :class:`ModelRegistry`, a thread-safe name -> TransformerNet map with hot reload
  of a checkpoint whose mtime changed.
- uint8 in, uint8 out: the batch crosses to the device as uint8 in the worker and
  is cast there.

Every launch goes to the current stream, which is the device's default stream in
every thread, so the kernels' cached scratch is used by one stream only (see
``ops/cuda/qconv_kernel.py``). Do not give a batcher its own stream.
"""

from __future__ import annotations

import collections
import logging
import os
import threading
import time
from concurrent.futures import Future, InvalidStateError

import numpy as np
import torch

from artist_style_transfer_tpu_torch.infer.stylize import (
    load_transfer_params,
    stylize,
    stylize_int8,
)
from artist_style_transfer_tpu_torch.models.transformer_q import (
    QuantizedTransformerNet,
    quantize_transformer,
)
from artist_style_transfer_tpu_torch.utils.device import resolve_device


def _is_quantized(model) -> bool:
    """A model made by :func:`models.transformer_q.quantize_transformer`."""
    return isinstance(model, QuantizedTransformerNet)


def _apply_params(model, images: torch.Tensor) -> np.ndarray:
    """Stylize a device batch with ``model`` (int8 when quantized); uint8 NHWC numpy."""
    fn = stylize_int8 if _is_quantized(model) else stylize
    return fn(model, images, device=images.device).cpu().numpy()


class ModelRegistry:
    """Thread-safe name -> TransformerNet registry with hot reload (JAX ``ModelRegistry``).

    Every model stays resident on ``device`` (``None``: CUDA); a model's weights
    swap atomically when its checkpoint file changes, without dropping in-flight
    requests: a batch dispatched before the swap finishes with the old weights,
    the next batch takes the new ones.

    Files: ``.pth`` (the reference checkpoint layout, train_cnn.py:383-390) or
    ``.npz`` (either package's export), through :func:`infer.stylize.load_transfer_params`.
    """

    def __init__(self, auto_reload: bool = False, quantize: bool = False,
                 calib_images: np.ndarray | None = None,
                 device: str | torch.device | None = None):
        """``quantize=True`` converts every loaded model to the int8 net
        (:func:`models.transformer_q.quantize_transformer`). ``calib_images`` (NHWC
        BGR [0,255]) supply its activation-scale calibration; by default the JAX
        package's fixed synthetic images, so the scales equal JAX's. Miscalibration
        costs rounding only, never bias: every quantized conv feeds an IN."""
        self._device = resolve_device(device)
        self._lock = threading.Lock()
        # name -> (model, path | None, mtime | None)
        self._models: dict[str, tuple[object, str | None, float | None]] = {}
        self._auto = bool(auto_reload)
        self._quantize = bool(quantize)
        self._calib = calib_images

    def _maybe_quantize(self, model):
        if not self._quantize or _is_quantized(model):
            return model
        calib = self._calib
        if calib is None:
            calib = np.random.default_rng(0).random((2, 256, 256, 3)) * 255
        return quantize_transformer(model, calib)

    def _load(self, path: str):
        return self._maybe_quantize(load_transfer_params(path, self._device))

    def register(self, name: str, params=None, *, path: str | None = None) -> None:
        """Add (or replace) a model: an in-memory net (moved to the registry's device)
        or a checkpoint file."""
        if (params is None) == (path is None):
            raise ValueError("pass exactly one of params= or path=")
        mtime = None
        if path is not None:
            params = self._load(path)
            mtime = os.stat(path).st_mtime
        else:
            params = self._maybe_quantize(params.to(self._device))
        with self._lock:
            self._models[name] = (params, path, mtime)

    def unregister(self, name: str) -> None:
        with self._lock:
            self._models.pop(name, None)

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._models)

    def __contains__(self, name: str) -> bool:
        with self._lock:
            return name in self._models

    def get(self, name: str):
        """The current model for ``name`` (reloaded first if auto-reload is on)."""
        if self._auto:
            self.reload(name)
        with self._lock:
            if name not in self._models:
                raise KeyError(f"model {name!r} is not registered")
            return self._models[name][0]

    def reload(self, name: str, force: bool = False) -> bool:
        """Re-read the model's file if its mtime changed (or ``force``).

        Returns True when new weights were swapped in; no-op for in-memory models. A
        stat or load failure (a trainer rewriting the file) keeps the current weights
        serving and returns False; the next reload retries.
        """
        with self._lock:
            entry = self._models.get(name)
        if entry is None or entry[1] is None:
            return False
        _, path, old_mtime = entry
        try:
            mtime = os.stat(path).st_mtime
            if not force and mtime == old_mtime:
                return False
            params = self._load(path)
        except Exception as e:
            logging.getLogger(__name__).warning(
                "reload of %r from %s failed (keeping current weights): %s", name, path, e)
            return False
        with self._lock:
            self._models[name] = (params, path, mtime)
        return True


class StylizeServer:
    """Background micro-batcher around the stylize path (JAX ``StylizeServer``).

    Thread-safe; ``submit`` may be called from any number of threads.
    Single-tenant: ``StylizeServer(model)``. Multi-tenant:
    ``StylizeServer(registry=reg)``; each request names its model and batches form
    per (model, H, W).

    ``apply_fn(params, images) -> np.ndarray`` replaces the model call: ``images`` is
    the batch as a uint8 NHWC tensor on ``device`` (``None``: CUDA), and the result's
    rows go to the requests in order. The HTTP ``/v1/classify`` endpoint rides this
    with the int8 classifier.
    """

    def __init__(self, params=None, max_batch: int = 8, max_wait_ms: float = 3.0,
                 registry: ModelRegistry | None = None, apply_fn=None,
                 device: str | torch.device | None = None):
        if (params is None) == (registry is None):
            raise ValueError("pass exactly one of params= or registry=")
        self._device = resolve_device(device)
        self._params = params
        self._registry = registry
        self._apply = apply_fn if apply_fn is not None else _apply_params
        self._max_batch = int(max_batch)
        self._max_wait_s = float(max_wait_ms) / 1e3
        self._lock = threading.Condition()
        # (model, H, W) -> deque of (image, future); _order keeps FIFO across keys.
        self._pending: dict[tuple, collections.deque] = {}
        self._order: collections.deque[tuple] = collections.deque()
        self._closed = False
        self.stats = {"batches": 0, "images": 0}
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def submit(self, image_bgr_uint8: np.ndarray, model: str | None = None) -> Future:
        """Queue one HWC BGR uint8 image; resolves to the stylized uint8 HWC.

        ``model`` names a registry entry (required multi-tenant, refused single-tenant).
        """
        if image_bgr_uint8.ndim != 3 or image_bgr_uint8.shape[-1] != 3:
            raise ValueError(f"expected HWC BGR image, got {image_bgr_uint8.shape}")
        if self._registry is not None:
            if model is None:
                raise ValueError("multi-tenant server: submit(..., model=...) required")
            if model not in self._registry:
                raise KeyError(f"model {model!r} is not registered")
        elif model is not None:
            raise ValueError("single-tenant server does not take model=")
        fut: Future = Future()
        key = (model, image_bgr_uint8.shape[0], image_bgr_uint8.shape[1])
        with self._lock:
            if self._closed:
                raise RuntimeError("server is closed")
            self._pending.setdefault(key, collections.deque()).append((image_bgr_uint8, fut))
            self._order.append(key)
            self._lock.notify()
        return fut

    def close(self, timeout: float | None = 10.0) -> None:
        """Drain the queue, then stop the worker."""
        with self._lock:
            self._closed = True
            self._lock.notify()
        self._worker.join(timeout)

    # ------------------------------------------------------------------

    def _take_batch(self):
        """Wait for work; return (key, [(image, future), ...]) or None when done.

        Takes the oldest pending key, then waits up to ``max_wait_s`` for the batch
        to fill with requests of that key.
        """
        with self._lock:
            while not self._order and not self._closed:
                self._lock.wait()
            if not self._order:
                return None  # closed and drained
            key = self._order[0]
            deadline = time.monotonic() + self._max_wait_s
            while len(self._pending.get(key, ())) < self._max_batch and not self._closed:
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not self._lock.wait(timeout=remaining):
                    break
            q = self._pending.get(key, collections.deque())
            batch = [q.popleft() for _ in range(min(self._max_batch, len(q)))]
            # Drop the consumed entries of this key from the FIFO order.
            taken = 0
            kept = collections.deque()
            for k in self._order:
                if k == key and taken < len(batch):
                    taken += 1
                else:
                    kept.append(k)
            self._order = kept
            if not q:
                self._pending.pop(key, None)
            return key, batch

    def _run(self):
        while True:
            item = self._take_batch()
            if item is None:
                return
            key, batch = item
            # A caller that timed out may have cancelled its queued future: move the
            # others to RUNNING (no cancelling after that) and drop the cancelled,
            # since resolving one raises InvalidStateError, which must never kill
            # the worker.
            batch = [(im, fut) for im, fut in batch if fut.set_running_or_notify_cancel()]
            if not batch:
                continue
            images = np.stack([im for im, _ in batch])
            try:
                params = self._params if self._registry is None else self._registry.get(key[0])
                out = self._apply(params, torch.from_numpy(images).to(self._device))
            except Exception as e:  # a device or model failure fails its own requests
                for _, fut in batch:
                    try:
                        fut.set_exception(e)
                    except InvalidStateError:
                        pass
                continue
            self.stats["batches"] += 1
            self.stats["images"] += len(batch)
            for i, (_, fut) in enumerate(batch):
                try:
                    fut.set_result(out[i])
                except InvalidStateError:
                    pass
