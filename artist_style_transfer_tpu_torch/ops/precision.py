"""Global matmul/conv precision policy (counterpart of the JAX ``ops/precision.py``).

- ``"highest"`` (default): true f32 — parity mode. Turns TF32 off in both
  cuBLAS (``torch.backends.cuda.matmul.allow_tf32``) and cuDNN
  (``torch.backends.cudnn.allow_tf32``). cuDNN's own default is True, which
  silently runs every f32 convolution in TF32 (about three decimal digits).
  It also forbids cuBLAS's reduced-precision (bf16) split-K reductions
  (``allow_bf16_reduced_precision_reduction``), so a bf16 matmul, such as
  the Gram backward under ``compute_dtype="bfloat16"``, sums in f32 like
  JAX's ``preferred_element_type=float32``.
- ``"default"`` / ``"high"``: TF32 on in both, bf16 reduced-precision
  reductions allowed (torch's default) — the throughput mode.

The policy is applied to torch's flags when this module is imported, so the
default is real from the first call, and again on every change.
"""

from __future__ import annotations

import contextlib

import torch

_PRECISION: str = "highest"
_CHOICES = ("highest", "default", "high")


def _apply(p: str) -> None:
    fast = p != "highest"
    torch.backends.cuda.matmul.allow_tf32 = fast
    torch.backends.cudnn.allow_tf32 = fast
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = fast


def get_precision() -> str:
    return _PRECISION


def set_precision(p: str) -> None:
    global _PRECISION
    if p not in _CHOICES:
        raise ValueError(f"precision must be one of {_CHOICES}, got {p!r}")
    _PRECISION = p
    _apply(p)


@contextlib.contextmanager
def precision(p: str):
    """Temporarily override the global precision policy."""
    prev = get_precision()
    set_precision(p)
    try:
        yield
    finally:
        set_precision(prev)


_apply(_PRECISION)
