"""Reflection padding (counterpart of the JAX ``ops/pad.py``; reference cnn.py:55-60)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def reflect_pad_hw(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Reflect-pad the H and W axes of an NCHW tensor by ``pad`` on each side.

    Matches ``nn.ReflectionPad2d(pad)``: reflection without repeating the
    edge pixel. ``pad == 0`` is the identity. Keeps ``channels_last``.
    """
    if pad == 0:
        return x
    return F.pad(x, (pad, pad, pad, pad), mode="reflect")


def reflect_pad_w(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Reflect-pad only the W axis of an NCHW tensor by ``pad`` on each side (JAX
    ``reflect_pad_w``, whose batch-folded TPU path keeps the H padding in the fold's
    separator rows). ``pad == 0`` is the identity. Keeps ``channels_last``."""
    if pad == 0:
        return x
    return F.pad(x, (pad, pad, 0, 0), mode="reflect")
