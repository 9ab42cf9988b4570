"""Device resolution shared by every entry point of the port."""

from __future__ import annotations

import itertools

import torch


def resolve_device(device: str | torch.device | None) -> torch.device:
    """``None`` means ``"cuda"``; a CUDA device without CUDA raises.

    The port never drops to the CPU on its own: the CPU is used only when
    the caller passes ``device="cpu"`` (as the CPU parity tests do).
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU explicitly"
        )
    return dev


def same_device(a: torch.device, b: torch.device) -> bool:
    """Device equality where a CUDA device without an index means the current one."""
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    cur = torch.cuda.current_device()
    return (cur if a.index is None else a.index) == (cur if b.index is None else b.index)


def module_device(net: torch.nn.Module) -> torch.device:
    """Where a net lives: its first parameter's device, or its first buffer's (the
    quantized nets hold buffers only)."""
    return next(itertools.chain(net.parameters(), net.buffers())).device
