"""Device resolution shared by every entry point of the port."""

from __future__ import annotations

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
