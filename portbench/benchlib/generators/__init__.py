"""The general generators that traffic files name under ``generator``.

A generator's ``setup(cfg, traffic, seed, device)`` makes the inputs and weights from the
seed, builds the program's objects the way its entry point builds them and warms up
the cell's shapes; it returns a :class:`Cell`. Each generator keeps what the reference
needs, and the program's outputs, until ``check``.
"""

from __future__ import annotations

import importlib

import torch


class Cell:
    """One cell's program state. ``unit(i)`` runs unit i, ending in a sync;
    ``trace_units`` units make one pass, the traced window's and the readings'."""

    span = "portbench:unit"
    images_per_unit = 1
    steps_per_unit = 1
    trace_units = 1

    def unit(self, i: int) -> None:
        raise NotImplementedError

    def prepare_window(self, max_units: int) -> None:
        """Make, before the window, whatever the host needs for up to ``max_units`` units."""

    def work(self, peaks: dict) -> dict:
        """Counts for one unit: ``least_s`` (the operations' least time) and, where a
        hand-written kernel runs, ``k1_bound_s``/``k1_launches`` or
        ``k2_bound_s``/``k2_launches``."""
        raise NotImplementedError

    def free(self) -> None:
        """Drop the program's objects, keeping its outputs and the reference's inputs."""
        raise NotImplementedError

    def check(self, variant: str = "reference") -> dict:
        """The numbers compared, of the program's outputs against the reference (or,
        with ``variant="control"``, of the control against the reference)."""
        raise NotImplementedError

    def diagnostics(self) -> dict:
        """Numbers read beside the compared ones to set the limits, and not compared."""
        return {}


def load(name: str):
    return importlib.import_module(f"benchlib.generators.{name}")


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def set_tf32(on: bool) -> tuple[bool, bool]:
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    return prev


def restore_tf32(prev: tuple[bool, bool]) -> None:
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def load_net(cls, state: dict, device: torch.device):
    """A program net built on the meta device and filled with ``state`` (no init run)."""
    with torch.device("meta"):
        net = cls()
    net = net.to_empty(device=device)
    net.load_state_dict(state)
    return net
