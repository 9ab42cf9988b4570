"""Tests of the port's benchmark. Run from the checkout's root:

    python -m pytest portbench/tests -q

Tests that need the card carry the ``cuda`` marker and skip inside the fixture
``cuda_device`` where there is none (``python -m pytest portbench/tests -m cuda`` on the
card)."""

from __future__ import annotations

import pathlib
import sys

import pytest

BENCH = pathlib.Path(__file__).resolve().parents[1]
for p in (str(BENCH.parent), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA card; skipped without one")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
