"""Named spans of the port's own steps, on the profiler's clock.

``with span("eval.stage"): ...`` records the range ``ast:eval.stage`` into whatever
``torch.profiler`` is running (an operator's own, ``train(profile_dir=...)``'s, or a
benchmark's traced pass), beside the device events it launched; nothing is buffered or
exported here. With no profiler running, a span is one call and one branch.
"""

from __future__ import annotations

import contextlib

import torch

PREFIX = "ast:"
_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that records ``ast:<name>`` while a profiler runs, else does nothing."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(PREFIX + name)
    return _OFF
