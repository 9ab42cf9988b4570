"""Faults planted under the timed path, which the check has to catch: each a context
manager that patches the program while it is open. The CPU tests drive whole runs with
them; ``readings.py`` reads them on the card.

- ``unchanged``: the optimizer's step leaves the parameters as they are;
- ``half_batch``: the loss or the output is computed from the first half of each batch
  and the rest is left out (the mean over the rows kept; outputs repeated to fill);
- ``altered``: one answer altered where it is produced.
"""

from __future__ import annotations

import contextlib
from unittest import mock

import torch


def _half(n: int) -> int:
    return max(1, n // 2)


@contextlib.contextmanager
def unchanged():
    with mock.patch.object(torch.optim.Adam, "step", lambda self, closure=None: None):
        yield


@contextlib.contextmanager
def train_half_batch():
    from artist_style_transfer_tpu_torch.train import loop

    content, style = loop.content_loss, loop.style_loss_gram

    def content_half(gen, ref):
        return content(gen[: _half(gen.shape[0])], ref[: _half(ref.shape[0])])

    def style_half(feats, grams, **kw):
        return style({k: v[: _half(v.shape[0])] for k, v in feats.items()}, grams, **kw)

    with mock.patch.object(loop, "content_loss", content_half), \
            mock.patch.object(loop, "style_loss_gram", style_half):
        yield


def _fill(out: torch.Tensor, n: int) -> torch.Tensor:
    return out.repeat((-(-n // out.shape[0]),) + (1,) * (out.dim() - 1))[:n]


@contextlib.contextmanager
def eval_half_batch():
    from artist_style_transfer_tpu_torch.infer import evaluate

    orig = evaluate.eval_logits

    def half(model, classifier, images, *a, **kw):
        n = images.shape[0]
        return _fill(orig(model, classifier, images[: _half(n)], *a, **kw), n)

    with mock.patch.object(evaluate, "eval_logits", half):
        yield


@contextlib.contextmanager
def eval_altered():
    from artist_style_transfer_tpu_torch.infer import evaluate

    orig = evaluate.eval_logits

    def altered(*a, **kw):
        out = orig(*a, **kw).clone()
        out[0] = out[0].flip(-1)  # the first image's classes in reverse order
        return out

    with mock.patch.object(evaluate, "eval_logits", altered):
        yield


@contextlib.contextmanager
def stylize_half_batch():
    from artist_style_transfer_tpu_torch.infer import stylize

    orig = stylize.stylize_int8

    def half(qmodel, images, *a, **kw):
        n = images.shape[0]
        return _fill(orig(qmodel, images[: _half(n)], *a, **kw), n)

    with mock.patch.object(stylize, "stylize_int8", half):
        yield


@contextlib.contextmanager
def stylize_altered():
    from artist_style_transfer_tpu_torch.infer import stylize

    orig = stylize.stylize_int8

    def altered(*a, **kw):
        out = orig(*a, **kw).clone()
        out[0] = 255 - out[0]
        return out

    with mock.patch.object(stylize, "stylize_int8", altered):
        yield


# The faults each generator's cells can have (one card: no exchange between chips).
BY_GENERATOR = {
    "train_cycle": {"unchanged": unchanged, "half_batch": train_half_batch},
    "evaluate": {"half_batch": eval_half_batch, "altered": eval_altered},
    "stylize": {"half_batch": stylize_half_batch, "altered": stylize_altered},
}
