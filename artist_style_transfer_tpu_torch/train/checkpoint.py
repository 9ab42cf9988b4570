"""Checkpoints and exports (counterpart of the JAX ``train/checkpoint.py``).

- The reference's directory semantics: ``<model_dir>/<artist>/<method>/
  transfer[2]_<cw>-<sw>_<epoch>`` (train_cnn.py:173-178), the ``transfer2_``
  bump when the directory is not empty included.
- Resumable checkpoints ``<prefix>_<label>.ckpt``: one ``torch.save`` file of
  {model, optimizer, scheduler, completed} (the JAX package writes an orbax
  directory under the same name; orbax is JAX-only).
- ``.npz`` parameter files in the JAX package's key layout (``encoder/0/w``,
  HWIO weights), so each package reads the other's: the TransformerNet's, the
  classifier's and the diffusion UNet's.
- ``.pth`` export under the reference keys in float64 (cnn.py:43), which for
  the port is its own state dict; the trained artist classifier as the
  reference's ``{'model': state_dict}`` (:func:`export_classifier_pth`).
"""

from __future__ import annotations

import os
import warnings

import numpy as np
import torch

from artist_style_transfer_tpu_torch.diffusion.unet import DiffModel
from artist_style_transfer_tpu_torch.models.resnet import ResNet50Classifier
from artist_style_transfer_tpu_torch.utils.jax_params import (
    classifier_state_dict_to_jax,
    diff_model_state_dict_from_jax,
    diff_model_state_dict_to_jax,
    numbered_to_lists,
    transformer_state_dict_from_jax,
    transformer_state_dict_to_jax,
)


def save_dir_prefix(model_dir: str, artist: str, method: str, cw, sw, bump: bool = True) -> str:
    """Reference checkpoint naming (train_cnn.py:173-178), including the
    'transfer2' bump if the directory already has files.

    ``bump=False`` always returns the primary 'transfer_' prefix.
    """
    d = os.path.join(model_dir, artist, method)
    os.makedirs(d, exist_ok=True)
    stem = "transfer_" if (not bump or not os.listdir(d)) else "transfer2_"
    return os.path.join(d, f"{stem}{fmt_weight(cw)}-{fmt_weight(sw)}")


def fmt_weight(w) -> str:
    """The reference formats weights with str(); whole numbers print bare (17-25)."""
    return str(int(w)) if float(w) == int(w) else str(w)


def resume_prefix(model_dir: str, artist: str, method: str, cw, sw) -> str:
    """Prefix to resume from: probe both name stems.

    A second run in the same directory checkpoints under 'transfer2_', so
    resuming picks the stem whose newest checkpoint was written last; with
    none, it warns and starts fresh under 'transfer_'.
    """
    d = os.path.join(model_dir, artist, method)
    w = f"{fmt_weight(cw)}-{fmt_weight(sw)}"
    candidates = [os.path.join(d, f"{stem}{w}") for stem in ("transfer_", "transfer2_")]
    best, best_mtime = None, -1.0
    for prefix in candidates:
        found = latest_checkpoint(prefix)
        if found is not None:
            mtime = os.path.getmtime(found[0])
            if mtime > best_mtime:
                best, best_mtime = prefix, mtime
    if best is None:
        warnings.warn(f"resume=True but no checkpoint found under {d}; starting fresh",
                      stacklevel=2)
        os.makedirs(d, exist_ok=True)
        return candidates[0]
    return best


def latest_checkpoint(prefix: str) -> tuple[str, int] | None:
    """The newest ``<prefix>_<epoch>.ckpt``, as (path, epoch), or None."""
    d = os.path.dirname(prefix)
    stem = os.path.basename(prefix)
    best = None
    if not os.path.isdir(d):
        return None
    for name in os.listdir(d):
        if name.startswith(stem + "_") and name.endswith(".ckpt"):
            try:
                ep = int(name[len(stem) + 1 : -len(".ckpt")])
            except ValueError:
                continue
            if best is None or ep > best[1]:
                best = (os.path.join(d, name), ep)
    return best


def save_checkpoint(
    prefix: str,
    epoch_label: int,
    model: torch.nn.Module,
    optimizer: torch.optim.Optimizer | None = None,
    scheduler=None,
    losses: np.ndarray | None = None,
    completed_epochs: int | None = None,
) -> str:
    """Save a resumable checkpoint at ``<prefix>_<epoch_label>.ckpt`` (+ losses ``.npy``).

    ``epoch_label`` follows the reference file naming (mid-run saves carry
    the just-finished epoch index, the final save num_epochs);
    ``completed_epochs`` is the resume cursor, by default ``epoch_label + 1``.
    """
    path = os.path.abspath(f"{prefix}_{epoch_label}.ckpt")
    payload = {
        "model": model.state_dict(),
        "completed": int(completed_epochs if completed_epochs is not None else epoch_label + 1),
    }
    if optimizer is not None:
        payload["optimizer"] = optimizer.state_dict()
    if scheduler is not None:
        payload["scheduler"] = scheduler.state_dict()
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    if losses is not None:
        np.save(f"{prefix}_{epoch_label}.npy", losses)
    return path


def restore_checkpoint(
    path: str,
    model: torch.nn.Module,
    optimizer: torch.optim.Optimizer | None = None,
    scheduler=None,
) -> int:
    """Load a :func:`save_checkpoint` file into ``model`` (and the optimizer and
    scheduler, where given) in place; returns the number of completed epochs."""
    dev = next(model.parameters()).device
    payload = torch.load(path, map_location=dev, weights_only=True)
    model.load_state_dict(payload["model"])
    if optimizer is not None:
        optimizer.load_state_dict(payload["optimizer"])
    if scheduler is not None:
        scheduler.load_state_dict(payload["scheduler"])
    return int(payload["completed"])


def _flatten_tree(tree) -> dict[str, np.ndarray]:
    """A nested dict/list pytree -> ``{"a/0/b": leaf}``, the keys of JAX ``_path_key``."""
    flat: dict[str, np.ndarray] = {}

    def walk(node, key):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{key}/{k}" if key else k)
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, f"{key}/{i}")
        else:
            flat[key] = node

    walk(tree, "")
    return flat


def _read_npz_tree(path: str):
    """A ``save_params_npz`` file of either package -> its nested dict/list pytree of
    numpy arrays (the inverse of :func:`_flatten_tree`)."""
    tree: dict = {}
    with np.load(path) as z:
        for key in z.files:
            *parents, leaf = key.split("/")
            node = tree
            for part in parents:
                node = node.setdefault(part, {})
            node[leaf] = z[key]
    return numbered_to_lists(tree)


def save_params_npz(path: str, model: torch.nn.Module) -> None:
    """Flat ``.npz`` of a TransformerNet, a ResNet-50 classifier or a diffusion UNet in
    the JAX key layout (``encoder/0/w``, ``stages/1/0/down_bn/var``,
    ``down/0/blocks/1/conv1/w``, ...), as JAX ``save_params_npz`` writes each pytree."""
    if isinstance(model, ResNet50Classifier):
        to_jax = classifier_state_dict_to_jax
    elif isinstance(model, DiffModel):
        to_jax = diff_model_state_dict_to_jax
    else:
        to_jax = transformer_state_dict_to_jax
    np.savez(path, **_flatten_tree(to_jax(model.state_dict())))


def load_params_npz(path: str) -> dict[str, torch.Tensor]:
    """A TransformerNet ``.npz`` (either package's) -> the port's state dict."""
    return transformer_state_dict_from_jax(_read_npz_tree(path))


def load_diff_model_npz(path: str) -> dict[str, torch.Tensor]:
    """A diffusion UNet ``.npz`` (either package's, e.g. the CLI's
    ``models/diffusion/diff_model.npz``) -> a :class:`diffusion.unet.DiffModel` state dict."""
    return diff_model_state_dict_from_jax(_read_npz_tree(path))


def export_pth(path: str, model: torch.nn.Module) -> None:
    """Reference-loadable ``.pth`` state dict, tensors in float64 (cnn.py:43)."""
    sd = {k: v.detach().cpu().double().contiguous() for k, v in model.state_dict().items()}
    torch.save(sd, path)


def export_classifier_pth(path: str, model: ResNet50Classifier) -> None:
    """The trained artist classifier as a reference-loadable ``.pth`` (JAX
    ``export_classifier_pth``): its state dict nested under ``{'model': ...}``, as the
    reference loads ``models/best-2.pth`` (classifier.py:62-63), float tensors in f32
    (the reference casts after loading, classifier.py:66)."""
    sd = {k: v.detach().cpu().contiguous() for k, v in model.state_dict().items()}
    torch.save({"model": sd}, path)
