"""Style targets for the training modes (counterpart of the JAX
``train/styles.py``; reference train_cnn.py:172-275).

Each builder returns a ``StyleTargets`` whose tensors live on the VGG's
device for the whole run:

- 'random'       one painting's per-tap Grams                 (train_cnn.py:181-196)
- 'average'      the artist's mean image's Grams              (train_cnn.py:197-205)
- 'cycle'        per-painting Grams, stacked (P, C, C) per tap
                 and indexed by ``step % P``                   (train_cnn.py:206-223)
- 'smartaverage' mean of raw VGG *features* over the corpus,
                 then one Gram                                 (train_cnn.py:224-244)
- 'classifier'   no Grams: the artist's class index for each
                 batch row, the classifier loss's labels       (train_cnn.py:260-272)

Every Gram goes through :func:`ops.gram.gram_matrix`, so on a CUDA device
the targets run the Hopper Gram kernel: four launches per image for
'random' and 'average', four per chunk of at most ``chunk`` paintings for
'cycle', four in all for 'smartaverage', none for 'classifier'.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from artist_style_transfer_tpu_torch.models.resnet import ARTISTS_19
from artist_style_transfer_tpu_torch.models.vgg import VGG_LAYER_NAMES, VGG16Features
from artist_style_transfer_tpu_torch.ops.gram import gram_matrix
from artist_style_transfer_tpu_torch.ops.image import vgg_caffe_preprocess
from artist_style_transfer_tpu_torch.utils.device import module_device

MODES = ("random", "average", "smartaverage", "cycle", "classifier")


@dataclasses.dataclass
class StyleTargets:
    """Device-resident targets for one training run."""

    mode: str
    # {tap: (C, C)} — or for 'cycle': {tap: (P, C, C)}.
    grams: dict[str, torch.Tensor] | None = None
    num_cycle: int = 0  # P for 'cycle', else 0
    labels: torch.Tensor | None = None  # 'classifier': (batch_size,) int64 artist index
    style_preview_bgr: np.ndarray | None = None  # HWC [0,255] for style.jpg

    def gram_for_step(self, step: int) -> dict[str, torch.Tensor]:
        """This step's target Grams."""
        return select_step_grams(self.grams, step, self.num_cycle if self.mode == "cycle" else 0)


def select_step_grams(
    grams: dict[str, torch.Tensor], step: int, num_cycle: int
) -> dict[str, torch.Tensor]:
    """This step's target Grams: for 'cycle' (``num_cycle > 0``) the per-tap
    (P, C, C) stacks indexed by ``step % P``, else ``grams`` as they are.

    ``step`` is the global step count across epochs, a host integer, so the
    index is a view and costs no device sync.
    """
    if not num_cycle:
        return grams
    idx = int(step) % num_cycle
    return {k: v[idx] for k, v in grams.items()}


def _features(vgg: VGG16Features, images_bgr_255: np.ndarray) -> dict[str, torch.Tensor]:
    dev = module_device(vgg)
    x = torch.as_tensor(np.asarray(images_bgr_255, np.float32), device=dev)
    return vgg(vgg_caffe_preprocess(x))


def _grams_of_batch(vgg, images_bgr_255, use_kernel) -> dict[str, torch.Tensor]:
    """Per-tap Grams of a batch of images -> {tap: (B, C, C)}."""
    return {k: gram_matrix(v, use_kernel=use_kernel)
            for k, v in _features(vgg, images_bgr_255).items()}


def build_style_targets(
    mode: str,
    vgg: VGG16Features,
    artist: str,
    *,
    paintings: np.ndarray | None = None,  # (P, H, W, 3) BGR f32 [0,255]
    avg_image: np.ndarray | None = None,  # (H, W, 3) BGR f32 [0,255]
    batch_size: int = 4,
    artist_index: int | None = None,
    rng: np.random.Generator | None = None,
    chunk: int = 8,
    use_kernel: str | bool = "auto",
) -> StyleTargets:
    """Build the style targets for ``mode`` on ``vgg``'s device, in f32.

    The reference expands each painting to the batch size before the VGG
    pass (train_cnn.py:187), producing B identical Gram rows; a (C, C)
    target broadcast against the generated batch's (B, C, C) Grams gives the
    identical MSE (the mean runs over B*C*C either way), so targets are
    stored un-expanded. ``batch_size`` and ``artist_index`` serve only the
    'classifier' mode, whose labels are ``artist_index``, else the index of
    ``artist`` in :data:`ARTISTS_19` (an unknown artist raises ``ValueError``).
    """
    if mode not in MODES:
        raise ValueError(f"enter valid style method! got {mode!r}")  # train_cnn.py:274
    if mode == "classifier":
        if artist_index is None:
            artist_index = ARTISTS_19.index(artist)
        labels = torch.full((batch_size,), artist_index, dtype=torch.int64,
                            device=module_device(vgg))
        return StyleTargets(mode=mode, labels=labels)

    if mode == "average":
        if avg_image is None:
            raise ValueError("'average' style targets need avg_image")
    elif paintings is None or not len(paintings):
        raise ValueError(f"{mode!r} style targets need at least one painting")

    with torch.no_grad():
        if mode in ("random", "average"):
            if mode == "random":
                rng = rng or np.random.default_rng()
                img = paintings[int(rng.integers(0, len(paintings)))]  # train_cnn.py:184
            else:
                img = avg_image
            grams = {k: v[0] for k, v in _grams_of_batch(vgg, img[None], use_kernel).items()}
            return StyleTargets(mode=mode, grams=grams, style_preview_bgr=np.asarray(img))

        p = len(paintings)
        if mode == "cycle":
            per_tap: dict[str, list[torch.Tensor]] = {k: [] for k in VGG_LAYER_NAMES}
            for i in range(0, p, chunk):
                for k, g in _grams_of_batch(vgg, paintings[i : i + chunk], use_kernel).items():
                    per_tap[k].append(g)
            grams = {k: torch.cat(v, dim=0) for k, v in per_tap.items()}
            return StyleTargets(mode=mode, grams=grams, num_cycle=p)

        # 'smartaverage': average of features, then one Gram (train_cnn.py:242-243)
        sums: dict[str, torch.Tensor] | None = None
        for i in range(0, p, chunk):
            s = {k: v.sum(dim=0, keepdim=True)
                 for k, v in _features(vgg, paintings[i : i + chunk]).items()}
            sums = s if sums is None else {k: sums[k] + s[k] for k in sums}
        grams = {k: gram_matrix((v / p).contiguous(), use_kernel=use_kernel)[0]
                 for k, v in sums.items()}
        return StyleTargets(mode=mode, grams=grams)
