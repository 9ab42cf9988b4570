"""Quantitative evaluation with the artist classifier (counterpart of the JAX
``infer/evaluate.py``; reference inference.py:153-166).

The repo's one quantitative quality metric: stylize content images, clip to
uint8, center crop 256, torchvision-normalize, classify, and report the top-1
accuracy against the target artist. The reference runs image by image with
host round trips; here each batch runs the whole pipeline on the device, and
only its predictions come back. ``quantize=True`` runs both nets in int8
(:func:`quantize_eval_pipeline`): the quantized stylizer with bf16
accumulators and the quantized frozen classifier, every interior conv on
kernel K2.

With ``mesh`` (a :class:`parallel.mesh.Mesh`, one process a rank, each calling
with the same arguments) every batch the ranks divide is split over them, as
JAX shards it over its 'data' axis: each rank stylizes and classifies its slice,
the int8 classifier's dynamic scales are the whole batch's (the mesh goes to
:func:`eval_logits`), and the predictions are all-gathered, so
every rank returns the same accuracy and rank 0 alone prints. A batch they do not
divide runs whole on every rank (JAX ``evaluate.py:193``).
"""

from __future__ import annotations

import numpy as np
import torch

from artist_style_transfer_tpu_torch.models.resnet import ResNet50Classifier
from artist_style_transfer_tpu_torch.models.resnet_q import QuantizedClassifier, quantize_classifier
from artist_style_transfer_tpu_torch.models.transformer import TransformerNet
from artist_style_transfer_tpu_torch.models.transformer_q import (
    QuantizedTransformerNet,
    quantize_transformer,
)
from artist_style_transfer_tpu_torch.ops.image import bgr_to_rgb, center_crop, torchvision_normalize
from artist_style_transfer_tpu_torch.parallel.distributed import make_global
from artist_style_transfer_tpu_torch.parallel.mesh import Mesh, data_parallel, shard_batch
from artist_style_transfer_tpu_torch.utils.device import module_device, resolve_device, same_device


def eval_logits(
    model: TransformerNet | QuantizedTransformerNet,
    classifier: ResNet50Classifier | QuantizedClassifier,
    images_bgr_255: torch.Tensor,
    crop_size: int = 256,
    mesh: Mesh | None = None,
) -> torch.Tensor:
    """Stylize -> uint8 clip -> crop -> classify, for one NHWC batch on the models' device
    (JAX ``_eval_core``, or ``_eval_core_int8`` for the quantized pair). ``mesh``: the
    ranks that hold this batch between them, whose max is each int8 classifier scale.

    The reference saves to uint8 before its classifier transform
    (inference.py:116 -> :154), so the output is clipped and floored first. A
    quantized stylizer runs with bf16 accumulators, as JAX's int8 eval does.
    """
    with torch.inference_mode():
        if isinstance(model, QuantizedTransformerNet):
            out = model(images_bgr_255.float(), accum=torch.bfloat16).float()
        else:
            out = model(images_bgr_255.float())
        out = torch.floor(out.clamp(0.0, 255.0))
        rgb01 = bgr_to_rgb(center_crop(out, crop_size)) / 255.0
        x = torchvision_normalize(rgb01)
        if isinstance(classifier, QuantizedClassifier):
            return classifier(x, mesh=mesh)
        return classifier(x)


def quantize_eval_pipeline(
    model: TransformerNet, classifier: ResNet50Classifier, calib_images
) -> tuple[QuantizedTransformerNet, QuantizedClassifier]:
    """(quantized stylizer, quantized classifier) for the int8 eval path.

    ``calib_images``: a few NHWC BGR [0,255] content images; the stylizer's static
    activation scales come from one forward over them. The classifier uses
    dynamic scales and needs no calibration.
    """
    return (quantize_transformer(model, np.asarray(calib_images, np.float32)),
            quantize_classifier(classifier))


def evaluate_with_classifier(
    model: TransformerNet,
    classifier: ResNet50Classifier,
    content_images,
    artist_index: int,
    batch_size: int = 4,
    wordy: bool = True,
    artists: tuple[str, ...] | None = None,
    quantize: bool = False,
    fold_batch: bool = False,
    crop_size: int = 256,
    mesh: Mesh | None = None,
    device: str | torch.device | None = None,
) -> float:
    """Top-1 accuracy, in % rounded to 2 decimals, of ``classifier`` naming the artist.

    ``content_images``: an (N, H, W, 3) BGR [0,255] array, or a list of HWC
    images of possibly different sizes (uint8 or float); images batch by
    exact (H, W), and the last chunk of a size is padded by repeating its
    last image. ``model`` and ``classifier`` must live on ``device``
    (``None`` means CUDA). Prints ``Pred=...`` lines (with ``artists``) and
    ``Acc=...`` as the reference does (inference.py:155-166).

    ``quantize=True`` runs the int8 pipeline: both nets quantized
    (:func:`quantize_eval_pipeline`), the stylizer calibrated on the first (at most
    2) images that share the first one's shape. Its predictions may differ from
    the real pipeline's by quantization rounding.

    ``fold_batch`` is accepted and changes nothing: the JAX package's batch->H
    fold is a TPU layout rewrite of the same math (under a mesh each rank's slice
    runs the direct path, as JAX folds each device's shard). ``crop_size`` is 256 in
    the reference; smaller values serve tests at small shapes. ``mesh``: the module
    docstring; only rank 0 prints.
    """
    del fold_batch
    data_parallel(mesh)
    dev = resolve_device(device)
    for name, net in (("model", model), ("classifier", classifier)):
        net_dev = module_device(net)
        if not same_device(net_dev, dev):
            raise ValueError(f"{name} is on {net_dev}, not on {dev}")
    if mesh is not None and not same_device(mesh.device, dev):
        raise ValueError(f"the mesh's device is {mesh.device}, not {dev}")
    wordy = wordy and (mesh is None or mesh.rank == 0)
    if quantize:
        calib = [np.asarray(content_images[i]) for i in range(min(2, len(content_images)))]
        # Calibrate on same-shape images (mixed-size lists cannot stack).
        calib = [c for c in calib if c.shape == calib[0].shape]
        model, classifier = quantize_eval_pipeline(model, classifier, np.stack(calib))
        make_global(mesh, (model, classifier))  # one set of int8 scales on every rank
    sharded = mesh is not None and batch_size % mesh.size == 0

    n = len(content_images)
    preds = np.zeros((n,), np.int64)
    by_shape: dict[tuple, list[int]] = {}
    for i in range(n):
        by_shape.setdefault(tuple(content_images[i].shape[:2]), []).append(i)
    for idxs in by_shape.values():
        for j in range(0, len(idxs), batch_size):
            take = idxs[j : j + batch_size]
            chunk = np.stack([np.asarray(content_images[i]) for i in take])
            pad = batch_size - len(take)
            if pad:
                chunk = np.concatenate([chunk, np.repeat(chunk[-1:], pad, 0)])
            x = torch.as_tensor(chunk).to(dev)
            if sharded:
                local = eval_logits(model, classifier, shard_batch(x, mesh), crop_size, mesh)
                p = torch.cat(mesh.all_gather(local.argmax(-1)))
            else:
                p = eval_logits(model, classifier, x, crop_size).argmax(-1)
            preds[take] = p.cpu().numpy()[: len(take)]
    correct = int((preds == artist_index).sum())
    if wordy and artists is not None:
        for i, p in enumerate(preds):
            print(f"Pred={artists[p]}\tActual={artists[artist_index]}\timage_num={i + 1}")
    acc = round(100.0 * correct / max(1, n), 2)
    if wordy:
        print(f"Acc={acc}")  # inference.py:166
    return acc
