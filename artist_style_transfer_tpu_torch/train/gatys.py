"""Gatys-style iterative stylization: optimize the pixels directly (counterpart of the
JAX ``train/gatys.py``; BASELINE config 1).

VGG16 Gram + content losses on a content/style pair, Adam on a leaf pixel
tensor. The JAX ``lax.scan`` becomes a Python loop; the loss trace stays on
the device (no per-step host sync). On a CUDA device every Gram goes
through the Hopper kernel: four for the style targets, four per step.
"""

from __future__ import annotations

import torch

from artist_style_transfer_tpu_torch.models.vgg import VGG16Features
from artist_style_transfer_tpu_torch.ops.gram import gram_matrix
from artist_style_transfer_tpu_torch.ops.image import vgg_caffe_preprocess
from artist_style_transfer_tpu_torch.ops.losses import content_loss, style_loss_gram
from artist_style_transfer_tpu_torch.utils.device import resolve_device


def gatys_stylize(
    vgg: VGG16Features,
    content_bgr_255,  # (H, W, 3)
    style_bgr_255,  # (Hs, Ws, 3)
    *,
    num_steps: int = 300,
    lr: float = 4.0,
    content_weight: float = 17.0,
    style_weight: float = 25.0,
    use_kernel: str | bool = "auto",
    device: str | torch.device | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (stylized HWC BGR [0,255] f32, per-step total-loss trace), both on ``device``.

    ``vgg`` must already live on ``device``. The Adam update
    (betas 0.9/0.999, eps 1e-8) is ``optax.adam``'s, up to rounding.
    """
    dev = resolve_device(device)
    content = torch.as_tensor(content_bgr_255).to(dev, torch.float32)[None]
    style = torch.as_tensor(style_bgr_255).to(dev, torch.float32)[None]

    with torch.no_grad():
        target_r22 = vgg(vgg_caffe_preprocess(content), just_content=True)
        target_grams = {
            k: gram_matrix(v, use_kernel=use_kernel)[0]
            for k, v in vgg(vgg_caffe_preprocess(style)).items()
        }

    pixels = content.clone().requires_grad_(True)
    opt = torch.optim.Adam([pixels], lr=lr, betas=(0.9, 0.999), eps=1e-8)
    losses = torch.empty(num_steps, dtype=torch.float32, device=dev)
    for step in range(num_steps):
        opt.zero_grad(set_to_none=True)
        feats = vgg(vgg_caffe_preprocess(pixels))
        loss = content_weight * content_loss(feats["relu2_2"], target_r22)
        loss = loss + style_weight * style_loss_gram(feats, target_grams, use_kernel=use_kernel)
        loss.backward()
        opt.step()
        losses[step] = loss.detach()
    return pixels.detach()[0].clamp(0.0, 255.0), losses
