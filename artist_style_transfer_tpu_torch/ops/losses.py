"""Content, Gram style and classifier losses (counterpart of the JAX ``ops/losses.py``).

Unfolded and unquantized: the batch->H fold and the int8 Gram of the JAX
module are TPU layout and int8 work that belong to later slices. MSE has
``nn.MSELoss`` semantics: the mean over all elements, in f32.
"""

from __future__ import annotations

import torch

from artist_style_transfer_tpu_torch.models.vgg import VGG_LAYER_NAMES
from artist_style_transfer_tpu_torch.ops.gram import gram_matrix


def mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a - b).float().square().mean()


def content_loss(gen_relu2_2: torch.Tensor, content_relu2_2: torch.Tensor) -> torch.Tensor:
    """Perceptual content loss: MSE over relu2_2 feature maps (train_cnn.py:307-308)."""
    return mse(gen_relu2_2, content_relu2_2)


def style_loss_gram(
    gen_features: dict[str, torch.Tensor],
    target_grams: dict[str, torch.Tensor],
    use_kernel: str | bool = "auto",
) -> torch.Tensor:
    """Sum over the four VGG taps of MSE(gram(gen), target) (train_cnn.py:321-325).

    ``target_grams[name]`` is (C, C) or (N, C, C). ``"auto"`` resolves to the
    Hopper Gram kernel on a CUDA tensor. This differs from JAX on purpose:
    there ``"auto"`` forced XLA inside the loss, because the pallas_call's
    layout constraint cost TPU layout copies of the taps; Hopper has no such
    constraint, so the kernel is the Gatys loop's hot op, four launches per
    step.
    """
    loss = None
    for name in VGG_LAYER_NAMES:
        term = mse(gram_matrix(gen_features[name], use_kernel=use_kernel), target_grams[name])
        loss = term if loss is None else loss + term
    return loss


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy with ``nn.CrossEntropyLoss`` semantics, in f32.

    ``logits`` (N, classes) in any float dtype, ``labels`` (N,) int64.
    """
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels[:, None]).mean()
