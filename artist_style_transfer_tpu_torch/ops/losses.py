"""Content, Gram style and classifier losses (counterpart of the JAX ``ops/losses.py``).

Unfolded: the batch->H fold of the JAX module is a TPU layout rewrite of the same
math. MSE has ``nn.MSELoss`` semantics: the mean over all elements, in f32.
"""

from __future__ import annotations

import torch

from artist_style_transfer_tpu_torch.models.vgg import VGG_LAYER_NAMES
from artist_style_transfer_tpu_torch.ops.gram import (
    gram_matrix,
    gram_matrix_int8,
    gram_matrix_int8_rows,
    gram_matrix_rows,
)
from artist_style_transfer_tpu_torch.parallel.spatial import row_sum


def mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a - b).float().square().mean()


def content_loss(gen_relu2_2: torch.Tensor, content_relu2_2: torch.Tensor) -> torch.Tensor:
    """Perceptual content loss: MSE over relu2_2 feature maps (train_cnn.py:307-308)."""
    return mse(gen_relu2_2, content_relu2_2)


def style_loss_gram(
    gen_features: dict[str, torch.Tensor],
    target_grams: dict[str, torch.Tensor],
    use_kernel: str | bool = "auto",
    quantize: bool = False,
    mesh=None,
) -> torch.Tensor:
    """Sum over the four VGG taps of MSE(gram(gen), target) (train_cnn.py:321-325).

    ``target_grams[name]`` is (C, C) or (N, C, C). ``"auto"`` resolves to the
    Hopper Gram kernel on a CUDA tensor. This differs from JAX on purpose:
    there ``"auto"`` forced XLA inside the loss, because the pallas_call's
    layout constraint cost TPU layout copies of the taps; Hopper has no such
    constraint, so the kernel is the Gatys loop's hot op, four launches per
    step.

    ``quantize`` (the quantized-loss training path) sends the taps with C >= 256,
    relu3_3 and relu4_3, through the int8 Gram (:func:`ops.gram.gram_matrix_int8`),
    as JAX gates it; the shallow taps keep the Gram kernel. ``mesh`` makes the int8
    Gram's scales the whole batch's where its ranks hold one batch between them.
    """
    loss = None
    for name in VGG_LAYER_NAMES:
        feats = gen_features[name]
        if quantize and feats.shape[-1] >= 256:
            g = gram_matrix_int8(feats, mesh)
        else:
            g = gram_matrix(feats, use_kernel=use_kernel)
        term = mse(g, target_grams[name])
        loss = term if loss is None else loss + term
    return loss


def content_loss_rows(gen_band: torch.Tensor, content_band: torch.Tensor, bands) -> torch.Tensor:
    """:func:`content_loss` from this rank's bands of rows (``bands``, the
    :class:`parallel.spatial.RowBands` of both, NHWC): the band's sum of squares,
    summed over the ranks, over the whole tensor's element count; the same on every
    rank."""
    n, _, w, c = gen_band.shape
    return row_sum((gen_band - content_band).float().square(), bands) / float(
        n * bands.height * w * c)


def style_loss_gram_rows(
    gen_features: dict[str, tuple[torch.Tensor, object]],
    target_grams: dict[str, torch.Tensor],
    use_kernel: str | bool = "auto",
    quantize: bool = False,
    mesh=None,
) -> torch.Tensor:
    """:func:`style_loss_gram` from this rank's bands of the four taps ({tap: (NHWC
    band, its :class:`parallel.spatial.RowBands`)}, as
    ``VGG16Features.forward_rows`` gives them): each tap's Gram by
    :func:`ops.gram.gram_matrix_rows` (kernel K1), or with ``quantize`` the taps with
    C >= 256 by :func:`ops.gram.gram_matrix_int8_rows`, whose scales are the max over
    ``mesh``; the same on every rank."""
    loss = None
    for name in VGG_LAYER_NAMES:
        band, bands = gen_features[name]
        if quantize and band.shape[-1] >= 256:
            g = gram_matrix_int8_rows(band, bands, mesh)
        else:
            g = gram_matrix_rows(band, bands, use_kernel=use_kernel)
        term = mse(g, target_grams[name])
        loss = term if loss is None else loss + term
    return loss


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy with ``nn.CrossEntropyLoss`` semantics, in f32.

    ``logits`` (N, classes) in any float dtype, ``labels`` (N,) int64.
    """
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels[:, None]).mean()


def psnr(a: torch.Tensor, b: torch.Tensor, peak: float = 255.0) -> torch.Tensor:
    """Peak signal-to-noise ratio in dB, the parity metric (JAX ``psnr``): ``10 log10(peak^2 /
    mse(a, b))`` with the MSE in f32; identical inputs give ``inf``."""
    return 10.0 * torch.log10(peak * peak / mse(a, b))
