"""Quantization-aware training forward of the TransformerNet (counterpart of the JAX
``models/transformer_qat.py``).

The interior convs of the trained net run through
:func:`ops.qconv.conv2d_qat_int8`: int8 forward and int8 data gradient on kernel
K2 on CUDA, real-dtype weight and bias gradients (the weight's on cuDNN), so the
optimizer sees no gradient quantization. It optimizes the loss of the quantized
forward, the numerics the int8 serving path (``infer.stylize_int8``) runs.

- ``layers="trunk"``: the 13 convs whose output has 128 channels (encoder convs 3
  and 4, the 10 residual convs, the 1x1 decoder conv 1), as the JAX gate
  ``cout < 128`` leaves them;
- ``layers="all"``: all 16 interior convs.

The 9x9 stem and output conv (C = 3) and, under ``"trunk"``, encoder conv 2 and
decoder convs 2 and 3 keep the real-dtype layers of :class:`TransformerNet`. A
quantized conv layer reflect-pads in the real dtype before the quantizer
(``F.pad``, whose backward folds the border's adjoint back), then runs a
zero-padded int8 conv and the instance norm (+ReLU); a transpose conv runs as
the lhs-dilated conv of its flipped, swapped weight with pads
``(k-1-k//2, k-1-k//2+output_padding)``, quantized per output channel of that
conv form.

:func:`transformer_apply_qat_rows` runs the same forward on one band of an image's
rows while the other ranks of a mesh run the others (:mod:`parallel.spatial`), for
training over a 'space' axis: the real layers as ``TransformerNet.forward_rows``, a
quantized conv on its gathered, H-reflected rows with W reflect-padded before the
quantizer, a quantized transpose conv on its band plus halo with the single-device
pads, cropped; each input scale the max over the batch's ranks of their own rows.
Each rank's weight gradient is its rows' part, which the trainer's gradient sum
completes.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from artist_style_transfer_tpu_torch.models.transformer import (
    DECODER_SPEC,
    ENCODER_SPEC,
    ConvLayer,
    DeconvLayer,
    TransformerNet,
)
from artist_style_transfer_tpu_torch.ops.qconv import absmax_scale, conv2d_qat_int8
from artist_style_transfer_tpu_torch.parallel.spatial import (
    RowBands,
    conv_rows,
    conv_transpose_rows,
)

QAT_LAYERS = ("trunk", "all")


def _qconv_in(layer: ConvLayer, x: torch.Tensor, k: int, stride: int, relu: bool,
              mesh) -> torch.Tensor:
    """Reflect-pad -> int8 QAT conv -> IN (+ReLU) (reference ConvLayer)."""
    xp = F.pad(x, (k // 2,) * 4, mode="reflect") if k > 1 else x
    conv = layer.conv_layer
    y = conv2d_qat_int8(xp, conv.weight, conv.bias, stride, 0, 1, mesh)
    return layer.norm_layer(y, relu)


def _qdeconv_in(layer: DeconvLayer, x: torch.Tensor, k: int, stride: int,
                output_padding: int, mesh) -> torch.Tensor:
    """ConvTranspose2d as an lhs-dilated int8 QAT conv -> IN + ReLU."""
    lo = k - 1 - k // 2
    ct = layer.conv_transpose
    w = ct.weight.flip(2, 3).transpose(0, 1)  # (I, O, k, k) -> the conv form, OIHW
    y = conv2d_qat_int8(x, w, ct.bias, 1, (lo, lo + output_padding), stride, mesh)
    return layer.norm_layer(y, True)


def _qconv_in_rows(layer: ConvLayer, x: torch.Tensor, rows: RowBands, k: int, stride: int,
                   relu: bool, mesh) -> tuple[torch.Tensor, RowBands]:
    """:func:`_qconv_in` on this rank's band of rows."""
    conv, p = layer.conv_layer, k // 2
    s_x = absmax_scale(x, mesh)  # the reflect pad repeats interior values: the same max

    def run(t):  # H arrives reflected; W is padded before the quantizer
        if p:
            t = F.pad(t, (p, p, 0, 0), mode="reflect").contiguous(
                memory_format=torch.channels_last)
        return conv2d_qat_int8(t, conv.weight, conv.bias, stride, 0, 1, mesh, s_x)

    y, rows = conv_rows(x, rows, k, stride, p, run, conv.weight.shape[0], collective=True)
    return layer.norm_layer.forward_rows(y, rows, relu), rows


def _qdeconv_in_rows(layer: DeconvLayer, x: torch.Tensor, rows: RowBands, k: int, stride: int,
                     output_padding: int, mesh) -> tuple[torch.Tensor, RowBands]:
    """:func:`_qdeconv_in` on this rank's band of rows: the lhs-dilated int8 conv on the
    band plus the input rows its output rows reach, with the single-device pads."""
    lo = k - 1 - k // 2
    ct = layer.conv_transpose
    w = ct.weight.flip(2, 3).transpose(0, 1)
    s_x = absmax_scale(x, mesh)

    def run(t):
        return conv2d_qat_int8(t, w, ct.bias, 1, (lo, lo + output_padding), stride, mesh, s_x)

    y, rows = conv_transpose_rows(x, rows, k, stride, lo, lo + output_padding, run,
                                  w.shape[0], collective=True)
    return layer.norm_layer.forward_rows(y, rows, True), rows


def transformer_apply_qat_rows(model: nn.Module, x_nhwc: torch.Tensor, rows: RowBands,
                               layers: str = "trunk", mesh=None
                               ) -> tuple[torch.Tensor, RowBands]:
    """:func:`transformer_apply_qat` on this rank's band of rows (``rows`` says whose band
    is which): this rank's band of the output and the output's bands. Every rank of
    ``rows.mesh`` runs it at once; ``mesh`` (the ranks that hold the batch between them;
    None: ``rows.mesh``) takes the int8 convs' dynamic scales."""
    if layers not in QAT_LAYERS:
        raise ValueError(f"layers must be one of {QAT_LAYERS}, got {layers!r}")
    mesh = rows.mesh if mesh is None else mesh
    trunk_only = layers == "trunk"
    x = x_nhwc.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    enc, dec = model.ConvBlock, model.DeconvBlock
    x, rows = enc[0].forward_rows(x, rows, relu=True)
    for i, (k, s, _, cout) in enumerate(ENCODER_SPEC[1:], start=1):
        if trunk_only and cout < 128:
            x, rows = enc[2 * i].forward_rows(x, rows, relu=True)
        else:
            x, rows = _qconv_in_rows(enc[2 * i], x, rows, k, s, True, mesh)
    for block in model.ResidualBlock:
        h, rows_h = _qconv_in_rows(block.conv1, x, rows, 3, 1, True, mesh)
        y, rows = _qconv_in_rows(block.conv2, h, rows_h, 3, 1, False, mesh)
        x = y + x
    for i, (k, s, op, _, cout) in enumerate(DECODER_SPEC):
        if trunk_only and cout < 128:
            x, rows = dec[2 * i].forward_rows(x, rows, relu=True)
        else:
            x, rows = _qdeconv_in_rows(dec[2 * i], x, rows, k, s, op, mesh)
    x, rows = dec[-1].forward_rows(x, rows)
    return x.permute(0, 2, 3, 1), rows


def transformer_apply_qat(model: nn.Module, x_nhwc: torch.Tensor,
                          layers: str = "trunk", mesh=None) -> torch.Tensor:
    """QAT forward of ``model`` (a :class:`TransformerNet` or its :class:`QATForward`):
    NHWC BGR [0,255] -> NHWC BGR, unbounded, as ``TransformerNet.forward``. With
    ``mesh`` the int8 convs' dynamic scales are the whole batch's over its ranks."""
    if layers not in QAT_LAYERS:
        raise ValueError(f"layers must be one of {QAT_LAYERS}, got {layers!r}")
    trunk_only = layers == "trunk"
    x = x_nhwc.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    enc, dec = model.ConvBlock, model.DeconvBlock
    x = enc[0](x, relu=True)
    for i, (k, s, _, cout) in enumerate(ENCODER_SPEC[1:], start=1):
        if trunk_only and cout < 128:
            x = enc[2 * i](x, relu=True)
        else:
            x = _qconv_in(enc[2 * i], x, k, s, relu=True, mesh=mesh)
    for block in model.ResidualBlock:
        h = _qconv_in(block.conv1, x, 3, 1, relu=True, mesh=mesh)
        x = _qconv_in(block.conv2, h, 3, 1, relu=False, mesh=mesh) + x
    for i, (k, s, op, _, cout) in enumerate(DECODER_SPEC):
        if trunk_only and cout < 128:
            x = dec[2 * i](x, relu=True)
        else:
            x = _qdeconv_in(dec[2 * i], x, k, s, op, mesh)
    return dec[-1](x).permute(0, 2, 3, 1)


class QATForward(nn.Module):
    """``model``'s QAT forward as a module with the model's own children, so that its
    parameters keep their names and ``torch.func.functional_call`` drives it with the
    model's parameter dict."""

    def __init__(self, model: TransformerNet, layers: str = "trunk"):
        super().__init__()
        if layers not in QAT_LAYERS:
            raise ValueError(f"layers must be one of {QAT_LAYERS}, got {layers!r}")
        for name, child in model.named_children():
            self.add_module(name, child)
        self.layers = layers

    def forward(self, x_nhwc: torch.Tensor, mesh=None) -> torch.Tensor:
        return transformer_apply_qat(self, x_nhwc, self.layers, mesh)


class QATRowsForward(QATForward):
    """:func:`transformer_apply_qat_rows` as a module's forward, with the model's own
    children (:class:`QATForward`), for ``torch.func.functional_call``."""

    def forward(self, x_nhwc: torch.Tensor, rows: RowBands,
                mesh=None) -> tuple[torch.Tensor, RowBands]:
        return transformer_apply_qat_rows(self, x_nhwc, rows, self.layers, mesh)
