"""TransformerNet — the Johnson-style feed-forward stylization network (counterpart of
the JAX ``models/transformer.py``).

Topology of reference ``StyleTransfer`` (cnn.py:10-49), 1,712,771 parameters:

  encoder:  conv9x9/1 3->32, conv3x3/2 32->64, conv3x3/2 64->128,
            conv1x1/1 128->128   (each: reflect-pad, conv, instance norm, ReLU)
  residual: 5 x [conv3x3/1 -> IN -> ReLU -> conv3x3/1 -> IN] + skip
  decoder:  convT1x1/1 128->128, convT3x3/2 128->64, convT3x3/2 64->32
            (each + IN + ReLU), then conv9x9/1 32->3 reflect-padded, no norm

Submodule names reproduce the reference state-dict keys
(``ConvBlock.{0,2,4,6}.conv_layer/norm_layer``, ``ResidualBlock.{i}.conv1/conv2``,
``DeconvBlock.{0,2,4}.conv_transpose/norm_layer``, ``DeconvBlock.6.conv_layer``),
so a reference ``.pth`` loads with ``load_state_dict``. The ``nn.ReLU``
modules keep the reference's indices; the forward folds each ReLU into the
norm before it through ``instance_norm_act`` in every precision mode. The JAX
``_in_maybe_act`` composes IN and ReLU in parity mode to keep its exact ops;
here both forms are one autograd function, whose recomputed mask equals
relu's own in f32, so the fold costs nothing in parity. The network runs in
``channels_last`` and is differentiable.

``forward_rows`` runs the same net (inference only) on one band of an image's rows
while the other ranks of a mesh run the others (:mod:`parallel.spatial`: halo rows
fetched before each conv, instance-norm statistics over the whole image);
``forward`` is untouched by it.
"""

from __future__ import annotations

import torch
import torch.nn as nn

import torch.nn.functional as F

from artist_style_transfer_tpu_torch.ops.conv import conv2d_reflect, conv_transpose2d
from artist_style_transfer_tpu_torch.ops.norm import INSTANCE_NORM_EPS, instance_norm_act
from artist_style_transfer_tpu_torch.parallel.spatial import (
    RowBands,
    conv_rows,
    conv_transpose_rows,
    instance_norm_rows,
)

# (kernel, stride, in_ch, out_ch) of the four encoder convs (cnn.py:15-24).
ENCODER_SPEC = ((9, 1, 3, 32), (3, 2, 32, 64), (3, 2, 64, 128), (1, 1, 128, 128))
NUM_RESIDUAL = 5
RES_CHANNELS = 128
# (kernel, stride, output_padding, in_ch, out_ch) of the three transpose convs (cnn.py:32-38).
DECODER_SPEC = ((1, 1, 0, 128, 128), (3, 2, 1, 128, 64), (3, 2, 1, 64, 32))
OUTPUT_CONV = (9, 1, 32, 3)  # final conv, no norm (cnn.py:39)

TRANSFORMER_PARAM_COUNT = 1_712_771


class InstanceNorm(nn.Module):
    """Affine instance norm with ``nn.InstanceNorm2d(C, affine=True)``'s keys."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x: torch.Tensor, relu: bool = False) -> torch.Tensor:
        return instance_norm_act(x, self.weight, self.bias, relu)

    def forward_rows(self, x: torch.Tensor, rows: RowBands, relu: bool = False) -> torch.Tensor:
        return instance_norm_rows(x, rows, self.weight, self.bias, relu, INSTANCE_NORM_EPS)


class ConvLayer(nn.Module):
    """Reflect-pad conv, then instance norm unless ``norm=False`` (cnn.py:52-79)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int, norm: bool = True):
        super().__init__()
        self.conv_layer = nn.Conv2d(cin, cout, k, stride)
        self.norm_layer = InstanceNorm(cout) if norm else None

    def forward(self, x: torch.Tensor, relu: bool = False) -> torch.Tensor:
        x = conv2d_reflect(x, self.conv_layer.weight, self.conv_layer.bias,
                           stride=self.conv_layer.stride[0])
        return x if self.norm_layer is None else self.norm_layer(x, relu)

    def forward_rows(self, x: torch.Tensor, rows: RowBands,
                     relu: bool = False) -> tuple[torch.Tensor, RowBands]:
        w, b, s = self.conv_layer.weight, self.conv_layer.bias, self.conv_layer.stride[0]
        k = w.shape[-1]
        p = k // 2

        def conv(t):  # H arrives reflected; W is padded here
            return F.conv2d(F.pad(t, (p, p, 0, 0), mode="reflect") if p else t, w, b, stride=s)

        x, rows = conv_rows(x, rows, k, s, p, conv, w.shape[0])
        return (x if self.norm_layer is None else self.norm_layer.forward_rows(x, rows, relu)), rows


class ResidualLayer(nn.Module):
    def __init__(self, c: int = RES_CHANNELS):
        super().__init__()
        self.conv1 = ConvLayer(c, c, 3, 1)
        self.conv2 = ConvLayer(c, c, 3, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(self.conv1(x, relu=True)) + x

    def forward_rows(self, x: torch.Tensor, rows: RowBands) -> tuple[torch.Tensor, RowBands]:
        h, rows_h = self.conv1.forward_rows(x, rows, relu=True)
        y, rows_y = self.conv2.forward_rows(h, rows_h)
        return y + x, rows_y


class DeconvLayer(nn.Module):
    """Transpose conv (zero padding k//2), then instance norm (cnn.py:102-124)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int, output_padding: int):
        super().__init__()
        self.conv_transpose = nn.ConvTranspose2d(cin, cout, k, stride, k // 2, output_padding)
        self.norm_layer = InstanceNorm(cout)

    def forward(self, x: torch.Tensor, relu: bool = False) -> torch.Tensor:
        ct = self.conv_transpose
        x = conv_transpose2d(x, ct.weight, ct.bias, stride=ct.stride[0],
                             padding=ct.padding[0], output_padding=ct.output_padding[0])
        return self.norm_layer(x, relu)

    def forward_rows(self, x: torch.Tensor, rows: RowBands,
                     relu: bool = False) -> tuple[torch.Tensor, RowBands]:
        ct = self.conv_transpose
        k, s, p, op = ct.kernel_size[0], ct.stride[0], ct.padding[0], ct.output_padding[0]

        def conv(t):
            return conv_transpose2d(t, ct.weight, ct.bias, stride=s, padding=p, output_padding=op)

        # a transpose conv is a conv over the input dilated by s, padded (k-1-p, k-1-p+op)
        x, rows = conv_transpose_rows(x, rows, k, s, k - 1 - p, k - 1 - p + op, conv,
                                      ct.weight.shape[1])
        return self.norm_layer.forward_rows(x, rows, relu), rows


class TransformerNet(nn.Module):
    def __init__(self):
        super().__init__()
        enc = []
        for k, s, cin, cout in ENCODER_SPEC:
            enc += [ConvLayer(cin, cout, k, s), nn.ReLU()]
        self.ConvBlock = nn.Sequential(*enc)
        self.ResidualBlock = nn.Sequential(*[ResidualLayer() for _ in range(NUM_RESIDUAL)])
        dec = []
        for k, s, op, cin, cout in DECODER_SPEC:
            dec += [DeconvLayer(cin, cout, k, s, op), nn.ReLU()]
        k, s, cin, cout = OUTPUT_CONV
        dec.append(ConvLayer(cin, cout, k, s, norm=False))
        self.DeconvBlock = nn.Sequential(*dec)
        self.to(memory_format=torch.channels_last)

    def forward(self, x_nhwc: torch.Tensor, fold_batch: bool = False) -> torch.Tensor:
        """NHWC BGR [0,255] -> NHWC BGR, unbounded (reference cnn.py:45-49).

        ``fold_batch`` is accepted for API parity with JAX and changes
        nothing: there the batch->H fold is a TPU layout rewrite of the same
        math, and its result is the same.
        """
        del fold_batch
        x = x_nhwc.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        for i in range(0, len(ENCODER_SPEC) * 2, 2):
            x = self.ConvBlock[i](x, relu=True)
        for block in self.ResidualBlock:
            x = block(x)
        for i in range(0, len(DECODER_SPEC) * 2, 2):
            x = self.DeconvBlock[i](x, relu=True)
        return self.DeconvBlock[-1](x).permute(0, 2, 3, 1)

    def forward_rows(self, x_nhwc: torch.Tensor,
                     rows: RowBands) -> tuple[torch.Tensor, RowBands]:
        """:meth:`forward` on this rank's band of rows (``rows`` says whose band is
        which) of NHWC BGR [0,255] images: this rank's band of the output, and the
        output's bands. Every rank of ``rows.mesh`` runs it at once."""
        x = x_nhwc.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        for i in range(0, len(ENCODER_SPEC) * 2, 2):
            x, rows = self.ConvBlock[i].forward_rows(x, rows, relu=True)
        for block in self.ResidualBlock:
            x, rows = block.forward_rows(x, rows)
        for i in range(0, len(DECODER_SPEC) * 2, 2):
            x, rows = self.DeconvBlock[i].forward_rows(x, rows, relu=True)
        x, rows = self.DeconvBlock[-1].forward_rows(x, rows)
        return x.permute(0, 2, 3, 1), rows


def init_transformer(
    generator: torch.Generator, device: str | torch.device = "cpu"
) -> TransformerNet:
    """A TransformerNet with torch's default init, drawn from ``generator``.

    As the JAX ``init_transformer_params``: U(-1/sqrt(fan_in), 1/sqrt(fan_in))
    for every conv weight and bias, fan_in = cin*k*k for a conv and cout*k*k
    for a transpose conv (torch reads fan_in from weight dim 1); instance
    norms start at gamma 1, beta 0. Draws run in module order, weight then
    bias, on the CPU, so a seed gives the same net on every device.
    """
    model = TransformerNet()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                w = m.weight
                bound = 1.0 / (w.shape[1] * w.shape[2] * w.shape[3]) ** 0.5
                for p in (m.weight, m.bias):
                    p.copy_(torch.rand(p.shape, generator=generator) * (2 * bound) - bound)
    return model.to(device)
