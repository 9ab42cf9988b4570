"""Int8-quantized TransformerNet inference (counterpart of the JAX ``models/transformer_q.py``).

Same topology as :mod:`artist_style_transfer_tpu_torch.models.transformer`. The 16
interior convolutions (encoder convs 2-4, the 10 residual convs, the 3
transpose convs) run on the int8 tensor cores through
:func:`ops.qconv.conv_i8` (kernel K2 on CUDA). The two C=3 endpoint convs, the
9x9 stem and the 9x9 output conv, stay bf16 cuDNN convs over a reflect pad:
the JAX ``cinfactored``/``dxfactored`` forms are TPU layout rewrites of the
same math.

Why the quantization is benign here: every quantized conv feeds an
InstanceNorm, which is invariant to a positive per-channel scale and to a
per-channel constant. So the int8 accumulators go into IN raw (int32, or bf16
with ``accum=torch.bfloat16``), the per-channel weight scales cancel, and the
conv biases cancel too and are skipped. Activations are re-quantized before
each int8 conv with static per-tensor scales from :func:`calibrate_transformer`;
the stream between blocks is real-unit bf16, so the residual adds are
unaffected.

Weights: OIHW, the transpose convs' stored flipped and transposed to the
conv form (``w.flip(2, 3).transpose(0, 1)``), which JAX stores as flipped
HWIO; the per-out-channel absmax runs over the same values, so the codes are
JAX's. JAX's ``_quant_act`` and ``_quant_w`` are the quantizers of
:mod:`ops.qconv` (``quant_i8``, ``quant_weight``), which compute the same.

``forward_rows`` runs the quantized net on one band of an image's rows while the
other ranks of a mesh run the others (:mod:`parallel.spatial`): the real-unit
halo rows are fetched before each conv and quantized with the same static scale,
so every rank's int8 codes are the single-device codes of its rows; a reflect
conv runs on K2 with its W padding done before the quantize and no H padding, a
transpose conv on its band plus halo with the single-device pads, cropped; the
instance-norm statistics are the whole image's. ``forward`` is untouched by it.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from artist_style_transfer_tpu_torch.models.transformer import (
    DECODER_SPEC,
    ENCODER_SPEC,
    NUM_RESIDUAL,
    TransformerNet,
)
from artist_style_transfer_tpu_torch.ops.norm import INSTANCE_NORM_EPS
from artist_style_transfer_tpu_torch.ops.pad import reflect_pad_hw
from artist_style_transfer_tpu_torch.ops.qconv import conv_i8, quant_i8, quant_weight
from artist_style_transfer_tpu_torch.parallel.spatial import (
    RowBands,
    conv_rows,
    conv_transpose_rows,
    row_mean,
)

_REAL_DTYPE = torch.bfloat16  # the real-unit stream between quantized convs
_ACCUMS = (torch.int32, torch.bfloat16)

# (stride, (pad lo, pad hi), lhs dilation, pad mode) of the quantized convs.
ENCODER_GEOMETRY = tuple((s, (k // 2, k // 2), 1, "reflect") for k, s, _, _ in ENCODER_SPEC[1:])
RESIDUAL_GEOMETRY = (1, (1, 1), 1, "reflect")
# A transpose conv is a conv over the input dilated by s with pads (k-1-p, k-1-p+op), p = k//2.
DECODER_GEOMETRY = tuple((1, (k - 1 - k // 2, k - 1 - k // 2 + op), s, "zeros")
                         for k, s, op, _, _ in DECODER_SPEC)


def _channels(v: torch.Tensor) -> torch.Tensor:
    return v.view(1, -1, 1, 1)


def _buffer(t, dtype: torch.dtype) -> torch.Tensor:
    """A copy of ``t`` as ``dtype``, never an alias of a live parameter."""
    t = torch.as_tensor(t).detach().to(dtype, copy=True)
    return t.contiguous(memory_format=torch.channels_last) if t.dim() == 4 else t


def _in_act(y_acc: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
            relu: bool, rows: RowBands | None = None) -> torch.Tensor:
    """InstanceNorm(+ReLU) straight on the conv accumulator (int32 or bf16), with f32
    one-pass statistics; the input's per-channel scale cancels, so the result is
    in real units. Returns bf16 (JAX ``_in_act``). With ``rows``, ``y_acc`` is this
    rank's band and the statistics are the whole image's, in one all-reduce."""
    x32 = y_acc.float()
    if rows is None:
        mean = x32.mean(dim=(2, 3), keepdim=True)
        m2 = x32.square().mean(dim=(2, 3), keepdim=True)
    else:
        c = x32.shape[1]
        both = row_mean(torch.cat([x32, x32.square()], dim=1), rows)
        mean, m2 = both[:, :c], both[:, c:]
    var = (m2 - mean.square()).clamp_min(0.0)
    y = ((x32 - mean) * torch.rsqrt(var + INSTANCE_NORM_EPS)) * _channels(gamma) + _channels(beta)
    if relu:
        y = torch.relu(y)
    return y.to(_REAL_DTYPE)


def _in_relu_bf16(h: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                  rows: RowBands | None = None) -> torch.Tensor:
    """One-pass f32-statistics IN + ReLU on a real-unit activation -> bf16."""
    return _in_act(h, gamma.float(), beta.float(), relu=True, rows=rows)


def _reflect_conv_bf16(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16 reflect-pad conv, then the bias added in bf16, as JAX adds it after the conv."""
    return F.conv2d(reflect_pad_hw(x, w.shape[-1] // 2), w) + _channels(b)


def _reflect_conv_bf16_rows(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                            rows: RowBands) -> tuple[torch.Tensor, RowBands]:
    """:func:`_reflect_conv_bf16` over a band of rows."""
    p = w.shape[-1] // 2

    def conv(t):  # H arrives reflected; W is padded here
        return F.conv2d(F.pad(t, (p, p, 0, 0), mode="reflect"), w) + _channels(b)

    return conv_rows(x, rows, w.shape[-1], 1, p, conv, w.shape[0])


class QuantConv(nn.Module):
    """One int8 conv feeding an instance norm: int8 weights, f32 gamma and beta, and the
    static scale ``sin`` of its input."""

    def __init__(self, wq: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                 sin: torch.Tensor, geometry: tuple):
        super().__init__()
        self.register_buffer("wq", _buffer(wq, torch.int8))
        self.register_buffer("gamma", _buffer(gamma, torch.float32))
        self.register_buffer("beta", _buffer(beta, torch.float32))
        self.register_buffer("sin", _buffer(sin, torch.float32).reshape(()))
        self.stride, self.padding, self.dilation, self.pad_mode = geometry

    def forward(self, x: torch.Tensor, accum: torch.dtype, relu: bool) -> torch.Tensor:
        y = conv_i8(quant_i8(x, self.sin), self.wq, self.stride, self.padding,
                    self.dilation, self.pad_mode, out=accum)
        return _in_act(y, self.gamma, self.beta, relu)

    def conv_rows(self, x: torch.Tensor, rows: RowBands,
                  accum: torch.dtype) -> tuple[torch.Tensor, RowBands]:
        """The int8 conv alone (no instance norm) on this rank's band of rows: this
        rank's band of the accumulator, and the accumulator's bands."""
        k, cout = self.wq.shape[2], self.wq.shape[0]
        lo, hi = self.padding
        if self.pad_mode == "reflect":
            def conv(t):  # H arrives reflected; W is padded before the quantize
                if lo or hi:  # F.pad gives NCHW; K2 reads NHWC
                    t = F.pad(t, (lo, hi, 0, 0), mode="reflect").contiguous(
                        memory_format=torch.channels_last)
                return conv_i8(quant_i8(t, self.sin), self.wq, self.stride, 0, 1, out=accum)

            y, rows = conv_rows(x, rows, k, self.stride, lo, conv, cout, accum)
        else:
            def conv(t):
                return conv_i8(quant_i8(t, self.sin), self.wq, self.stride, (lo, hi),
                               self.dilation, out=accum)

            y, rows = conv_transpose_rows(x, rows, k, self.dilation, lo, hi, conv, cout, accum)
        return y, rows

    def forward_rows(self, x: torch.Tensor, rows: RowBands, accum: torch.dtype,
                     relu: bool) -> tuple[torch.Tensor, RowBands]:
        y, rows = self.conv_rows(x, rows, accum)
        return _in_act(y, self.gamma, self.beta, relu, rows), rows


class QuantizedTransformerNet(nn.Module):
    """The quantized parameters (JAX ``quantize_transformer``'s pytree, in torch layouts)
    and the int8 forward (JAX ``transformer_apply_int8``). Holds buffers only.

    ``stem`` and ``output``: dicts of the bf16 endpoint convs (``w`` OIHW, ``b``, and
    for the stem ``gamma``/``beta``); ``encoder``/``decoder``: lists of dicts
    ``wq`` (int8 OIHW), ``gamma``, ``beta``, ``sin``; ``residual``: a list of
    ``{"conv1": ..., "conv2": ...}``.
    """

    def __init__(self, stem: dict, encoder: list[dict], residual: list[dict],
                 decoder: list[dict], output: dict):
        super().__init__()
        if len(encoder) != len(ENCODER_GEOMETRY) or len(decoder) != len(DECODER_GEOMETRY) \
                or len(residual) != NUM_RESIDUAL:
            raise ValueError("a quantized TransformerNet has 3 encoder, 5 residual and 3 decoder "
                             f"convs; got {len(encoder)}, {len(residual)} and {len(decoder)}")
        for name in ("w", "b", "gamma", "beta"):
            self.register_buffer(f"stem_{name}", _buffer(stem[name], _REAL_DTYPE))
        self.register_buffer("out_w", _buffer(output["w"], _REAL_DTYPE))
        self.register_buffer("out_b", _buffer(output["b"], _REAL_DTYPE))

        def conv(p: dict, geometry: tuple) -> QuantConv:
            return QuantConv(p["wq"], p["gamma"], p["beta"], p["sin"], geometry)

        self.encoder = nn.ModuleList(conv(p, g) for p, g in zip(encoder, ENCODER_GEOMETRY))
        self.residual = nn.ModuleList(
            nn.ModuleDict({k: conv(r[k], RESIDUAL_GEOMETRY) for k in ("conv1", "conv2")})
            for r in residual)
        self.decoder = nn.ModuleList(conv(p, g) for p, g in zip(decoder, DECODER_GEOMETRY))

    def forward(self, x_nhwc: torch.Tensor, accum: torch.dtype = torch.int32) -> torch.Tensor:
        """NHWC BGR [0,255] (uint8 or float) -> NHWC bf16, unbounded (clip at save time).

        ``accum`` is the dtype the int8 convs store their accumulators in before
        IN reads them: the exact int32, or bf16 (JAX ``accum=jnp.bfloat16``).
        """
        if accum not in _ACCUMS:
            raise ValueError(f"accum must be torch.int32 or torch.bfloat16, got {accum}")
        x = x_nhwc.to(_REAL_DTYPE).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        xr = _in_relu_bf16(_reflect_conv_bf16(x, self.stem_w, self.stem_b),
                           self.stem_gamma, self.stem_beta)
        for layer in self.encoder:
            xr = layer(xr, accum, relu=True)
        for block in self.residual:
            h = block["conv1"](xr, accum, relu=True)
            xr = block["conv2"](h, accum, relu=False) + xr
        for layer in self.decoder:
            xr = layer(xr, accum, relu=True)
        return _reflect_conv_bf16(xr, self.out_w, self.out_b).permute(0, 2, 3, 1)

    def forward_rows(self, x_nhwc: torch.Tensor, rows: RowBands,
                     accum: torch.dtype = torch.int32) -> tuple[torch.Tensor, RowBands]:
        """:meth:`forward` on this rank's band of rows (``rows`` says whose band is
        which): this rank's band of the output, and the output's bands. Every rank of
        ``rows.mesh`` runs it at once."""
        if accum not in _ACCUMS:
            raise ValueError(f"accum must be torch.int32 or torch.bfloat16, got {accum}")
        x = x_nhwc.to(_REAL_DTYPE).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        h, rows = _reflect_conv_bf16_rows(x, self.stem_w, self.stem_b, rows)
        xr = _in_relu_bf16(h, self.stem_gamma, self.stem_beta, rows)
        for layer in self.encoder:
            xr, rows = layer.forward_rows(xr, rows, accum, relu=True)
        for block in self.residual:
            h, rows_h = block["conv1"].forward_rows(xr, rows, accum, relu=True)
            y, rows = block["conv2"].forward_rows(h, rows_h, accum, relu=False)
            xr = y + xr
        for layer in self.decoder:
            xr, rows = layer.forward_rows(xr, rows, accum, relu=True)
        y, rows = _reflect_conv_bf16_rows(xr, self.out_w, self.out_b, rows)
        return y.permute(0, 2, 3, 1), rows


def _encoder_layers(model: TransformerNet) -> list[nn.Module]:
    return [model.ConvBlock[i] for i in range(0, 2 * len(ENCODER_SPEC), 2)]


def _decoder_layers(model: TransformerNet) -> list[nn.Module]:
    return [model.DeconvBlock[i] for i in range(0, 2 * len(DECODER_SPEC), 2)]


def _forward_collect(model: TransformerNet, x_nhwc: torch.Tensor) -> dict:
    """The f32 forward of the real net, returning the absmax (over the batch) of every
    quantized conv's input in the layout of the scales dict (JAX ``_forward_collect``)."""

    def absmax(t: torch.Tensor) -> torch.Tensor:
        return t.float().abs().amax()

    scales: dict = {"encoder": [None], "residual": [], "decoder": []}
    x = x_nhwc.float().permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    for i, layer in enumerate(_encoder_layers(model)):
        if i > 0:
            scales["encoder"].append(absmax(x))
        x = layer(x, relu=True)
    for block in model.ResidualBlock:
        s1 = absmax(x)
        h = block.conv1(x, relu=True)
        s2 = absmax(h)
        x = block.conv2(h) + x
        scales["residual"].append({"conv1": s1, "conv2": s2})
    for layer in _decoder_layers(model):
        scales["decoder"].append(absmax(x))
        x = layer(x, relu=True)
    return scales


def calibrate_transformer(model: TransformerNet, images, margin: float = 1.0) -> dict:
    """Per-tensor activation scales from sample content images (NHWC BGR [0,255]):
    ``absmax * margin / 127`` of each quantized conv's input over one f32 forward.
    Static scales are safe because every IN re-centers the ranges."""
    dev = next(model.parameters()).device
    with torch.no_grad():
        amax = _forward_collect(model, torch.as_tensor(images, dtype=torch.float32).to(dev))

    def scale(a):
        return None if a is None else (a * margin / 127.0).float()

    return {
        "encoder": [scale(a) for a in amax["encoder"]],
        "residual": [{k: scale(v) for k, v in r.items()} for r in amax["residual"]],
        "decoder": [scale(a) for a in amax["decoder"]],
    }


def quantize_transformer(model: TransformerNet, images_or_scales) -> QuantizedTransformerNet:
    """Quantize a TransformerNet for int8 inference, on the model's device.

    ``images_or_scales``: calibration images (NHWC BGR [0,255]) or a scales dict from
    :func:`calibrate_transformer`. The stem and the output conv keep their weights,
    cast to bf16.
    """
    scales = (images_or_scales if isinstance(images_or_scales, dict)
              else calibrate_transformer(model, images_or_scales))
    with torch.no_grad():
        def in_conv(layer: nn.Module, w_oihw: torch.Tensor, sin) -> dict:
            wq, _ = quant_weight(w_oihw)  # the per-channel scale cancels in IN
            return {"wq": wq, "gamma": layer.norm_layer.weight, "beta": layer.norm_layer.bias,
                    "sin": sin}

        enc = _encoder_layers(model)
        dec = _decoder_layers(model)
        stem = {"w": enc[0].conv_layer.weight, "b": enc[0].conv_layer.bias,
                "gamma": enc[0].norm_layer.weight, "beta": enc[0].norm_layer.bias}
        out = model.DeconvBlock[-1].conv_layer
        qmodel = QuantizedTransformerNet(
            stem=stem,
            encoder=[in_conv(layer, layer.conv_layer.weight, s)
                     for layer, s in zip(enc[1:], scales["encoder"][1:])],
            residual=[{k: in_conv(getattr(block, k), getattr(block, k).conv_layer.weight, s[k])
                       for k in ("conv1", "conv2")}
                      for block, s in zip(model.ResidualBlock, scales["residual"])],
            decoder=[in_conv(layer, layer.conv_transpose.weight.flip(2, 3).transpose(0, 1), s)
                     for layer, s in zip(dec, scales["decoder"])],
            output={"w": out.weight, "b": out.bias},
        )
    return qmodel.to(next(model.parameters()).device)


def transformer_apply_int8(qmodel: QuantizedTransformerNet, x_nhwc: torch.Tensor,
                           accum: torch.dtype = torch.int32) -> torch.Tensor:
    """JAX ``transformer_apply_int8``: the quantized forward, NHWC BGR -> NHWC bf16."""
    return qmodel(x_nhwc, accum=accum)
