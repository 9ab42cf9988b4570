"""VGG16 feature extractor for the perceptual and style losses (counterpart of the
JAX ``models/vgg.py``).

The torchvision vgg16 ``features`` stack truncated at relu4_3, with the
torchvision keys ``features.{0,2,5,7,10,12,14,17,19,21}``, returning the taps
relu1_2, relu2_2, relu3_3, relu4_3 (reference train_cnn.py:50-78), or relu2_2
alone with ``just_content``. Conv -> ReLU -> 2x2/2 max-pool in floor mode,
unfolded. Params are frozen.

:func:`quantize_vgg16_loss` makes the int8 loss extractor of the quantized
training path (JAX ``quantize_vgg16_loss``): the convs from a split point on run
through :func:`ops.qconv.conv2d_frozen_int8`, forward and STE data gradient on
kernel K2.

Input NHWC BGR [0,255] minus the Caffe mean (``ops.image.vgg_caffe_preprocess``).
Inside, the stack runs in ``channels_last``, so every tap is returned as a
contiguous NHWC view — the layout the Gram kernel reads.

``VGG16Features.forward_rows`` runs the same stack on one band of an image's rows
while the other ranks of a mesh run the others (:mod:`parallel.spatial`: the 3x3
convs' zero-padded halo rows and the pools' straddling row pairs fetched from the
neighbours), differentiable, for training over a 'space' axis;
``QuantizedVGG16Features.forward_rows`` likewise, its int8 convs on K2 with their
dynamic scales the whole batch's.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from artist_style_transfer_tpu_torch.ops.qconv import absmax_scale, conv2d_frozen_int8, quant_weight
from artist_style_transfer_tpu_torch.parallel.spatial import RowBands, conv_rows, pool_rows

VGG_LAYER_NAMES = ("relu1_2", "relu2_2", "relu3_3", "relu4_3")

# (torchvision features index, in_ch, out_ch) of each 3x3/1 pad-1 conv through conv4_3.
VGG_CONVS = (
    (0, 3, 64), (2, 64, 64),
    (5, 64, 128), (7, 128, 128),
    (10, 128, 256), (12, 256, 256), (14, 256, 256),
    (17, 256, 512), (19, 512, 512), (21, 512, 512),
)
POOL_BEFORE = frozenset((5, 10, 17))  # a 2x2/2 max-pool precedes these convs
TAP_AFTER = {2: "relu1_2", 7: "relu2_2", 14: "relu3_3", 21: "relu4_3"}


class VGG16Features(nn.Module):
    def __init__(self):
        super().__init__()
        self.features = nn.Module()
        for idx, cin, cout in VGG_CONVS:
            self.features.add_module(str(idx), nn.Conv2d(cin, cout, 3, padding=1))
        self.requires_grad_(False)
        self.to(memory_format=torch.channels_last)

    def forward(
        self, x_nhwc: torch.Tensor, just_content: bool = False, mesh=None
    ) -> dict[str, torch.Tensor] | torch.Tensor:
        """NHWC preprocessed input -> {tap: NHWC activation} (or relu2_2 alone). With
        ``mesh`` the int8 convs' dynamic scales are the whole batch's over its ranks."""
        x = x_nhwc.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        taps: dict[str, torch.Tensor] = {}
        for idx, _, _ in VGG_CONVS:
            if idx in POOL_BEFORE:
                x = F.max_pool2d(x, 2, 2)
            conv = getattr(self.features, str(idx))
            x = F.relu(F.conv2d(x, conv.weight, conv.bias, padding=1))
            name = TAP_AFTER.get(idx)
            if name is not None:
                tap = x.permute(0, 2, 3, 1)
                if just_content and name == "relu2_2":
                    return tap
                taps[name] = tap
        return taps

    def forward_rows(
        self, x_nhwc: torch.Tensor, rows: RowBands, just_content: bool = False, mesh=None
    ) -> dict[str, tuple[torch.Tensor, RowBands]] | tuple[torch.Tensor, RowBands]:
        """:meth:`forward` on this rank's band of rows (``rows`` says whose band is which)
        of NHWC preprocessed images: {tap: (this rank's NHWC band of it, its
        :class:`RowBands`)}, or relu2_2's pair alone. Every rank of ``rows.mesh`` runs it
        at once. ``mesh`` is taken, as :meth:`forward` takes it, and unused."""
        del mesh
        return _forward_rows(
            x_nhwc.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last), rows,
            [_real_conv(getattr(self.features, str(idx)).weight,
                        getattr(self.features, str(idx)).bias) for idx, _, _ in VGG_CONVS],
            just_content)


def _real_conv(w: torch.Tensor, b: torch.Tensor):
    """A banded layer of :func:`_forward_rows`: the zero-padded 3x3 conv in the real dtype."""
    def layer(x, rows):
        def run(t):  # H arrives zero-padded; W is padded here
            return F.conv2d(t, w, b, padding=(0, 1))

        return conv_rows(x, rows, 3, 1, 1, run, w.shape[0], pad_mode="zeros")

    return layer


def _int8_conv(wq: torch.Tensor, sw: torch.Tensor, b: torch.Tensor, mesh):
    """A banded layer of :func:`_forward_rows`: the zero-padded 3x3 conv in int8 on K2, its
    input scale the max over ``mesh`` of every rank's own rows (the halo rows are some
    other rank's), taken before the gather; an empty band launches nothing and joins
    the scales' collectives, forward and backward."""
    def layer(x, rows):
        s_in = absmax_scale(x, mesh)

        def run(t):  # H arrives zero-padded; W is padded before the quantize
            t = F.pad(t, (1, 1, 0, 0)).contiguous(memory_format=torch.channels_last)
            return conv2d_frozen_int8(t, wq, sw, b, 0, 1, mesh, s_in)

        return conv_rows(x, rows, 3, 1, 1, run, wq.shape[0], pad_mode="zeros", collective=True)

    return layer


def _forward_rows(x: torch.Tensor, rows: RowBands, layers: list, just_content: bool):
    """The banded VGG16 stack over NCHW ``x``: ``layers[i](x, rows)`` runs conv i."""
    taps: dict[str, tuple[torch.Tensor, RowBands]] = {}
    for (idx, _, _), layer in zip(VGG_CONVS, layers):
        if idx in POOL_BEFORE:
            x, rows = pool_rows(x, rows)
        x, rows = layer(x, rows)
        x = F.relu(x)
        name = TAP_AFTER.get(idx)
        if name is not None:
            tap = (x.permute(0, 2, 3, 1), rows)
            if just_content and name == "relu2_2":
                return tap
            taps[name] = tap
    return taps


# First quantized conv (index into VGG_CONVS) of each named split of quantize_vgg16_loss.
QUANTIZE_SPLITS = {"deep": 4, "all": 1}


def first_quantized_conv(layers: str | int) -> int:
    """Index of the first int8 conv for ``layers``: ``"deep"`` conv3_1 (4), ``"all"``
    conv1_2 (1), an int ``max(1, layers)`` (conv1_1, C_in = 3, is never quantized)."""
    if isinstance(layers, str):
        if layers not in QUANTIZE_SPLITS:
            raise ValueError(f"layers must be one of {tuple(QUANTIZE_SPLITS)} or an int, "
                             f"got {layers!r}")
        return QUANTIZE_SPLITS[layers]
    return max(1, int(layers))


class QuantizedVGG16Features(nn.Module):
    """The frozen VGG16 extractor with int8 convs from ``first_q`` on (JAX's
    ``quantize_vgg16_loss`` list and the int8 branch of ``vgg16_features``).

    Buffers only: below ``first_q`` the real ``w{i}`` (OIHW) and ``b{i}`` in one real
    dtype; from ``first_q`` on the int8 codes ``wq{i}`` (OIHW, ``channels_last``), the f32
    per-channel scales ``sw{i}`` and the f32 bias ``b{i}``. The forward takes the
    input of :class:`VGG16Features` and gives its taps (NHWC views), casting the input
    to the real dtype first, so that style targets, content features and the step
    see the same feature function.
    """

    def __init__(self, convs: list[dict], first_q: int):
        super().__init__()
        if len(convs) != len(VGG_CONVS) or not 1 <= first_q <= len(VGG_CONVS):
            raise ValueError(f"a VGG16 to relu4_3 has {len(VGG_CONVS)} convs and conv1_1 stays "
                             f"real; got {len(convs)} and first_q {first_q}")
        self.first_q = first_q
        for i, p in enumerate(convs):
            if i < first_q:
                self.register_buffer(f"w{i}", p["w"].detach().clone().contiguous(
                    memory_format=torch.channels_last))
            else:
                self.register_buffer(f"wq{i}", p["wq"].detach().to(torch.int8).contiguous(
                    memory_format=torch.channels_last))
                self.register_buffer(f"sw{i}", p["sw"].detach().float().clone())
            self.register_buffer(f"b{i}", p["b"].detach().clone())

    def forward(
        self, x_nhwc: torch.Tensor, just_content: bool = False, mesh=None
    ) -> dict[str, torch.Tensor] | torch.Tensor:
        """NHWC preprocessed input -> {tap: NHWC activation} (or relu2_2 alone). With
        ``mesh`` the int8 convs' dynamic scales are the whole batch's over its ranks."""
        x = x_nhwc.to(self.w0.dtype).permute(0, 3, 1, 2).contiguous(  # conv1_1 stays real
            memory_format=torch.channels_last)
        taps: dict[str, torch.Tensor] = {}
        for i, (idx, _, _) in enumerate(VGG_CONVS):
            if idx in POOL_BEFORE:
                x = F.max_pool2d(x, 2, 2)
            b = getattr(self, f"b{i}")
            if i < self.first_q:
                x = F.relu(F.conv2d(x, getattr(self, f"w{i}"), b, padding=1))
            else:
                x = F.relu(conv2d_frozen_int8(x, getattr(self, f"wq{i}"),
                                              getattr(self, f"sw{i}"), b, 1, mesh=mesh))
            name = TAP_AFTER.get(idx)
            if name is not None:
                tap = x.permute(0, 2, 3, 1)
                if just_content and name == "relu2_2":
                    return tap
                taps[name] = tap
        return taps

    def forward_rows(
        self, x_nhwc: torch.Tensor, rows: RowBands, just_content: bool = False, mesh=None
    ) -> dict[str, tuple[torch.Tensor, RowBands]] | tuple[torch.Tensor, RowBands]:
        """:meth:`forward` on this rank's band of rows, as
        :meth:`VGG16Features.forward_rows`: the real convs below ``first_q`` in the real
        dtype, the int8 ones on K2 with their dynamic scales the max over ``mesh`` (the
        ranks that hold the batch between them; None: ``rows.mesh``)."""
        mesh = rows.mesh if mesh is None else mesh
        layers = [_real_conv(getattr(self, f"w{i}"), getattr(self, f"b{i}")) if i < self.first_q
                  else _int8_conv(getattr(self, f"wq{i}"), getattr(self, f"sw{i}"),
                                  getattr(self, f"b{i}"), mesh)
                  for i in range(len(VGG_CONVS))]
        x = x_nhwc.to(self.w0.dtype).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        return _forward_rows(x, rows, layers, just_content)


def quantize_vgg16_loss(vgg: VGG16Features, layers: str | int = "deep",
                        dtype: torch.dtype = torch.bfloat16) -> QuantizedVGG16Features:
    """The int8 loss extractor of ``vgg`` (JAX ``quantize_vgg16_loss``), on its device.

    ``layers`` picks the first int8 conv (:func:`first_quantized_conv`): ``"deep"``
    quantizes conv3_1..conv4_3 and leaves relu1_2 and relu2_2 real; ``"all"`` every
    conv but conv1_1. The real convs keep their weights cast to ``dtype`` (the
    training compute dtype); the int8 ones get per-output-channel codes and scales
    (:func:`ops.qconv.quant_weight`) and an f32 bias.
    """
    if not isinstance(vgg, VGG16Features):
        raise TypeError(f"quantize_vgg16_loss takes a VGG16Features, got {type(vgg).__name__}")
    first_q = first_quantized_conv(layers)
    convs = []
    with torch.no_grad():
        for i, (idx, _, _) in enumerate(VGG_CONVS):
            conv = getattr(vgg.features, str(idx))
            if i < first_q:
                convs.append({"w": conv.weight.to(dtype), "b": conv.bias.to(dtype)})
            else:
                wq, sw = quant_weight(conv.weight)
                convs.append({"wq": wq, "sw": sw, "b": conv.bias.float()})
    return QuantizedVGG16Features(convs, first_q)


def vgg_is_quantized(vgg) -> bool:
    """True for an extractor made by :func:`quantize_vgg16_loss`."""
    return isinstance(vgg, QuantizedVGG16Features)


def init_vgg16(generator: torch.Generator, device: str | torch.device = "cpu") -> VGG16Features:
    """Random VGG16 weights drawn like the JAX ``init_vgg16_params``:
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weights and biases, fan_in = 9*C_in.

    For tests and smoke runs; real use loads the Caffe VGG16 ``.pth``.
    """
    model = VGG16Features()
    with torch.no_grad():
        for idx, cin, _ in VGG_CONVS:
            conv = getattr(model.features, str(idx))
            bound = 1.0 / (cin * 9) ** 0.5
            for p in (conv.weight, conv.bias):
                p.copy_(torch.rand(p.shape, generator=generator) * (2 * bound) - bound)
    return model.to(device)


def load_vgg16(path: str, device: str | torch.device) -> VGG16Features:
    """Load a torchvision-keyed VGG16 ``.pth`` (e.g. ``vgg16-00b39a1b.pth``).

    Keys past ``features.21`` (the layers after relu4_3 and the classifier)
    are not used and are dropped.
    """
    sd = torch.load(path, map_location="cpu", weights_only=True)
    keep = {f"features.{i}.{k}" for i, _, _ in VGG_CONVS for k in ("weight", "bias")}
    model = VGG16Features()
    model.load_state_dict({k: v for k, v in sd.items() if k in keep})
    return model.to(device)
