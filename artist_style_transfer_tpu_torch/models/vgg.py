"""VGG16 feature extractor for the perceptual and style losses (counterpart of the
JAX ``models/vgg.py``).

The torchvision vgg16 ``features`` stack truncated at relu4_3, with the
torchvision keys ``features.{0,2,5,7,10,12,14,17,19,21}``, returning the taps
relu1_2, relu2_2, relu3_3, relu4_3 (reference train_cnn.py:50-78), or relu2_2
alone with ``just_content``. Conv -> ReLU -> 2x2/2 max-pool in floor mode,
unquantized and unfolded. Params are frozen.

Input NHWC BGR [0,255] minus the Caffe mean (``ops.image.vgg_caffe_preprocess``).
Inside, the stack runs in ``channels_last``, so every tap is returned as a
contiguous NHWC view — the layout the Gram kernel reads.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

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
        self, x_nhwc: torch.Tensor, just_content: bool = False
    ) -> dict[str, torch.Tensor] | torch.Tensor:
        """NHWC preprocessed input -> {tap: NHWC activation} (or relu2_2 alone)."""
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
