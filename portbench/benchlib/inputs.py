"""Weights and images made from the seed, on the device, in a few large calls.

Each net's weights are one ``randn`` of all its leaves from a generator on the device,
cut into leaves and scaled by the init the configuration file states under ``assumed``.
Images are smooth random fields with fine noise, made in chunks. The same seed gives the
same tensors; each kind of tensor draws from a stream of its own, keyed on (seed, name).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from reference import nets


def generator(seed: int, name: str, device) -> torch.Generator:
    words = [int(seed) & 0xFFFFFFFF, int(seed) >> 32] + [ord(ch) for ch in name]
    key = int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0]) & (2**63 - 1)
    return torch.Generator(device=device).manual_seed(key)


def _draw(spec: list[tuple[str, tuple, float, float]], seed: int, name: str, device) -> dict:
    """spec: (key, shape, std, mean) per leaf -> {key: f32 tensor}, from one randn."""
    sizes = [int(np.prod(shape)) for _, shape, _, _ in spec]
    flat = torch.randn(sum(sizes), generator=generator(seed, name, device), device=device)
    out, at = {}, 0
    for (key, shape, std, mean), n in zip(spec, sizes):
        out[key] = (flat[at:at + n] * std + mean).view(shape)
        at += n
    return out


def _norm_leaves(pre: str, c: int) -> list:
    return [(f"{pre}.weight", (c,), 0.1, 1.0), (f"{pre}.bias", (c,), 0.1, 0.0)]


def transformer_weights(seed: int, device, init: dict) -> dict:
    """TransformerNet leaves: convs N(0, 1/fan_in), norms gamma N(1, 0.1^2), beta
    N(0, 0.1^2); the output conv scaled so that the image spans about
    ``output_mean`` +- ``output_std`` before the clip."""
    spec = []
    for i, (k, _, cin, cout) in enumerate(nets.T_ENCODER):
        pre = f"ConvBlock.{2 * i}"
        spec += [(f"{pre}.conv_layer.weight", (cout, cin, k, k), (cin * k * k) ** -0.5, 0.0),
                 (f"{pre}.conv_layer.bias", (cout,), 0.1, 0.0)] + _norm_leaves(f"{pre}.norm_layer", cout)
    for r in range(nets.T_RESIDUAL):
        for j in (1, 2):
            pre = f"ResidualBlock.{r}.conv{j}"
            c = nets.T_CHANNELS
            spec += [(f"{pre}.conv_layer.weight", (c, c, 3, 3), (c * 9) ** -0.5, 0.0),
                     (f"{pre}.conv_layer.bias", (c,), 0.1, 0.0)] + _norm_leaves(f"{pre}.norm_layer", c)
    for i, (k, _, _, cin, cout) in enumerate(nets.T_DECODER):
        pre = f"DeconvBlock.{2 * i}"
        spec += [(f"{pre}.conv_transpose.weight", (cin, cout, k, k), (cin * k * k) ** -0.5, 0.0),
                 (f"{pre}.conv_transpose.bias", (cout,), 0.1, 0.0)] + _norm_leaves(f"{pre}.norm_layer", cout)
    k, _, cin, cout = nets.T_OUTPUT
    # relu(IN(x)) has a second moment of about 1/2 a channel
    spec += [("DeconvBlock.6.conv_layer.weight", (cout, cin, k, k),
              init["output_std"] / (0.5 * cin * k * k) ** 0.5, 0.0),
             ("DeconvBlock.6.conv_layer.bias", (cout,), init["output_std"] / 6, init["output_mean"])]
    return _draw(spec, seed, "transformer", device)


def vgg_weights(seed: int, device) -> dict:
    """VGG16 to conv4_3: weights N(0, 2/fan_in) (He), biases N(0, 0.01^2)."""
    spec = []
    for idx, cin, cout in nets.VGG_CONVS:
        spec += [(f"features.{idx}.weight", (cout, cin, 3, 3), (2.0 / (cin * 9)) ** 0.5, 0.0),
                 (f"features.{idx}.bias", (cout,), 0.01, 0.0)]
    return _draw(spec, seed, "vgg16", device)


def _bn(pre: str, c: int, gamma: float = 1.0) -> list:
    return [(f"{pre}.weight", (c,), 0.1 * gamma, gamma), (f"{pre}.bias", (c,), 0.1, 0.0),
            (f"{pre}.running_mean", (c,), 0.1, 0.0), (f"{pre}.running_var", (c,), 0.05, 1.0)]


def classifier_weights(seed: int, device) -> dict:
    """ResNet-50 + head: convs N(0, 2/fan_in), BN gamma N(1, 0.1^2) (the last BN of each
    bottleneck N(0.5, 0.05^2), so the residual stream grows slowly), beta and running mean
    N(0, 0.1^2), running var N(1, 0.05^2); dense layers N(0, 1/fan_in), biases N(0, 0.1^2)."""
    spec = [("0.0.weight", (64, 3, 7, 7), (2.0 / 147) ** 0.5, 0.0)] + _bn("0.1", 64)
    cin = 64
    for s, (blocks, width, _) in enumerate(nets.RESNET_STAGES):
        for b in range(blocks):
            pre = f"0.{4 + s}.{b}"
            cout = 4 * width
            for j, (ci, co, k) in enumerate(((cin, width, 1), (width, width, 3), (width, cout, 1)), 1):
                spec += [(f"{pre}.conv{j}.weight", (co, ci, k, k), (2.0 / (ci * k * k)) ** 0.5, 0.0)]
                spec += _bn(f"{pre}.bn{j}", co, 0.5 if j == 3 else 1.0)
            if b == 0:
                spec += [(f"{pre}.downsample.0.weight", (cout, cin, 1, 1), (2.0 / cin) ** 0.5, 0.0)]
                spec += _bn(f"{pre}.downsample.1", cout)
            cin = cout
    spec += _bn("1.2", nets.HEAD_FEATURES)
    spec += [("1.4.weight", (nets.HEAD_HIDDEN, nets.HEAD_FEATURES), nets.HEAD_FEATURES ** -0.5, 0.0),
             ("1.4.bias", (nets.HEAD_HIDDEN,), 0.1, 0.0)]
    spec += _bn("1.6", nets.HEAD_HIDDEN)
    spec += [("1.8.weight", (nets.CLASSES, nets.HEAD_HIDDEN), nets.HEAD_HIDDEN ** -0.5, 0.0),
             ("1.8.bias", (nets.CLASSES,), 0.1, 0.0)]
    out = _draw(spec, seed, "classifier", device)
    for key in [k for k in out if k.endswith(".running_var")]:
        out[key[: -len("running_var")] + "num_batches_tracked"] = torch.zeros(
            (), dtype=torch.int64, device=device)
    return out


def images(seed: int, name: str, n: int, size: int, device, chunk: int = 8) -> torch.Tensor:
    """(n, size, size, 3) uint8 BGR: a bilinear field from a 1/32-scale grid plus
    uniform noise of +-24, clipped."""
    gen = generator(seed, name, device)
    coarse = size // 32 + 2
    out = torch.empty((n, size, size, 3), dtype=torch.uint8, device=device)
    for i in range(0, n, chunk):
        m = min(chunk, n - i)
        low = torch.rand((m, 3, coarse, coarse), generator=gen, device=device) * 255.0
        x = F.interpolate(low, size=(size, size), mode="bilinear", align_corners=False)
        x = x + (torch.rand((m, 3, size, size), generator=gen, device=device) - 0.5) * 48.0
        out[i:i + m] = x.clamp(0.0, 255.0).to(torch.uint8).permute(0, 2, 3, 1)
    return out
