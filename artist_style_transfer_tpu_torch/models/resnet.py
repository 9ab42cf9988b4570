"""ResNet-50 artist classifier with the fastai head, 19 classes (counterpart of the JAX
``models/resnet.py``; reference classifier.py:43-66).

The torchvision resnet50 body without avgpool and fc, then
AdaptiveConcatPool2d(1) [max first, then avg — classifier.py:25] -> Flatten
-> BatchNorm1d(4096) -> Dropout(0) -> Linear(4096, 512) -> ReLU ->
BatchNorm1d(512) -> Dropout(0) -> Linear(512, 19).

The module's ``state_dict()`` has exactly the reference's keys (``0.*`` the
body, ``1.*`` the head), ``num_batches_tracked`` included, so the fastai
checkpoint ``best-2.pth`` loads strictly with :func:`load_classifier`.

Frozen, always in inference mode: every BN runs
:func:`ops.norm.batch_norm_inference` on its running buffers, whatever
``.train()`` says, as the reference runs the classifier in ``eval()``
(train_cnn.py:158, inference.py:62). Gradients still flow through it to its
input in the 'classifier' training mode (train_cnn.py:311-314); its own
weights get none. Inside, it runs in ``channels_last``. Training the
classifier itself (``train/classifier.py``) runs the same trunk through
:func:`classifier_apply_train`, BN on batch statistics, and
:func:`update_running_stats`.

Input: NHWC, **RGB**, [0,1] torchvision-normalized.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from artist_style_transfer_tpu_torch.ops.conv import (
    avg_pool_global,
    conv2d,
    linear,
    max_pool2d,
    max_pool_global,
)
from artist_style_transfer_tpu_torch.ops.norm import batch_norm_inference, batch_norm_train
from artist_style_transfer_tpu_torch.utils.device import resolve_device

# The 19 artist classes, reference train_cnn.py:262-266 / inference.py:15-19.
ARTISTS_19 = (
    "Alfred_Sisley", "Amedeo_Modigliani", "Andy_Warhol", "Edgar_Degas",
    "Francisco_Goya", "Henri_Matisse", "Leonardo_da_Vinci", "Marc_Chagall",
    "Mikhail_Vrubel", "Pablo_Picasso", "Paul_Gauguin", "Paul_Klee",
    "Peter_Paul_Rubens", "Pierre-Auguste_Renoir", "Rembrandt", "Rene_Magritte",
    "Sandro_Botticelli", "Titian", "Vincent_van_Gogh",
)

# (num_blocks, bottleneck_width, stride_of_first_block) per stage; out = width*4.
RESNET50_STAGES = ((3, 64, 1), (4, 128, 2), (6, 256, 2), (3, 512, 2))
FEATURES = 4096  # the concat pool: 2 x 2048
HIDDEN = 512


def _bn(x: torch.Tensor, bn: nn.Module) -> torch.Tensor:
    return batch_norm_inference(x, bn.weight, bn.bias, bn.running_mean, bn.running_var, bn.eps)


class Bottleneck(nn.Module):
    """torchvision Bottleneck: 1x1 -> 3x3 (stride) -> 1x1, BN+ReLU, projection shortcut
    in the first block of a stage."""

    def __init__(self, cin: int, width: int, stride: int):
        super().__init__()
        cout = width * 4
        self.stride = stride
        self.conv1 = nn.Conv2d(cin, width, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(width)
        self.conv3 = nn.Conv2d(width, cout, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(cout)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(nn.Conv2d(cin, cout, 1, stride, bias=False),
                                            nn.BatchNorm2d(cout))

    def forward(self, x: torch.Tensor, bn=_bn) -> torch.Tensor:
        """``bn(h, module)`` supplies the BN behaviour (frozen by default)."""
        h = torch.relu(bn(conv2d(x, self.conv1.weight), self.bn1))
        h = torch.relu(bn(conv2d(h, self.conv2.weight, stride=self.stride, padding=1), self.bn2))
        h = bn(conv2d(h, self.conv3.weight), self.bn3)
        identity = x
        if self.downsample is not None:
            conv, down_bn = self.downsample
            identity = bn(conv2d(x, conv.weight, stride=self.stride), down_bn)
        return torch.relu(h + identity)


class ResNet50Classifier(nn.Module):
    """The reference ``ArtistClassifier`` under its own state-dict keys."""

    def __init__(self, num_classes: int = len(ARTISTS_19)):
        super().__init__()
        # Only the positions that hold weights are modules: ReLU (0.2), MaxPool
        # (0.3), ConcatPool (1.0), Flatten (1.1), Dropout (1.3, 1.7) and ReLU (1.5)
        # are functions in forward.
        body, head = nn.Module(), nn.Module()
        body.add_module("0", nn.Conv2d(3, 64, 7, 2, 3, bias=False))
        body.add_module("1", nn.BatchNorm2d(64))
        cin = 64
        for i, (blocks, width, stride) in enumerate(RESNET50_STAGES):
            stage = []
            for b in range(blocks):
                stage.append(Bottleneck(cin, width, stride if b == 0 else 1))
                cin = width * 4
            body.add_module(str(4 + i), nn.Sequential(*stage))
        head.add_module("2", nn.BatchNorm1d(FEATURES))
        head.add_module("4", nn.Linear(FEATURES, HIDDEN))
        head.add_module("6", nn.BatchNorm1d(HIDDEN))
        head.add_module("8", nn.Linear(HIDDEN, num_classes))
        self.add_module("0", body)
        self.add_module("1", head)
        self.requires_grad_(False)
        self.to(memory_format=torch.channels_last)

    def forward(self, x_nhwc: torch.Tensor, return_features: bool = False) -> torch.Tensor:
        """Logits (N, num_classes), or with ``return_features`` the 512-wide post-ReLU
        fc1 output (the embedding JAX's Fréchet metric reads)."""
        return _forward(self, x_nhwc, _bn, return_features)


def _forward(model: ResNet50Classifier, x_nhwc: torch.Tensor, bn, return_features: bool):
    """The shared trunk (JAX ``_forward``); ``bn(h, module)`` supplies the BN behaviour."""
    body, head = model.get_submodule("0"), model.get_submodule("1")
    x = x_nhwc.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    x = torch.relu(bn(conv2d(x, body.get_submodule("0").weight, stride=2, padding=3),
                      body.get_submodule("1")))
    x = max_pool2d(x, 3, 2, padding=1)
    for i in range(len(RESNET50_STAGES)):
        for block in body.get_submodule(str(4 + i)):
            x = block(x, bn)
    feats = torch.cat([max_pool_global(x), avg_pool_global(x)], dim=1)  # (N, 4096)
    fc1, fc2 = head.get_submodule("4"), head.get_submodule("8")
    h = torch.relu(linear(bn(feats, head.get_submodule("2")), fc1.weight, fc1.bias))
    if return_features:
        return h
    return linear(bn(h, head.get_submodule("6")), fc2.weight, fc2.bias)


def classifier_apply_train(
    model: ResNet50Classifier, x_nhwc: torch.Tensor, return_features: bool = False,
    mesh=None,
) -> tuple[torch.Tensor, dict[str, tuple[torch.Tensor, torch.Tensor]]]:
    """Train-mode forward (JAX ``classifier_apply_train``): every BN normalizes by the
    batch statistics (:func:`ops.norm.batch_norm_train`).

    Returns ``(logits, bn_stats)``: ``bn_stats`` maps each BN module's name in
    ``model`` (``"0.4.1.bn2"``, ``"1.2"``: its state-dict prefix) to its (batch mean,
    unbiased batch variance), f32, for :func:`update_running_stats`. Differentiable
    in the parameters the caller lets require grad; the running statistics are
    neither read nor written. With ``mesh`` (its ranks holding one batch between them)
    every BN's statistics are the whole batch's (``batch_norm_train(mesh=)``).
    """
    names = {m: n for n, m in model.named_modules()
             if isinstance(m, nn.modules.batchnorm._BatchNorm)}
    stats: dict[str, tuple[torch.Tensor, torch.Tensor]] = {}

    def bn(h: torch.Tensor, m: nn.Module) -> torch.Tensor:
        y, mean, var = batch_norm_train(h, m.weight, m.bias, m.eps, mesh=mesh)
        stats[names[m]] = (mean, var)
        return y

    return _forward(model, x_nhwc, bn, return_features), stats


def update_running_stats(model: ResNet50Classifier, bn_stats: dict, momentum: float = 0.1) -> None:
    """Fold batch statistics into the BN running buffers in place, torch-style (JAX
    ``update_running_stats``): ``running = (1 - momentum) * running + momentum * batch``,
    the variance unbiased, as ``nn.BatchNorm{1,2}d`` in train mode, which also counts
    the batch in ``num_batches_tracked``. BN modules missing from ``bn_stats`` keep
    their buffers."""
    with torch.no_grad():
        for name, (mean, var) in bn_stats.items():
            m = model.get_submodule(name)
            m.running_mean.mul_(1.0 - momentum).add_(mean * momentum)
            m.running_var.mul_(1.0 - momentum).add_(var * momentum)
            m.num_batches_tracked.add_(1)


def init_classifier(
    generator: torch.Generator,
    device: str | torch.device = "cpu",
    num_classes: int = len(ARTISTS_19),
) -> ResNet50Classifier:
    """Random classifier weights drawn like the JAX ``init_classifier_params``:
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for convs and dense layers (weights and
    biases), BN at gamma 1, beta 0, mean 0, var 1.

    Draws run in module order on the CPU, so a seed gives the same net on
    every device. For tests and smoke runs; real use loads ``best-2.pth``.
    """
    model = ResNet50Classifier(num_classes)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                bound = 1.0 / m.weight[0].numel() ** 0.5
                for p in (m.weight, m.bias):
                    if p is not None:
                        p.copy_(torch.rand(p.shape, generator=generator) * (2 * bound) - bound)
    return model.to(device)


def load_classifier(path: str, device: str | torch.device | None = None) -> ResNet50Classifier:
    """Load the reference classifier (``best-2.pth``) onto ``device`` (``None``: CUDA).

    fastai saves ``{'model': state_dict, 'opt': ...}`` (classifier.py:62-63);
    the wrapper is unwrapped, as the JAX ``load_torch_state_dict`` does, and the
    state dict loads strictly.
    """
    dev = resolve_device(device)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd.get("model"), dict):
        sd = sd["model"]
    model = ResNet50Classifier(num_classes=sd["1.8.weight"].shape[0])
    model.load_state_dict(sd)
    return model.to(dev)
