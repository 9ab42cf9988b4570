"""Int8-quantized ResNet-50 artist classifier, forward only (counterpart of the JAX
``models/resnet_q.py``).

The classifier is frozen wherever the reference uses it, and the quantitative
eval runs it forward only, so its bottleneck convs can run in int8:

- inference-mode BN folds into the conv before it once: ``w' = w * inv[c_out]``,
  ``b' = beta - mean * inv`` with ``inv = gamma / sqrt(var + eps)``;
- folded weights quantize per output channel; activations with a dynamic
  per-tensor scale, the absmax of each call over the whole batch
  (:func:`ops.qconv.conv2d_frozen_int8`, kernel K2's dequant epilogue on CUDA);
- the 7x7 stem (C_in = 3) stays a bf16 cuDNN conv with its BN folded, and the
  fastai head stays bf16.

The real unit stream is bf16. Unlike the TransformerNet's IN, the folded BN lets
the quantization error propagate: it is rounding noise on a 19-way argmax.
Input: NHWC, RGB, torchvision-normalized, as :class:`models.resnet.ResNet50Classifier`.
'classifier'-mode training differentiates through the classifier: the int8 convs'
STE data gradients run on K2 too.

``QuantizedClassifier.forward_rows`` runs it on one band of an image's rows, as
``ResNet50Classifier.forward_rows`` runs the real net: each int8 conv with a
window of more than one row or a stride on its gathered, zero-padded rows (W padded
before the quantize), its input scale the max over the batch's ranks of their own
rows; an empty band launches no K2 and joins every scale's collective.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from artist_style_transfer_tpu_torch.models.resnet import RESNET50_STAGES, ResNet50Classifier
from artist_style_transfer_tpu_torch.ops.conv import (
    avg_pool_global,
    max_pool2d,
    max_pool_global,
)
from artist_style_transfer_tpu_torch.ops.norm import BATCH_NORM_EPS
from artist_style_transfer_tpu_torch.ops.qconv import absmax_scale, conv2d_frozen_int8, quant_weight
from artist_style_transfer_tpu_torch.parallel.spatial import (
    RowBands,
    conv_rows,
    max_pool_rows,
    row_max,
    row_mean,
)

_REAL_DTYPE = torch.bfloat16
_HEAD_KEYS = {"bn1": ("gamma", "beta", "mean", "var"), "fc1": ("w", "b"),
              "bn2": ("gamma", "beta", "mean", "var"), "fc2": ("w", "b")}


def _fold_bn(w_oihw: torch.Tensor, bn: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """Fold inference-mode BN (``gamma``, ``beta``, ``mean``, ``var``) into the conv
    before it: returns (w', b') in f32."""
    inv = bn["gamma"] / torch.sqrt(bn["var"] + BATCH_NORM_EPS)
    w = w_oihw.float() * inv.view(-1, 1, 1, 1)
    b = bn["beta"] - bn["mean"] * inv
    return w, b


def _bn_dict(bn: nn.Module) -> dict:
    return {"gamma": bn.weight, "beta": bn.bias, "mean": bn.running_mean, "var": bn.running_var}


def _copy(t, dtype: torch.dtype) -> torch.Tensor:
    t = torch.as_tensor(t).detach().to(dtype, copy=True)
    return t.contiguous(memory_format=torch.channels_last) if t.dim() == 4 else t


class FrozenInt8Conv(nn.Module):
    """A BN-folded conv in int8: codes ``wq`` (OIHW), scales ``sw`` and bias ``b`` (f32)."""

    def __init__(self, p: dict, stride: int, padding: int):
        super().__init__()
        self.register_buffer("wq", _copy(p["wq"], torch.int8))
        self.register_buffer("sw", _copy(p["sw"], torch.float32))
        self.register_buffer("b", _copy(p["b"], torch.float32))
        self.stride, self.padding = stride, padding

    def forward(self, x: torch.Tensor, mesh=None) -> torch.Tensor:
        return conv2d_frozen_int8(x, self.wq, self.sw, self.b, self.padding, self.stride, mesh)

    def forward_rows(self, x: torch.Tensor, rows: RowBands,
                     mesh) -> tuple[torch.Tensor, RowBands]:
        """:meth:`forward` on this rank's band of rows; ``mesh`` the batch's ranks."""
        k, p, s = self.wq.shape[2], self.padding, self.stride
        if k == 1 and s == 1:  # band-local
            return self(x, mesh), rows
        s_in = absmax_scale(x, mesh)  # over the rows this rank owns, before the gather

        def run(t):  # H arrives zero-padded; W is padded before the quantize
            if p:
                t = F.pad(t, (p, p, 0, 0)).contiguous(memory_format=torch.channels_last)
            return conv2d_frozen_int8(t, self.wq, self.sw, self.b, 0, s, mesh, s_in)

        return conv_rows(x, rows, k, s, p, run, self.wq.shape[0], pad_mode="zeros",
                         collective=True)


class QuantizedBottleneck(nn.Module):
    def __init__(self, p: dict, stride: int):
        super().__init__()
        self.conv1 = FrozenInt8Conv(p["conv1"], 1, 0)
        self.conv2 = FrozenInt8Conv(p["conv2"], stride, 1)
        self.conv3 = FrozenInt8Conv(p["conv3"], 1, 0)
        self.down = FrozenInt8Conv(p["down"], stride, 0) if "down" in p else None

    def forward(self, x: torch.Tensor, mesh=None) -> torch.Tensor:
        h = torch.relu(self.conv1(x, mesh))
        h = torch.relu(self.conv2(h, mesh))
        h = self.conv3(h, mesh)
        identity = x if self.down is None else self.down(x, mesh)
        return torch.relu(h + identity)

    def forward_rows(self, x: torch.Tensor, rows: RowBands,
                     mesh) -> tuple[torch.Tensor, RowBands]:
        h = torch.relu(self.conv1.forward_rows(x, rows, mesh)[0])
        h, out = self.conv2.forward_rows(h, rows, mesh)
        h = self.conv3.forward_rows(torch.relu(h), out, mesh)[0]
        identity = x if self.down is None else self.down.forward_rows(x, rows, mesh)[0]
        return torch.relu(h + identity), out


class QuantizedClassifier(nn.Module):
    """The quantized classifier (JAX ``quantize_classifier``'s pytree, in torch layouts)
    and its forward (JAX ``classifier_apply_int8``). Holds buffers only.

    ``stem``: ``w`` (OIHW, BN folded) and ``b``; ``stages``: lists of blocks, each a
    dict of ``conv1``-``conv3`` (and ``down``) dicts ``wq``/``sw``/``b``; ``head``:
    ``bn1``/``bn2`` (``gamma``, ``beta``, ``mean``, ``var``) and ``fc1``/``fc2``
    (``w`` (O, I), ``b``), cast to bf16 as JAX casts them.
    """

    def __init__(self, stem: dict, stages: list[list[dict]], head: dict):
        super().__init__()
        if len(stages) != len(RESNET50_STAGES):
            raise ValueError(f"a ResNet-50 has {len(RESNET50_STAGES)} stages, got {len(stages)}")
        self.register_buffer("stem_w", _copy(stem["w"], _REAL_DTYPE))
        self.register_buffer("stem_b", _copy(stem["b"], torch.float32))
        self.stages = nn.ModuleList(
            nn.ModuleList(QuantizedBottleneck(block, stride if i == 0 else 1)
                          for i, block in enumerate(stage))
            for stage, (_, _, stride) in zip(stages, RESNET50_STAGES))
        for layer, keys in _HEAD_KEYS.items():
            for k in keys:
                self.register_buffer(f"{layer}_{k}", _copy(head[layer][k], _REAL_DTYPE))

    def _bn1d(self, v: torch.Tensor, layer: str) -> torch.Tensor:
        p = {k: getattr(self, f"{layer}_{k}").float() for k in _HEAD_KEYS[layer]}
        inv = torch.rsqrt(p["var"] + BATCH_NORM_EPS) * p["gamma"]
        return (v.float() * inv + (p["beta"] - p["mean"] * inv)).to(_REAL_DTYPE)

    def _linear(self, v: torch.Tensor, layer: str) -> torch.Tensor:
        return F.linear(v, getattr(self, f"{layer}_w")) + getattr(self, f"{layer}_b")

    def forward(self, x_nhwc: torch.Tensor, return_features: bool = False,
                mesh=None) -> torch.Tensor:
        """bf16 logits (N, num_classes), or with ``return_features`` the 512-wide
        post-ReLU fc1 output. With ``mesh`` the int8 convs' dynamic scales are the
        whole batch's over its ranks."""
        x = x_nhwc.to(_REAL_DTYPE).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        h = F.conv2d(x, self.stem_w, stride=2, padding=3)
        x = torch.relu(h.float() + self.stem_b.view(1, -1, 1, 1)).to(_REAL_DTYPE)
        x = max_pool2d(x, 3, 2, padding=1)
        for stage in self.stages:
            for block in stage:
                x = block(x, mesh)
        feats = torch.cat([max_pool_global(x), avg_pool_global(x)], dim=1)
        return self._head(feats, return_features)

    def _head(self, feats: torch.Tensor, return_features: bool = False) -> torch.Tensor:
        h = torch.relu(self._linear(self._bn1d(feats, "bn1"), "fc1"))
        if return_features:
            return h
        return self._linear(self._bn1d(h, "bn2"), "fc2")

    def forward_rows(self, x_nhwc: torch.Tensor, rows: RowBands, mesh=None) -> torch.Tensor:
        """:meth:`forward`'s bf16 logits from this rank's band of rows (``rows`` says
        whose band is which), the same on every rank of ``rows.mesh``, which all run it
        at once. ``mesh``: the ranks that hold the batch between them, for the dynamic
        scales (None: ``rows.mesh``)."""
        mesh = rows.mesh if mesh is None else mesh
        x = x_nhwc.to(_REAL_DTYPE).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        h, rows = conv_rows(x, rows, 7, 2, 3,
                            lambda t: F.conv2d(t, self.stem_w, stride=2, padding=(0, 3)),
                            self.stem_w.shape[0], pad_mode="zeros")
        x = torch.relu(h.float() + self.stem_b.view(1, -1, 1, 1)).to(_REAL_DTYPE)
        x, rows = max_pool_rows(x, rows)
        for stage in self.stages:
            for block in stage:
                x, rows = block.forward_rows(x, rows, mesh)
        feats = torch.cat([row_max(x, rows), row_mean(x, rows, replicated=True)[:, :, 0, 0]],
                          dim=1)
        return self._head(feats)


def _quant_conv_params(conv: nn.Conv2d, bn: nn.Module) -> dict:
    w, b = _fold_bn(conv.weight, _bn_dict(bn))
    wq, sw = quant_weight(w)
    return {"wq": wq, "sw": sw, "b": b.float()}


def quantize_classifier(model: ResNet50Classifier) -> QuantizedClassifier:
    """Quantize the ResNet-50 + head for int8 forward-only inference, on its device."""
    body, head = model.get_submodule("0"), model.get_submodule("1")
    with torch.no_grad():
        stem_w, stem_b = _fold_bn(body.get_submodule("0").weight, _bn_dict(body.get_submodule("1")))
        stages = []
        for s in range(len(RESNET50_STAGES)):
            blocks = []
            for block in body.get_submodule(str(4 + s)):
                q = {f"conv{i}": _quant_conv_params(getattr(block, f"conv{i}"),
                                                    getattr(block, f"bn{i}")) for i in (1, 2, 3)}
                if block.downsample is not None:
                    q["down"] = _quant_conv_params(*block.downsample)
                blocks.append(q)
            stages.append(blocks)
        heads = {}
        for name, idx in (("bn1", "2"), ("fc1", "4"), ("bn2", "6"), ("fc2", "8")):
            m = head.get_submodule(idx)
            heads[name] = (_bn_dict(m) if name.startswith("bn")
                           else {"w": m.weight, "b": m.bias})
        qmodel = QuantizedClassifier({"w": stem_w, "b": stem_b}, stages, heads)
    return qmodel.to(next(model.parameters()).device)


def classifier_is_quantized(model) -> bool:
    """True for a module made by :func:`quantize_classifier`."""
    return isinstance(model, QuantizedClassifier)


def classifier_apply_int8(qmodel: QuantizedClassifier, x_nhwc: torch.Tensor,
                          return_features: bool = False, mesh=None) -> torch.Tensor:
    """JAX ``classifier_apply_int8``: logits (or features) of the quantized classifier."""
    return qmodel(x_nhwc, return_features=return_features, mesh=mesh)
