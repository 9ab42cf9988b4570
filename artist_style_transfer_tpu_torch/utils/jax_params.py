"""Convert between the JAX package's parameter pytrees and the port's state dicts.

The inverse of the JAX ``utils/torch_import.py`` importers, for params given
as numpy-array pytrees (``jax.tree.map(np.asarray, params)``), so parity
tests can run both packages on the same weights; and, for the TransformerNet,
the classifier and the diffusion UNet, the way back
(:func:`transformer_state_dict_to_jax`, :func:`classifier_state_dict_to_jax`,
:func:`diff_model_state_dict_to_jax`), which writes the ``.npz`` artifacts in the
JAX key layout. This module imports neither JAX
nor the JAX package.

Layouts: JAX conv weights are HWIO and become OIHW. JAX transpose-conv
weights are *spatially flipped* HWIO (the importer flips once so the
transpose conv runs as a dilated conv); they become torch's unflipped
(I, O, kH, kW). JAX dense weights are (I, O) and become (O, I).

The quantized pytrees of JAX ``quantize_transformer``, ``quantize_classifier``
and ``quantize_vgg16_loss`` (int8 codes, scales, folded biases) become the port's
quantized modules with the same codes (:func:`quantized_transformer_from_jax`,
:func:`quantized_classifier_from_jax`, :func:`quantized_vgg16_from_jax`). There
every conv weight, the transpose convs' included, is OIHW in the conv form: JAX
runs its flipped HWIO over the dilated input as a plain conv, and so does the port.
"""

from __future__ import annotations

import numpy as np
import torch

from artist_style_transfer_tpu_torch.models.resnet import RESNET50_STAGES
from artist_style_transfer_tpu_torch.models.vgg import VGG_CONVS


def _t(a) -> torch.Tensor:
    # A copy, not ascontiguousarray: a flipped size-1 axis keeps its negative
    # stride under the latter, which torch refuses.
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C", copy=True))


def _conv_w(a) -> torch.Tensor:
    """HWIO -> OIHW."""
    return _t(np.transpose(np.asarray(a), (3, 2, 0, 1)))


def _q(a) -> torch.Tensor:
    """A numpy array of the quantized pytrees, exact: int8 codes stay int8; bf16 (an
    ml_dtypes array) and f32 values go through f32, which holds both exactly."""
    a = np.asarray(a)
    if a.dtype == np.int8:
        return torch.from_numpy(a.copy())
    return _t(a.astype(np.float32))


def _q_conv_w(a) -> torch.Tensor:
    """Quantized HWIO (int8 codes or bf16) -> OIHW in channels_last."""
    return _q(np.transpose(np.asarray(a), (3, 2, 0, 1))).contiguous(
        memory_format=torch.channels_last)


def _convT_w(a) -> torch.Tensor:
    """Spatially flipped HWIO -> torch ConvTranspose2d (I, O, kH, kW)."""
    return _t(np.transpose(np.asarray(a), (2, 3, 0, 1))[:, :, ::-1, ::-1])


def transformer_state_dict_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """JAX TransformerNet pytree -> reference ``StyleTransfer`` state dict."""
    sd: dict[str, torch.Tensor] = {}

    def put_conv(prefix, p, norm=True):
        sd[f"{prefix}.conv_layer.weight"] = _conv_w(p["w"])
        sd[f"{prefix}.conv_layer.bias"] = _t(p["b"])
        if norm:
            sd[f"{prefix}.norm_layer.weight"] = _t(p["gamma"])
            sd[f"{prefix}.norm_layer.bias"] = _t(p["beta"])

    def put_deconv(prefix, p):
        sd[f"{prefix}.conv_transpose.weight"] = _convT_w(p["w"])
        sd[f"{prefix}.conv_transpose.bias"] = _t(p["b"])
        sd[f"{prefix}.norm_layer.weight"] = _t(p["gamma"])
        sd[f"{prefix}.norm_layer.bias"] = _t(p["beta"])

    for i, idx in enumerate((0, 2, 4, 6)):
        put_conv(f"ConvBlock.{idx}", params["encoder"][i])
    for i, r in enumerate(params["residual"]):
        put_conv(f"ResidualBlock.{i}.conv1", r["conv1"])
        put_conv(f"ResidualBlock.{i}.conv2", r["conv2"])
    for i, idx in enumerate((0, 2, 4)):
        put_deconv(f"DeconvBlock.{idx}", params["decoder"][i])
    put_conv("DeconvBlock.6", params["output"], norm=False)
    return sd


def transformer_state_dict_to_jax(sd: dict[str, torch.Tensor]) -> dict:
    """Reference ``StyleTransfer`` state dict -> JAX TransformerNet pytree of f32 numpy
    arrays (inverse of :func:`transformer_state_dict_from_jax`; JAX
    ``transformer_params_from_torch``, ``utils/torch_import.py:64``)."""

    def a(key: str) -> np.ndarray:
        return sd[key].detach().cpu().float().numpy().copy()  # no alias of a live parameter

    def conv(prefix: str, norm: bool = True) -> dict:
        p = {"w": np.ascontiguousarray(np.transpose(a(f"{prefix}.conv_layer.weight"), (2, 3, 1, 0))),
             "b": a(f"{prefix}.conv_layer.bias")}
        if norm:
            p["gamma"] = a(f"{prefix}.norm_layer.weight")
            p["beta"] = a(f"{prefix}.norm_layer.bias")
        return p

    def deconv(prefix: str) -> dict:
        w = a(f"{prefix}.conv_transpose.weight")[:, :, ::-1, ::-1]  # (I, O, kH, kW), flipped
        return {"w": np.ascontiguousarray(np.transpose(w, (2, 3, 0, 1))),
                "b": a(f"{prefix}.conv_transpose.bias"),
                "gamma": a(f"{prefix}.norm_layer.weight"),
                "beta": a(f"{prefix}.norm_layer.bias")}

    return {
        "encoder": [conv(f"ConvBlock.{i}") for i in (0, 2, 4, 6)],
        "residual": [{"conv1": conv(f"ResidualBlock.{i}.conv1"),
                      "conv2": conv(f"ResidualBlock.{i}.conv2")} for i in range(5)],
        "decoder": [deconv(f"DeconvBlock.{i}") for i in (0, 2, 4)],
        "output": conv("DeconvBlock.6", norm=False),
    }


def vgg16_state_dict_from_jax(params: list[dict]) -> dict[str, torch.Tensor]:
    """JAX VGG16 conv param list -> torchvision ``features.N`` state dict."""
    sd: dict[str, torch.Tensor] = {}
    for (idx, _, _), p in zip(VGG_CONVS, params, strict=True):
        sd[f"features.{idx}.weight"] = _conv_w(p["w"])
        sd[f"features.{idx}.bias"] = _t(p["b"])
    return sd


def classifier_state_dict_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """JAX ResNet-50 classifier pytree -> reference ``ArtistClassifier`` state dict.

    The inverse of JAX ``classifier_params_from_torch``, in the layout of JAX
    ``classifier_params_to_torch`` (``utils/torch_import.py:193-236``): OIHW
    convs, (O, I) dense weights, and each BN's ``num_batches_tracked`` at 0,
    so a strict ``load_state_dict`` takes it.
    """
    sd: dict[str, torch.Tensor] = {}

    def put_bn(prefix: str, p: dict) -> None:
        for key, name in (("gamma", "weight"), ("beta", "bias"), ("mean", "running_mean"),
                          ("var", "running_var")):
            sd[f"{prefix}.{name}"] = _t(p[key])
        sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)

    def put_dense(prefix: str, p: dict) -> None:
        sd[f"{prefix}.weight"] = _t(np.asarray(p["w"]).T)
        sd[f"{prefix}.bias"] = _t(p["b"])

    sd["0.0.weight"] = _conv_w(params["stem"]["conv"]["w"])
    put_bn("0.1", params["stem"]["bn"])
    for s_i, stage in enumerate(params["stages"]):
        for b, block in enumerate(stage):
            pre = f"0.{4 + s_i}.{b}"
            for i in (1, 2, 3):
                sd[f"{pre}.conv{i}.weight"] = _conv_w(block[f"conv{i}"]["w"])
                put_bn(f"{pre}.bn{i}", block[f"bn{i}"])
            if "down_conv" in block:
                sd[f"{pre}.downsample.0.weight"] = _conv_w(block["down_conv"]["w"])
                put_bn(f"{pre}.downsample.1", block["down_bn"])
    head = params["head"]
    put_bn("1.2", head["bn1"])
    put_dense("1.4", head["fc1"])
    put_bn("1.6", head["bn2"])
    put_dense("1.8", head["fc2"])
    return sd


def classifier_state_dict_to_jax(sd: dict[str, torch.Tensor]) -> dict:
    """Reference ``ArtistClassifier`` state dict -> JAX classifier pytree of f32 numpy
    arrays (inverse of :func:`classifier_state_dict_from_jax`; JAX
    ``classifier_params_from_torch``, ``utils/torch_import.py:121``). The
    ``num_batches_tracked`` counters have no JAX leaf and are dropped."""

    def a(key: str) -> np.ndarray:
        return sd[key].detach().cpu().float().numpy().copy()

    def conv(key: str) -> dict:
        return {"w": np.ascontiguousarray(np.transpose(a(key), (2, 3, 1, 0)))}

    def bn(prefix: str) -> dict:
        return {k: a(f"{prefix}.{name}") for k, name in (
            ("gamma", "weight"), ("beta", "bias"), ("mean", "running_mean"),
            ("var", "running_var"))}

    def dense(prefix: str) -> dict:
        return {"w": np.ascontiguousarray(a(f"{prefix}.weight").T), "b": a(f"{prefix}.bias")}

    stages = []
    for s_i, (blocks, _, _) in enumerate(RESNET50_STAGES):
        stage = []
        for b in range(blocks):
            pre = f"0.{4 + s_i}.{b}"
            block = {}
            for i in (1, 2, 3):
                block[f"conv{i}"] = conv(f"{pre}.conv{i}.weight")
                block[f"bn{i}"] = bn(f"{pre}.bn{i}")
            if f"{pre}.downsample.0.weight" in sd:
                block["down_conv"] = conv(f"{pre}.downsample.0.weight")
                block["down_bn"] = bn(f"{pre}.downsample.1")
            stage.append(block)
        stages.append(stage)
    return {
        "stem": {"conv": conv("0.0.weight"), "bn": bn("0.1")},
        "stages": stages,
        "head": {"bn1": bn("1.2"), "fc1": dense("1.4"), "bn2": bn("1.6"), "fc2": dense("1.8")},
    }


def quantized_transformer_from_jax(qparams: dict):
    """JAX ``quantize_transformer`` pytree -> :class:`models.transformer_q.QuantizedTransformerNet`
    with the same int8 codes, ``sin`` scales and bf16 endpoint weights (on the CPU)."""
    from artist_style_transfer_tpu_torch.models.transformer_q import QuantizedTransformerNet

    def in_conv(p: dict) -> dict:
        return {"wq": _q_conv_w(p["wq"]), "gamma": _q(p["gamma"]), "beta": _q(p["beta"]),
                "sin": _q(p["sin"])}

    stem = {"w": _q_conv_w(qparams["stem"]["w"]),
            **{k: _q(qparams["stem"][k]) for k in ("b", "gamma", "beta")}}
    return QuantizedTransformerNet(
        stem=stem,
        encoder=[in_conv(p) for p in qparams["encoder"]],
        residual=[{k: in_conv(r[k]) for k in ("conv1", "conv2")} for r in qparams["residual"]],
        decoder=[in_conv(p) for p in qparams["decoder"]],
        output={"w": _q_conv_w(qparams["output"]["w"]), "b": _q(qparams["output"]["b"])},
    )


def quantized_classifier_from_jax(qparams: dict):
    """JAX ``quantize_classifier`` pytree -> :class:`models.resnet_q.QuantizedClassifier`
    with the same int8 codes, scales, folded biases and bf16 stem and head (on the CPU)."""
    from artist_style_transfer_tpu_torch.models.resnet_q import QuantizedClassifier

    def conv(p: dict) -> dict:
        return {"wq": _q_conv_w(p["wq"]), "sw": _q(p["sw"]), "b": _q(p["b"])}

    head = qparams["head"]
    return QuantizedClassifier(
        stem={"w": _q_conv_w(qparams["stem"]["w"]), "b": _q(qparams["stem"]["b"])},
        stages=[[{k: conv(v) for k, v in block.items()} for block in stage]
                for stage in qparams["stages"]],
        head={**{bn: {k: _q(head[bn][k]) for k in ("gamma", "beta", "mean", "var")}
                 for bn in ("bn1", "bn2")},
              **{fc: {"w": _q(np.asarray(head[fc]["w"]).T), "b": _q(head[fc]["b"])}
                 for fc in ("fc1", "fc2")}},
    )


def quantized_vgg16_from_jax(qparams: list[dict]):
    """JAX ``quantize_vgg16_loss`` list -> :class:`models.vgg.QuantizedVGG16Features` with
    the same int8 codes, scales and f32 biases, and the real convs in their dtype (f32
    or bf16) (on the CPU)."""
    from artist_style_transfer_tpu_torch.models.vgg import QuantizedVGG16Features

    real = [p for p in qparams if "wq" not in p]
    dtype = torch.bfloat16 if np.asarray(real[0]["w"]).dtype.name == "bfloat16" else torch.float32
    convs = [{"wq": _q_conv_w(p["wq"]), "sw": _q(p["sw"]), "b": _q(p["b"])} if "wq" in p
             else {"w": _conv_w(np.asarray(p["w"], np.float32)).to(dtype),
                   "b": _q(p["b"]).to(dtype)}
             for p in qparams]
    return QuantizedVGG16Features(convs, len(real))


def diff_model_state_dict_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """JAX ``init_diff_model`` pytree -> :class:`diffusion.unet.DiffModel` state dict.

    The module tree has the JAX tree's names: a path ``down/0/blocks/1/conv1/w`` is the
    key ``down.0.blocks.1.conv1.weight``. Conv ``w`` HWIO -> OIHW, dense ``w`` (I, O) ->
    (O, I), ``b`` -> ``bias``; ``class_emb`` and the GroupNorm ``gamma``/``beta`` as they
    are."""
    sd: dict[str, torch.Tensor] = {}

    def walk(node, key):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{key}.{k}" if key else k)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{key}.{i}")
        elif key.endswith(".w"):
            a = np.asarray(node)
            sd[key[:-2] + ".weight"] = _conv_w(a) if a.ndim == 4 else _t(a.T)
        elif key.endswith(".b"):
            sd[key[:-2] + ".bias"] = _t(node)
        else:
            sd[key] = _t(node)

    walk(params, "")
    return sd


def diff_model_state_dict_to_jax(sd: dict[str, torch.Tensor]) -> dict:
    """:class:`diffusion.unet.DiffModel` state dict -> JAX ``init_diff_model`` pytree of
    f32 numpy arrays (inverse of :func:`diff_model_state_dict_from_jax`): numbered
    modules become lists, as JAX's ``down`` and ``up`` are."""
    tree: dict = {}
    for key, v in sd.items():
        *parents, leaf = key.split(".")
        a = v.detach().cpu().float().numpy()
        if leaf == "weight":
            leaf, a = "w", np.transpose(a, (2, 3, 1, 0)) if a.ndim == 4 else a.T
        elif leaf == "bias":
            leaf = "b"
        node = tree
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = np.array(a, dtype=np.float32, order="C", copy=True)
    return numbered_to_lists(tree)


def numbered_to_lists(node):
    """A nested dict whose keys at some level are all digits -> lists at that level."""
    if not isinstance(node, dict):
        return node
    if node and all(k.isdigit() for k in node):
        return [numbered_to_lists(node[str(i)]) for i in range(len(node))]
    return {k: numbered_to_lists(v) for k, v in node.items()}
