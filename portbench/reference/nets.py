"""The plain reference of every net the benchmark runs, in plain PyTorch.

Written from the published descriptions, not from the program: the TransformerNet of
Johnson et al. (arXiv:1603.08155) as the reference repository's ``cnn.py`` builds it, VGG16
to relu4_3 (arXiv:1409.1556) with the Caffe mean, and the ResNet-50 (arXiv:1512.03385) with
the fastai head of 19 classes. Weights come in as plain dicts under the reference
state-dict keys; images are NHWC BGR [0, 255]. Nothing here imports the program, JAX or
the JAX package.

The int8 forms follow the int8 inference path that the configuration states: per-output-
channel symmetric weights, per-tensor activations rounded half to even and clipped to
``qmax`` (127; 7 for the int4 control), exact integer sums (codes convolved in float64,
where every sum is an integer far below 2**53), bf16 endpoints and a bf16 stream between
blocks. In the TransformerNet every int8 conv feeds an instance norm, which reads the
integer sum rounded to bf16 and takes one-pass f32 statistics, and the activation scales
are static, from one f32 forward over calibration images; in the ResNet-50 every BN is
folded into the conv before it, the scales are the absmax of each call over the batch,
and the sum is dequantized in f32 and stored in bf16.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

EPS = 1e-5
CAFFE_BGR_MEAN = (103.939, 116.779, 123.68)
TV_MEAN_RGB = (0.485, 0.456, 0.406)
TV_STD_RGB = (0.229, 0.224, 0.225)

# (kernel, stride, cin, cout): ConvBlock.0/2/4/6 of cnn.py
T_ENCODER = ((9, 1, 3, 32), (3, 2, 32, 64), (3, 2, 64, 128), (1, 1, 128, 128))
T_RESIDUAL = 5
T_CHANNELS = 128
# (kernel, stride, output_padding, cin, cout): DeconvBlock.0/2/4, padding k // 2
T_DECODER = ((1, 1, 0, 128, 128), (3, 2, 1, 128, 64), (3, 2, 1, 64, 32))
T_OUTPUT = (9, 1, 32, 3)  # DeconvBlock.6, no norm

# (torchvision index, cin, cout) of the 3x3 pad-1 convs to conv4_3
VGG_CONVS = ((0, 3, 64), (2, 64, 64), (5, 64, 128), (7, 128, 128), (10, 128, 256),
             (12, 256, 256), (14, 256, 256), (17, 256, 512), (19, 512, 512), (21, 512, 512))
VGG_POOL_BEFORE = (5, 10, 17)
VGG_TAPS = {2: "relu1_2", 7: "relu2_2", 14: "relu3_3", 21: "relu4_3"}

# (blocks, width, stride of the first block) of the four stages; out channels = 4 * width
RESNET_STAGES = ((3, 64, 1), (4, 128, 2), (6, 256, 2), (3, 512, 2))
HEAD_FEATURES, HEAD_HIDDEN, CLASSES = 4096, 512, 19


def _cl(t: torch.Tensor) -> torch.Tensor:
    """NCHW in the channels-last memory format, the layout of the images (NHWC) that every
    net here reads: each conv runs on channels-last operands and returns the same."""
    return t.contiguous(memory_format=torch.channels_last)


def _conv(x, w, b=None, stride=1, padding=0):
    return _cl(F.conv2d(_cl(x), _cl(w), b, stride=stride, padding=padding))


def _conv_t(x, w, b=None, stride=1, padding=0, output_padding=0):
    return _cl(F.conv_transpose2d(_cl(x), _cl(w), b, stride=stride, padding=padding,
                                  output_padding=output_padding))


def _bn_act(x, gamma, beta, relu):
    """Instance norm over (H, W) with the biased two-pass variance, then ReLU."""
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = (x - mean).square().mean(dim=(2, 3), keepdim=True)
    y = (x - mean) * torch.rsqrt(var + EPS) * gamma.view(1, -1, 1, 1) + beta.view(1, -1, 1, 1)
    return torch.relu(y) if relu else y


def _reflect(x, p):
    return F.pad(x, (p, p, p, p), mode="reflect") if p else x


def transformer(p: dict, x_nhwc: torch.Tensor, collect: list | None = None) -> torch.Tensor:
    """The f32 TransformerNet: NHWC BGR [0, 255] -> NHWC, unclipped. ``collect`` gathers
    the absmax of the input of every conv that the int8 form quantizes, in order."""
    x = x_nhwc.to(p["ConvBlock.0.conv_layer.weight"].dtype).permute(0, 3, 1, 2)

    def seen(t):
        if collect is not None:
            collect.append(t.abs().amax())

    for i, (k, s, _, _) in enumerate(T_ENCODER):
        pre = f"ConvBlock.{2 * i}"
        if i:
            seen(x)
        x = _conv(_reflect(x, k // 2), p[f"{pre}.conv_layer.weight"],
                  p[f"{pre}.conv_layer.bias"], stride=s)
        x = _bn_act(x, p[f"{pre}.norm_layer.weight"], p[f"{pre}.norm_layer.bias"], True)
    for r in range(T_RESIDUAL):
        h = x
        for j, relu in ((1, True), (2, False)):
            pre = f"ResidualBlock.{r}.conv{j}"
            seen(h)
            h = _conv(_reflect(h, 1), p[f"{pre}.conv_layer.weight"], p[f"{pre}.conv_layer.bias"])
            h = _bn_act(h, p[f"{pre}.norm_layer.weight"], p[f"{pre}.norm_layer.bias"], relu)
        x = h + x
    for i, (k, s, op, _, _) in enumerate(T_DECODER):
        pre = f"DeconvBlock.{2 * i}"
        seen(x)
        x = _conv_t(x, p[f"{pre}.conv_transpose.weight"], p[f"{pre}.conv_transpose.bias"],
                    stride=s, padding=k // 2, output_padding=op)
        x = _bn_act(x, p[f"{pre}.norm_layer.weight"], p[f"{pre}.norm_layer.bias"], True)
    x = _conv(_reflect(x, T_OUTPUT[0] // 2), p["DeconvBlock.6.conv_layer.weight"],
              p["DeconvBlock.6.conv_layer.bias"])
    return x.permute(0, 2, 3, 1)


def vgg16(p: dict, x_bgr_255: torch.Tensor, just_content: bool = False):
    """VGG16 to relu4_3 on NHWC BGR [0, 255] minus the Caffe mean: {tap: NHWC}, or relu2_2."""
    mean = torch.tensor(CAFFE_BGR_MEAN, dtype=x_bgr_255.dtype, device=x_bgr_255.device)
    x = (x_bgr_255 - mean).permute(0, 3, 1, 2)
    taps = {}
    for idx, _, _ in VGG_CONVS:
        if idx in VGG_POOL_BEFORE:
            x = F.max_pool2d(x, 2, 2)
        x = torch.relu(_conv(x, p[f"features.{idx}.weight"], p[f"features.{idx}.bias"], padding=1))
        if idx in VGG_TAPS:
            taps[VGG_TAPS[idx]] = x.permute(0, 2, 3, 1)
            if just_content and idx == 7:
                return taps["relu2_2"]
    return taps


def gram(f_nhwc: torch.Tensor) -> torch.Tensor:
    """F^T F / (C H W) per image: (N, C, C)."""
    n, h, w, c = f_nhwc.shape
    f = f_nhwc.reshape(n, h * w, c)
    return torch.bmm(f.transpose(1, 2), f) / float(c * h * w)


def _bn_frozen(x, p, pre):
    return F.batch_norm(x, p[f"{pre}.running_mean"], p[f"{pre}.running_var"], p[f"{pre}.weight"],
                        p[f"{pre}.bias"], False, 0.0, EPS)


def _resnet_blocks():
    """(state-dict prefix, stride, has a downsample) of every bottleneck, in order."""
    cin = 64
    for s, (blocks, width, stride) in enumerate(RESNET_STAGES):
        for b in range(blocks):
            st = stride if b == 0 else 1
            yield f"0.{4 + s}.{b}", st, st != 1 or cin != 4 * width
            cin = 4 * width


def classifier(p: dict, x_nhwc: torch.Tensor) -> torch.Tensor:
    """The f32 ResNet-50 + fastai head on NHWC RGB torchvision-normalized input: logits."""
    x = x_nhwc.permute(0, 3, 1, 2)
    x = torch.relu(_bn_frozen(_conv(x, p["0.0.weight"], stride=2, padding=3), p, "0.1"))
    x = F.max_pool2d(x, 3, 2, padding=1)
    for pre, stride, down in _resnet_blocks():
        h = torch.relu(_bn_frozen(_conv(x, p[f"{pre}.conv1.weight"]), p, f"{pre}.bn1"))
        h = torch.relu(_bn_frozen(_conv(h, p[f"{pre}.conv2.weight"], stride=stride, padding=1),
                                  p, f"{pre}.bn2"))
        h = _bn_frozen(_conv(h, p[f"{pre}.conv3.weight"]), p, f"{pre}.bn3")
        if down:
            x = _bn_frozen(_conv(x, p[f"{pre}.downsample.0.weight"], stride=stride), p,
                           f"{pre}.downsample.1")
        x = torch.relu(h + x)
    feats = torch.cat([x.amax(dim=(2, 3)), x.mean(dim=(2, 3))], dim=1)
    h = torch.relu(F.linear(_bn_frozen(feats, p, "1.2"), p["1.4.weight"], p["1.4.bias"]))
    return F.linear(_bn_frozen(h, p, "1.6"), p["1.8.weight"], p["1.8.bias"])


def eval_input(stylized_nhwc: torch.Tensor, crop: int) -> torch.Tensor:
    """The eval transform of a stylized batch: floor of the [0, 255] clip (the saved
    uint8), center crop, BGR -> RGB, /255, torchvision normalize. f32 NHWC."""
    x = torch.floor(stylized_nhwc.float().clamp(0.0, 255.0))
    h, w = x.shape[1], x.shape[2]
    top, left = (h - crop) // 2, (w - crop) // 2
    x = x[:, top:top + crop, left:left + crop].flip(-1) / 255.0
    mean = torch.tensor(TV_MEAN_RGB, device=x.device)
    std = torch.tensor(TV_STD_RGB, device=x.device)
    return (x - mean) / std


# ---------------------------------------------------------------- int8 forms


def quant(t: torch.Tensor, scale: torch.Tensor, qmax: int) -> torch.Tensor:
    """round(t / scale) (half to even) clipped to [-qmax, qmax], as float64 codes."""
    q = torch.round(t.float() * (1.0 / scale.float()))
    return q.clamp(-qmax, qmax).double()


def quant_weight(w: torch.Tensor, qmax: int, out_dim: int = 0):
    """Per-output-channel symmetric codes (float64) and scales (f32) of a conv weight."""
    dims = tuple(d for d in range(w.dim()) if d != out_dim)
    shape = [1] * w.dim()
    shape[out_dim] = -1
    sw = w.float().abs().amax(dim=dims).clamp_min(1e-30) / qmax
    wq = torch.round(w.float() / sw.view(shape)).clamp(-qmax, qmax)
    return wq.double(), sw


def calibrate(p: dict, images_nhwc: torch.Tensor, qmax: int) -> list[torch.Tensor]:
    """Static activation scales of the int8 TransformerNet: absmax / qmax of each
    quantized conv's input over one f32 forward of the calibration images."""
    seen: list[torch.Tensor] = []
    with torch.no_grad():
        transformer(p, images_nhwc, collect=seen)
    return [a.float() / qmax for a in seen]


def _in_bf16(acc, gamma, beta, relu):
    """Instance norm on a bf16 tensor with one-pass f32 statistics -> bf16."""
    x = acc.float()
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = (x.square().mean(dim=(2, 3), keepdim=True) - mean.square()).clamp_min(0.0)
    y = (x - mean) * torch.rsqrt(var + EPS) * gamma.view(1, -1, 1, 1) + beta.view(1, -1, 1, 1)
    return (torch.relu(y) if relu else y).to(torch.bfloat16)


def _bf16_endpoint(x, w, b):
    k = w.shape[-1]
    return _conv(_reflect(x, k // 2), w.to(torch.bfloat16)) + b.to(torch.bfloat16).view(1, -1, 1, 1)


def transformer_int8(p: dict, scales: list[torch.Tensor], x_nhwc: torch.Tensor,
                     qmax: int = 127) -> torch.Tensor:
    """The int8 TransformerNet: NHWC BGR [0, 255] -> NHWC bf16, unclipped."""
    x = x_nhwc.to(torch.bfloat16).permute(0, 3, 1, 2)
    it = iter(scales)

    def qconv(h, pre, w, transpose, stride, pad, op, relu):
        s = next(it)
        wq, _ = quant_weight(w, qmax, out_dim=1 if transpose else 0)
        hq = quant(h if transpose else _reflect(h, pad), s, qmax)
        if transpose:
            acc = _conv_t(hq, wq, stride=stride, padding=pad, output_padding=op)
        else:
            acc = _conv(hq, wq, stride=stride)
        acc = torch.round(acc).float().to(torch.bfloat16)
        return _in_bf16(acc, p[f"{pre}.norm_layer.weight"].float(),
                        p[f"{pre}.norm_layer.bias"].float(), relu)

    h = _bf16_endpoint(x, p["ConvBlock.0.conv_layer.weight"], p["ConvBlock.0.conv_layer.bias"])
    x = _in_bf16(h, p["ConvBlock.0.norm_layer.weight"].to(torch.bfloat16).float(),
                 p["ConvBlock.0.norm_layer.bias"].to(torch.bfloat16).float(), True)
    for i, (k, s, _, _) in enumerate(T_ENCODER[1:], start=1):
        pre = f"ConvBlock.{2 * i}"
        x = qconv(x, pre, p[f"{pre}.conv_layer.weight"], False, s, k // 2, 0, True)
    for r in range(T_RESIDUAL):
        pre = f"ResidualBlock.{r}"
        h = qconv(x, f"{pre}.conv1", p[f"{pre}.conv1.conv_layer.weight"], False, 1, 1, 0, True)
        x = qconv(h, f"{pre}.conv2", p[f"{pre}.conv2.conv_layer.weight"], False, 1, 1, 0,
                  False) + x
    for i, (k, s, op, _, _) in enumerate(T_DECODER):
        pre = f"DeconvBlock.{2 * i}"
        x = qconv(x, pre, p[f"{pre}.conv_transpose.weight"], True, s, k // 2, op, True)
    y = _bf16_endpoint(x, p["DeconvBlock.6.conv_layer.weight"], p["DeconvBlock.6.conv_layer.bias"])
    return y.permute(0, 2, 3, 1)


def _fold(p, conv, bn):
    inv = p[f"{bn}.weight"] / torch.sqrt(p[f"{bn}.running_var"] + EPS)
    w = p[f"{conv}.weight"].float() * inv.view(-1, 1, 1, 1)
    return w, p[f"{bn}.bias"] - p[f"{bn}.running_mean"] * inv


def quantize_classifier(p: dict, qmax: int = 127) -> dict:
    """The int8 classifier's parameters worked out from the f32 weights: BNs folded,
    folded weights quantized per output channel, the stem and the head in bf16."""
    q = {}
    w, b = _fold(p, "0.0", "0.1")
    q["stem"] = (w.to(torch.bfloat16), b.float())
    for pre, _, down in _resnet_blocks():
        convs = [(f"{pre}.conv{i}", f"{pre}.bn{i}") for i in (1, 2, 3)]
        if down:
            convs.append((f"{pre}.downsample.0", f"{pre}.downsample.1"))
        for conv, bn in convs:
            w, b = _fold(p, conv, bn)
            wq, sw = quant_weight(w, qmax)
            q[conv] = (wq, sw, b.float())
    for k in ("1.2", "1.6"):
        q[k] = {n: p[f"{k}.{n}"].to(torch.bfloat16).float()
                for n in ("weight", "bias", "running_mean", "running_var")}
    for k in ("1.4", "1.8"):
        q[k] = (p[f"{k}.weight"].to(torch.bfloat16), p[f"{k}.bias"].to(torch.bfloat16))
    return q


def classifier_int8(q: dict, x_nhwc: torch.Tensor, qmax: int = 127) -> torch.Tensor:
    """The int8 classifier: bf16 logits of NHWC RGB torchvision-normalized input."""
    x = x_nhwc.to(torch.bfloat16).permute(0, 3, 1, 2)
    w, b = q["stem"]
    x = torch.relu(_conv(x, w, stride=2, padding=3).float() + b.view(1, -1, 1, 1))
    x = F.max_pool2d(x.to(torch.bfloat16), 3, 2, padding=1)

    def conv(h, name, stride, pad):
        wq, sw, bias = q[name]
        s = h.float().abs().amax().clamp_min(1e-30) / qmax
        acc = torch.round(_conv(quant(h, s, qmax), wq, stride=stride, padding=pad))
        y = acc.float() * (s * sw).view(1, -1, 1, 1) + bias.view(1, -1, 1, 1)
        return y.to(torch.bfloat16)

    for pre, stride, down in _resnet_blocks():
        h = torch.relu(conv(x, f"{pre}.conv1", 1, 0))
        h = torch.relu(conv(h, f"{pre}.conv2", stride, 1))
        h = conv(h, f"{pre}.conv3", 1, 0)
        identity = conv(x, f"{pre}.downsample.0", stride, 0) if down else x
        x = torch.relu(h + identity)
    feats = torch.cat([x.amax(dim=(2, 3)), x.mean(dim=(2, 3))], dim=1)

    def bn1d(v, k):
        s = q[k]
        inv = torch.rsqrt(s["running_var"] + EPS) * s["weight"]
        return (v.float() * inv + (s["bias"] - s["running_mean"] * inv)).to(torch.bfloat16)

    def linear(v, k):
        w, b = q[k]
        return F.linear(v, w) + b

    h = torch.relu(linear(bn1d(feats, "1.2"), "1.4"))
    return linear(bn1d(h, "1.6"), "1.8")
