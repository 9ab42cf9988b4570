"""``diff_model``, a compact class-conditional UNet for epsilon prediction (counterpart
of the JAX ``diffusion/unet.py``).

Sinusoidal timestep embedding + learned class embedding -> per-resolution residual
blocks with GroupNorm(32) and FiLM (scale, shift) conditioning, 2x down- and
upsampling, and one self-attention block at the bottleneck. :class:`DiffModel` has the
JAX parameter tree's structure and names (``down[i].blocks[j].conv1``, ``mid1``,
``attn.qkv``, ``norm_out.gamma``, ...), so ``state_dict()`` keys are the JAX paths with
``.`` for ``/`` and ``weight``/``bias`` for ``w``/``b``
(:func:`utils.jax_params.diff_model_state_dict_from_jax`). Weights are torch-native
(OIHW convs, (O, I) dense layers); inside, tensors are NCHW in ``channels_last``.

``DiffModel.forward_rows`` runs the net on one band of each image's rows while the
other ranks of a 'space' line run the others (:mod:`parallel.spatial`), for training
over a ('data', 'space') mesh: every 3x3 conv (stride 1 or the stride-2 downsample) on
its gathered rows, zero-padded at the image's top and bottom; the 1x1 convs, FiLM (the
embedding is the same on every rank) and the nearest 2x upsampling on the band;
GroupNorm with the whole image's statistics; the bottleneck attention with this rank's
queries against every rank's keys and values. A conv gathers its rows from any split
and writes the even one, so the upsample conv re-bands the upsampled rows: at H = 24
over 4 ranks the bottleneck's bands of 2, 2, 1, 1 rows upsample to 4, 4, 2, 2, and the
conv's output, 3 each, is the split of the skip it meets.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from artist_style_transfer_tpu_torch.ops.conv import conv2d, linear
from artist_style_transfer_tpu_torch.parallel.spatial import (
    RowBands,
    all_rows_grad,
    conv_rows,
    group_norm_rows,
    on_band,
)

# channel multiplier per resolution; base width and blocks fixed for compactness
CHANNEL_MULTS = (1, 2, 4)
NUM_RES_BLOCKS = 2
GROUPS = 32
GROUP_NORM_EPS = 1e-5


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal embeddings, cos first, then sin (guided-diffusion convention)."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.to(torch.float32)[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def group_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               groups: int = GROUPS, eps: float = GROUP_NORM_EPS) -> torch.Tensor:
    """GroupNorm over ``min(groups, C)`` groups of consecutive channels (NCHW), biased
    variance, as JAX's reshape to (..., G, C/G) groups them."""
    return F.group_norm(x, min(groups, x.shape[1]), gamma, beta, eps)


class _GroupNorm(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(c))
        self.beta = nn.Parameter(torch.zeros(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm(x, self.gamma, self.beta)

    def forward_rows(self, x: torch.Tensor, rows: RowBands) -> torch.Tensor:
        return group_norm_rows(x, rows, self.gamma, self.beta, GROUPS, GROUP_NORM_EPS)


def _conv(x: torch.Tensor, m: nn.Conv2d, stride: int = 1) -> torch.Tensor:
    return conv2d(x, m.weight, m.bias, stride, m.kernel_size[0] // 2)


def _conv_rows(x: torch.Tensor, rows: RowBands, m: nn.Conv2d,
               stride: int = 1) -> tuple[torch.Tensor, RowBands]:
    """:func:`_conv` on this rank's band: a 1x1 conv on the band, a 3x3 one on its
    gathered rows, zero-padded (every conv of the UNet pads with zeros)."""
    k = m.kernel_size[0]
    if k == 1:
        return on_band(x, lambda t: _conv(t, m), m.out_channels), rows
    return conv_rows(x, rows, k, stride, k // 2,
                     lambda t: F.conv2d(t, m.weight, m.bias, stride=stride, padding=(0, k // 2)),
                     m.out_channels, pad_mode="zeros")


class ResBlock(nn.Module):
    """GroupNorm-SiLU-conv, FiLM from the embedding, GroupNorm-SiLU-conv, plus a 1x1
    projection of the input where the width changes."""

    def __init__(self, cin: int, cout: int, emb_dim: int):
        super().__init__()
        self.norm1 = _GroupNorm(cin)
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        self.emb = nn.Linear(emb_dim, 2 * cout)  # FiLM scale + shift
        self.norm2 = _GroupNorm(cout)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        self.skip = nn.Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        h = _conv(F.silu(self.norm1(x)), self.conv1)
        scale, shift = linear(F.silu(emb), self.emb.weight, self.emb.bias).chunk(2, dim=-1)
        h = self.norm2(h) * (1.0 + scale[:, :, None, None]) + shift[:, :, None, None]
        h = _conv(F.silu(h), self.conv2)
        if self.skip is not None:
            x = _conv(x, self.skip)
        return x + h

    def forward_rows(self, x: torch.Tensor, emb: torch.Tensor,
                     rows: RowBands) -> tuple[torch.Tensor, RowBands]:
        h, out = _conv_rows(F.silu(self.norm1.forward_rows(x, rows)), rows, self.conv1)
        scale, shift = linear(F.silu(emb), self.emb.weight, self.emb.bias).chunk(2, dim=-1)
        h = self.norm2.forward_rows(h, out) * (1.0 + scale[:, :, None, None]) \
            + shift[:, :, None, None]
        h, out = _conv_rows(F.silu(h), out, self.conv2)
        if self.skip is not None:
            x, _ = _conv_rows(x, rows, self.skip)
        return x + h, out


class Attention(nn.Module):
    """Single-head self-attention over the H*W positions, as JAX's two einsums."""

    def __init__(self, c: int):
        super().__init__()
        self.norm = _GroupNorm(c)
        self.qkv = nn.Conv2d(c, 3 * c, 1)
        self.proj = nn.Conv2d(c, c, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c, h, w = x.shape
        qkv = _conv(self.norm(x), self.qkv).flatten(2).transpose(1, 2)  # (n, hw, 3c)
        q, k, v = qkv.split(c, dim=-1)
        attn = torch.softmax(torch.matmul(q, k.transpose(1, 2)) / math.sqrt(c), dim=-1)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(n, c, h, w)
        return x + _conv(out.contiguous(memory_format=torch.channels_last), self.proj)

    def forward_rows(self, x: torch.Tensor, rows: RowBands) -> tuple[torch.Tensor, RowBands]:
        """This rank's queries (its band's positions) against every position's key and
        value, gathered from every rank; each key's and value's cotangent returns to
        its owner (:func:`parallel.spatial.all_rows_grad`)."""
        n, c, h, w = x.shape
        qkv, _ = _conv_rows(self.norm.forward_rows(x, rows), rows, self.qkv)
        q = qkv[:, :c].flatten(2).transpose(1, 2)  # (n, h_band * w, c)
        kv = all_rows_grad(qkv[:, c:], rows, dim=2).flatten(2).transpose(1, 2)  # (n, hw, 2c)
        k, v = kv.split(c, dim=-1)
        attn = torch.softmax(torch.matmul(q, k.transpose(1, 2)) / math.sqrt(c), dim=-1)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(n, c, h, w)
        proj, _ = _conv_rows(out.contiguous(memory_format=torch.channels_last), rows, self.proj)
        return x + proj, rows


class DiffModel(nn.Module):
    """The UNet under the JAX tree's names; :func:`init_diff_model` draws its weights."""

    def __init__(self, num_classes: int = 19, base_channels: int = 64, in_channels: int = 3):
        super().__init__()
        emb_dim = base_channels * 4
        self.time_mlp1 = nn.Linear(base_channels, emb_dim)
        self.time_mlp2 = nn.Linear(emb_dim, emb_dim)
        self.class_emb = nn.Parameter(torch.zeros(num_classes, emb_dim))
        self.conv_in = nn.Conv2d(in_channels, base_channels, 3, padding=1)
        chans = [base_channels * m for m in CHANNEL_MULTS]
        cin = base_channels
        skip_chans = [cin]
        self.down = nn.ModuleList()
        for level, c in enumerate(chans):
            down = nn.Module()
            down.blocks = nn.ModuleList()
            for _ in range(NUM_RES_BLOCKS):
                down.blocks.append(ResBlock(cin, c, emb_dim))
                cin = c
                skip_chans.append(cin)
            if level < len(chans) - 1:
                down.downsample = nn.Conv2d(cin, cin, 3, stride=2, padding=1)
                skip_chans.append(cin)
            self.down.append(down)
        self.mid1 = ResBlock(cin, cin, emb_dim)
        self.attn = Attention(cin)
        self.mid2 = ResBlock(cin, cin, emb_dim)
        self.up = nn.ModuleList()
        for level, c in reversed(list(enumerate(chans))):
            up = nn.Module()
            up.blocks = nn.ModuleList()
            for _ in range(NUM_RES_BLOCKS + 1):
                up.blocks.append(ResBlock(cin + skip_chans.pop(), c, emb_dim))
                cin = c
            if level > 0:
                up.upsample = nn.Conv2d(cin, cin, 3, padding=1)
            self.up.append(up)
        self.norm_out = _GroupNorm(base_channels)
        self.conv_out = nn.Conv2d(base_channels, in_channels, 3, padding=1)
        self.to(memory_format=torch.channels_last)

    @property
    def base_channels(self) -> int:
        return self.conv_in.out_channels

    def forward(self, x: torch.Tensor, t: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """Epsilon for ``x`` (NCHW, [-1, 1] scale) at timesteps ``t`` (N,) of classes ``y`` (N,)."""
        emb = timestep_embedding(t, self.base_channels)
        emb = linear(F.silu(linear(emb, self.time_mlp1.weight, self.time_mlp1.bias)),
                     self.time_mlp2.weight, self.time_mlp2.bias)
        emb = emb + self.class_emb[y]
        h = _conv(x, self.conv_in)
        skips = [h]
        for down in self.down:
            for block in down.blocks:
                h = block(h, emb)
                skips.append(h)
            if hasattr(down, "downsample"):
                h = _conv(h, down.downsample, stride=2)
                skips.append(h)
        h = self.mid2(self.attn(self.mid1(h, emb)), emb)
        for up in self.up:
            for block in up.blocks:
                h = block(torch.cat([h, skips.pop()], dim=1), emb)
            if hasattr(up, "upsample"):
                h = _conv(F.interpolate(h, scale_factor=2, mode="nearest"), up.upsample)
        return _conv(F.silu(self.norm_out(h)), self.conv_out)

    def forward_rows(self, x: torch.Tensor, t: torch.Tensor, y: torch.Tensor,
                     rows: RowBands) -> tuple[torch.Tensor, RowBands]:
        """:meth:`forward` on this rank's band of rows (``rows`` says whose band is which;
        the module docstring): this rank's band of epsilon, and its bands. Every rank of
        ``rows.mesh`` runs it at once, with the same ``t`` and ``y``."""
        emb = timestep_embedding(t, self.base_channels)
        emb = linear(F.silu(linear(emb, self.time_mlp1.weight, self.time_mlp1.bias)),
                     self.time_mlp2.weight, self.time_mlp2.bias)
        emb = emb + self.class_emb[y]
        h, rows = _conv_rows(x, rows, self.conv_in)
        skips = [(h, rows)]
        for down in self.down:
            for block in down.blocks:
                h, rows = block.forward_rows(h, emb, rows)
                skips.append((h, rows))
            if hasattr(down, "downsample"):
                h, rows = _conv_rows(h, rows, down.downsample, stride=2)
                skips.append((h, rows))
        h, rows = self.mid1.forward_rows(h, emb, rows)
        h, rows = self.attn.forward_rows(h, rows)
        h, rows = self.mid2.forward_rows(h, emb, rows)
        for up in self.up:
            for block in up.blocks:
                skip, _ = skips.pop()
                h, rows = block.forward_rows(torch.cat([h, skip], dim=1), emb, rows)
            if hasattr(up, "upsample"):
                # nearest 2x on the band: its rows double, and so do the bands' bounds
                h = h.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
                rows = RowBands(rows.mesh, 2 * rows.height, tuple(2 * a for a in rows.starts))
                h, rows = _conv_rows(h.contiguous(memory_format=torch.channels_last), rows,
                                     up.upsample)
        return _conv_rows(F.silu(self.norm_out.forward_rows(h, rows)), rows, self.conv_out)


# Layers JAX initializes at scale 1e-4 (near zero): every residual branch's last conv,
# the attention's projection and the output conv.
_NEAR_ZERO = ("conv2", "proj", "conv_out")


def init_diff_model(
    num_classes: int = 19,
    base_channels: int = 64,
    in_channels: int = 3,
    *,
    generator: torch.Generator,
    device: str | torch.device = "cpu",
) -> DiffModel:
    """Random weights drawn like JAX ``init_diff_model``: conv and dense weights
    U(-scale/sqrt(fan_in), scale/sqrt(fan_in)) with scale 1e-4 on ``conv2``,
    ``attn.proj`` and ``conv_out`` and 1 elsewhere, zero biases, GroupNorm at gamma 1
    and beta 0, ``class_emb`` N(0, 1) * 0.02.

    The draws run in module order on the CPU from ``generator``, so a seed gives the
    same net on every device (not JAX's draws: torch cannot reproduce ``jax.random``).
    """
    model = DiffModel(num_classes, base_channels, in_channels)
    with torch.no_grad():
        for name, m in model.named_modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                scale = 1e-4 if name.rsplit(".", 1)[-1] in _NEAR_ZERO else 1.0
                bound = scale / m.weight[0].numel() ** 0.5
                m.weight.copy_((torch.rand(m.weight.shape, generator=generator) * 2 - 1) * bound)
                m.bias.zero_()
        model.class_emb.copy_(torch.randn(model.class_emb.shape, generator=generator) * 0.02)
    return model.to(device)


def diff_model_apply(model: DiffModel, x: torch.Tensor, t: torch.Tensor,
                     y: torch.Tensor) -> torch.Tensor:
    """Predict epsilon for ``x``: NHWC, [-1, 1] scale, on the model's device; ``t`` (N,)
    int timesteps, ``y`` (N,) class ids. Returns NHWC f32 (JAX ``diff_model_apply``)."""
    if x.shape[1] % 4 or x.shape[2] % 4:
        # two stride-2 downsamples against nearest-2x upsamples: an indivisible
        # extent desyncs the skip shapes deep inside the net, so fail clearly.
        raise ValueError(
            f"diff_model_apply needs H, W divisible by 4, got {tuple(x.shape[1:3])}"
        )
    xc = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    return model(xc, t, y).permute(0, 2, 3, 1)
