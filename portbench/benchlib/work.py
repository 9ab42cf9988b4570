"""Operation counts from the nets' shapes, and the least time of a unit of work.

Every conv is listed with its geometry and the precision the configuration runs it in;
its operations are 2 a multiply-add, forward, data gradient and weight gradient alike (a
transpose conv counts its own multiply-adds, not the zeros of its dilated input). Grams
count the C(C+1)/2 distinct entries forward and the full product backward. Elementwise
work, norms and pools are not counted: a share of the peak made from these counts is a
share of the matrix work's least time.
"""

from __future__ import annotations

from typing import NamedTuple

from benchlib.peaks import gram_bound, op_seconds, qconv_bound
from reference import nets


class Conv(NamedTuple):
    name: str
    n: int
    cin: int
    cout: int
    k: int
    stride: int  # a transpose conv's stride is its lhs dilation
    h: int
    w: int
    ho: int
    wo: int
    transpose: bool
    precision: str  # "f32", "bf16" or "int8"

    @property
    def macs(self) -> float:
        if self.transpose:
            return float(self.n) * self.h * self.w * self.cin * self.cout * self.k * self.k
        return float(self.n) * self.ho * self.wo * self.cout * self.cin * self.k * self.k

    @property
    def flops(self) -> float:
        return 2.0 * self.macs


def _out(size: int, k: int, stride: int, pad: int) -> int:
    return (size + 2 * pad - k) // stride + 1


def transformer_convs(n: int, size: int, int8: bool) -> list[Conv]:
    """The 19 convs of the TransformerNet on n square images; with ``int8`` the 16
    interior ones in int8 and the two endpoints in bf16."""
    inner = "int8" if int8 else "f32"
    edge = "bf16" if int8 else "f32"
    convs, s = [], size
    for i, (k, st, cin, cout) in enumerate(nets.T_ENCODER):
        so = _out(s, k, st, k // 2)
        convs.append(Conv(f"enc{i}", n, cin, cout, k, st, s, s, so, so, False, edge if i == 0 else inner))
        s = so
    for r in range(2 * nets.T_RESIDUAL):
        c = nets.T_CHANNELS
        convs.append(Conv(f"res{r}", n, c, c, 3, 1, s, s, s, s, False, inner))
    for i, (k, st, op, cin, cout) in enumerate(nets.T_DECODER):
        so = (s - 1) * st - 2 * (k // 2) + k + op
        convs.append(Conv(f"dec{i}", n, cin, cout, k, st, s, s, so, so, st > 1, inner))
        s = so
    k, _, cin, cout = nets.T_OUTPUT
    convs.append(Conv("out", n, cin, cout, k, 1, s, s, s, s, False, edge))
    return convs


def vgg_convs(n: int, size: int) -> list[Conv]:
    convs, s = [], size
    for idx, cin, cout in nets.VGG_CONVS:
        if idx in nets.VGG_POOL_BEFORE:
            s //= 2
        convs.append(Conv(f"vgg{idx}", n, cin, cout, 3, 1, s, s, s, s, False, "f32"))
    return convs


def vgg_taps(n: int, size: int) -> list[tuple[int, int, int]]:
    """(n, HW, C) of the four taps."""
    sizes = {0: size, 2: size, 7: size // 2, 14: size // 4, 21: size // 8}
    chans = dict((idx, cout) for idx, _, cout in nets.VGG_CONVS)
    return [(n, sizes[idx] ** 2, chans[idx]) for idx in sorted(nets.VGG_TAPS)]


def classifier_convs(n: int, crop: int, int8: bool) -> list[Conv]:
    """The 53 convs of the ResNet-50 on n crops; with ``int8`` the 52 bottleneck convs in
    int8 and the stem in bf16."""
    inner = "int8" if int8 else "f32"
    s = _out(crop, 7, 2, 3)
    convs = [Conv("stem", n, 3, 64, 7, 2, crop, crop, s, s, False, "bf16" if int8 else "f32")]
    s = _out(s, 3, 2, 1)
    cin = 64
    for st, (blocks, width, stride) in enumerate(nets.RESNET_STAGES):
        for b in range(blocks):
            sd = stride if b == 0 else 1
            so = _out(s, 3, sd, 1)
            pre = f"s{st}b{b}"
            convs += [Conv(f"{pre}c1", n, cin, width, 1, 1, s, s, s, s, False, inner),
                      Conv(f"{pre}c2", n, width, width, 3, sd, s, s, so, so, False, inner),
                      Conv(f"{pre}c3", n, width, 4 * width, 1, 1, so, so, so, so, False, inner)]
            if b == 0:
                convs.append(Conv(f"{pre}down", n, cin, 4 * width, 1, sd, s, s, so, so, False, inner))
            cin, s = 4 * width, so
    return convs


def head_flops(n: int) -> float:
    return 2.0 * n * (nets.HEAD_FEATURES * nets.HEAD_HIDDEN + nets.HEAD_HIDDEN * nets.CLASSES)


def least_seconds(flops_by_precision: dict, peaks: dict) -> float:
    return sum(op_seconds(f, p, peaks) for p, f in flops_by_precision.items() if f)


def add_convs(acc: dict, convs: list[Conv], times: float = 1.0) -> dict:
    for c in convs:
        acc[c.precision] = acc.get(c.precision, 0.0) + times * c.flops
    return acc


def train_step_flops(batch: int, size: int) -> dict:
    """{precision: operations} of one f32 'cycle' step: the TransformerNet forward, data
    gradient (not of the first conv, whose input is data) and weight gradient; VGG16's
    forward and data gradient to relu4_3; the four Grams forward and backward."""
    t = transformer_convs(batch, size, False)
    acc = add_convs({}, t, 2.0)  # forward and weight gradient
    add_convs(acc, t[1:])  # data gradient
    add_convs(acc, vgg_convs(batch, size), 2.0)  # forward and data gradient
    for n, hw, c in vgg_taps(batch, size):
        acc["f32"] += float(n) * hw * c * (c + 1) + 2.0 * n * hw * c * c
    return acc


def k1_step_bound(batch: int, size: int, peaks: dict) -> tuple[float, int]:
    """(least seconds, launches) of K1 in one f32 step: one launch a tap."""
    taps = vgg_taps(batch, size)
    return sum(gram_bound(n, hw, c, 4, peaks) for n, hw, c in taps), len(taps)


def k2_bound(convs: list[Conv], out_bytes: int, peaks: dict) -> tuple[float, int]:
    """(least seconds, launches) of K2 over the int8 convs of a list."""
    q = [c for c in convs if c.precision == "int8"]
    return sum(qconv_bound(c.n, c.cin, c.h, c.w, c.cout, c.k, c.ho, c.wo,
                           c.stride if c.transpose else 1, out_bytes, peaks) for c in q), len(q)
