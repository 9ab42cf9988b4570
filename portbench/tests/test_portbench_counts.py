"""The operation and byte counts of the yardstick against hand counts and against
``FlopCounterMode`` on the reference at small shapes."""

from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchlib import inputs, work
from benchlib.peaks import PEAKS, gram_bound, op_seconds, qconv_bound
from reference import nets

P = PEAKS["H100 SXM"]
INIT = {"output_mean": 127.5, "output_std": 60.0}


def _total(convs):
    return sum(c.flops for c in convs)


def test_transformer_by_hand():
    # 16x16, one image: the encoder 16, 8, 4, 4; the residual convs at 4; the decoder 4 -> 16
    macs = (256 * 32 * 3 * 81 + 64 * 64 * 32 * 9 + 16 * 128 * 64 * 9 + 16 * 128 * 128
            + 10 * 16 * 128 * 128 * 9
            + 16 * 128 * 128 + 16 * 128 * 64 * 9 + 64 * 64 * 32 * 9 + 256 * 3 * 32 * 81)
    assert _total(work.transformer_convs(1, 16, False)) == 2 * macs == 65_634_304
    kinds = [c.precision for c in work.transformer_convs(1, 16, True)]
    assert kinds == ["bf16"] + ["int8"] * 16 + ["bf16"]


def _counted(fn) -> dict:
    with FlopCounterMode(display=False) as counter:
        fn()
    return {str(k): v for k, v in counter.get_flop_counts()["Global"].items()}


@pytest.mark.parametrize("size", [16, 32])
def test_forward_counts_match_flop_counter(size):
    t = inputs.transformer_weights(1, "cpu", INIT)
    v = inputs.vgg_weights(1, "cpu")
    c = inputs.classifier_weights(1, "cpu")
    x = torch.rand(2, size, size, 3) * 255
    with torch.no_grad():
        got = _counted(lambda: nets.transformer(t, x))
        assert sum(got.values()) == _total(work.transformer_convs(2, size, False))
        got = _counted(lambda: nets.vgg16(v, x))
        assert sum(got.values()) == _total(work.vgg_convs(2, size))
        got = _counted(lambda: nets.classifier(c, x))
        assert sum(got.values()) == _total(work.classifier_convs(2, size, False)) + work.head_flops(2)


def test_train_step_convs_match_flop_counter():
    t = {k: w.clone().requires_grad_(True) for k, w in inputs.transformer_weights(1, "cpu", INIT).items()}
    v = inputs.vgg_weights(1, "cpu")
    x = torch.rand(2, 32, 32, 3) * 255

    def step():
        gen = nets.transformer(t, x)
        feats = nets.vgg16(v, gen)
        sum(nets.gram(f).square().mean() for f in feats.values()).backward()

    got = _counted(step)
    convs = got["aten.convolution"] + got["aten.convolution_backward"]
    ours = work.train_step_flops(2, 32)["f32"]
    grams = sum(n * hw * c * (c + 1) + 2.0 * n * hw * c * c for n, hw, c in work.vgg_taps(2, 32))
    assert convs == ours - grams
    # the reference's Grams run the full product forward and two backward
    assert got["aten.bmm"] == sum(6 * n * hw * c * c for n, hw, c in work.vgg_taps(2, 32))


def test_bounds_by_hand():
    assert op_seconds(1e12, "f32", P) == pytest.approx(3e12 / 495e12)
    assert op_seconds(1e12, "int8", P) == pytest.approx(1e12 / 1979e12)
    # one image of 4 rows of 2 channels, f32: 24 operations, 32 bytes in and 16 out
    assert gram_bound(1, 4, 2, 4, P) == pytest.approx(48 / 3.35e12)
    # a 3x3 32 -> 32 int8 conv at 4x4: 147,456 MACs; 512 + 9,216 + 1,024 bytes
    assert qconv_bound(1, 32, 4, 4, 32, 3, 4, 4, 1, 2, P) == pytest.approx(10752 / 3.35e12)
    big = qconv_bound(64, 512, 64, 64, 512, 3, 64, 64, 1, 2, P)
    assert big == pytest.approx(2 * 64 * 64 * 64 * 512 * 512 * 9 / 1979e12)
    # a transpose conv counts its own MACs: each input pixel times k^2 * C_out
    convs = work.transformer_convs(1, 16, True)
    dec = [c for c in convs if c.transpose]
    assert [c.macs for c in dec] == [16 * 128 * 64 * 9, 64 * 64 * 32 * 9]


def test_kernel_launches_a_unit():
    assert work.k1_step_bound(16, 224, P)[1] == 4
    assert work.k2_bound(work.transformer_convs(4, 1024, True), 2, P)[1] == 16
    assert work.k2_bound(work.classifier_convs(4, 256, True), 2, P)[1] == 52
