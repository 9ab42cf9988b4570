"""The int8 TransformerNet's fused instance norm (``csrc/in_q8.cu``) on the CPU: its plain
version against the composition the quantized forward ran before it was fused, the
kernel wrapper's refusals, and ``QuantizedTransformerNet.forward`` bit for bit against
that composition.

The kernel itself runs only on the card; ``chip_smoke.py`` (phase ``in_q8``) holds it
against the plain version there. Every comparison here is exact: the plain version is
the same PyTorch ops in the same order.
"""

import importlib
import itertools

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from artist_style_transfer_tpu_torch.models import transformer_q as tq
from artist_style_transfer_tpu_torch.models.transformer import TransformerNet
from artist_style_transfer_tpu_torch.ops.cuda import build, in_q8_kernel
from artist_style_transfer_tpu_torch.ops.pad import reflect_pad_hw
from artist_style_transfer_tpu_torch.ops.qconv import conv_i8, quant_i8
from tests.test_torch_data import one_torch_thread  # noqa: F401

SHAPE = (2, 16, 6, 5)  # N, C, H, W


def channels_last(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous(memory_format=torch.channels_last)


def accumulator(dtype: torch.dtype, seed: int = 0) -> torch.Tensor:
    """A conv accumulator as K2 leaves it: int32 sums, or their bf16."""
    rng = np.random.default_rng(seed)
    acc = torch.as_tensor(rng.integers(-40000, 90000, SHAPE, dtype=np.int32))
    return channels_last(acc if dtype == torch.int32 else acc.float().to(torch.bfloat16))


def norm_params(seed: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    rng = np.random.default_rng(seed)
    c = SHAPE[1]
    return (torch.as_tensor(rng.normal(1.0, 0.3, c), dtype=torch.float32),
            torch.as_tensor(rng.normal(0.0, 0.5, c), dtype=torch.float32))


def bf16_tensor(shape, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.normal(0.0, 1.0, shape), dtype=torch.float32).to(torch.bfloat16)


@pytest.mark.parametrize("accum,relu,with_residual,with_codes,stream", itertools.product(
    (torch.int32, torch.bfloat16), (True, False), (False, True), (False, True), (False, True)))
def test_plain_fused_op_is_the_composition(accum, relu, with_residual, with_codes, stream):
    acc = accumulator(accum)
    gamma, beta = norm_params()
    residual = channels_last(bf16_tensor(SHAPE, 3)) if with_residual else None
    sin = torch.tensor(0.0131, dtype=torch.float32)
    inv_s = 1.0 / sin.float() if with_codes else None

    y = tq._in_act(acc, gamma, beta, relu)
    if residual is not None:
        y = y + residual
    codes = quant_i8(y, sin)

    for fn in (tq.in_act_q8_plain, tq.in_act_q8):
        got_stream, got_codes = fn(acc, gamma, beta, relu, residual=residual, inv_s=inv_s,
                                   stream=stream)
        if stream:
            assert got_stream.dtype == torch.bfloat16
            assert torch.equal(got_stream.view(torch.int16), y.view(torch.int16))
            assert got_stream.is_contiguous(memory_format=torch.channels_last)
        else:
            assert got_stream is None
        if with_codes:
            assert got_codes.dtype == torch.int8 and torch.equal(got_codes, codes)
            assert got_codes.is_contiguous(memory_format=torch.channels_last)
            assert got_codes.abs().max() <= 127 and got_codes.float().std() > 1
        else:
            assert got_codes is None


def _args(**change) -> dict:
    """Arguments the kernel wrapper takes, on the CPU, with ``change`` applied."""
    gamma, beta = norm_params()
    args = dict(acc=accumulator(torch.bfloat16), gamma=gamma, beta=beta, relu=True,
                residual=channels_last(bf16_tensor(SHAPE, 3)), inv_s=torch.tensor(50.0),
                stream=True)
    args.update(change)
    return args


REFUSALS = {
    "f32 accumulator": (dict(acc=channels_last(torch.zeros(SHAPE))), "int32 or bfloat16"),
    "int8 accumulator": (dict(acc=channels_last(torch.zeros(SHAPE, dtype=torch.int8))),
                         "int32 or bfloat16"),
    "NCHW layout": (dict(acc=torch.zeros(SHAPE, dtype=torch.bfloat16)), "channels_last"),
    "3-d accumulator": (dict(acc=torch.zeros(SHAPE[:3], dtype=torch.bfloat16)), "channels_last"),
    "C not a multiple of 8": (dict(acc=channels_last(torch.zeros((2, 12, 6, 5),
                                                                 dtype=torch.int32)),
                                   gamma=torch.ones(12), beta=torch.zeros(12), residual=None),
                              "multiple of 8"),
    "empty image": (dict(acc=channels_last(torch.zeros((2, 16, 0, 5), dtype=torch.bfloat16)),
                         residual=None), "non-empty"),
    "gamma's length": (dict(gamma=torch.ones(8)), "gamma"),
    "bf16 beta": (dict(beta=torch.zeros(SHAPE[1], dtype=torch.bfloat16)), "beta"),
    "f64 gamma": (dict(gamma=torch.ones(SHAPE[1], dtype=torch.float64)), "gamma"),
    "residual's shape": (dict(residual=channels_last(bf16_tensor((2, 16, 6, 4), 3))),
                         "residual"),
    "residual's dtype": (dict(residual=channels_last(torch.zeros(SHAPE))), "residual"),
    "residual's layout": (dict(residual=bf16_tensor(SHAPE, 3)), "residual"),
    "inv_s's dtype": (dict(inv_s=torch.tensor(50.0, dtype=torch.float64)), "inv_s"),
    "inv_s's length": (dict(inv_s=torch.ones(2)), "inv_s"),
    "nothing to write": (dict(inv_s=None, stream=False), "nothing to write"),
    "a CPU tensor": (dict(), "CUDA tensors"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_kernel_wrapper_refuses(case):
    change, words = REFUSALS[case]
    with pytest.raises(ValueError, match=words):
        in_q8_kernel.in_q8_cuda(**_args(**change))


def test_kernel_module_imports_without_building(monkeypatch):
    def refuse():
        raise AssertionError("the kernel library was built at import")

    monkeypatch.setattr(build, "build", refuse)
    module = importlib.reload(in_q8_kernel)
    assert module.LAUNCHES == 0 and callable(module.in_q8_cuda)


# --- the quantized forward, bit for bit against the composition it replaced --------------


def composed_forward(qmodel: tq.QuantizedTransformerNet, x_nhwc: torch.Tensor,
                     accum: torch.dtype) -> torch.Tensor:
    """The forward as separate passes: each conv's input quantized by ``quant_i8``, its
    accumulator through ``_in_act``, the residual adds on the bf16 stream."""
    def conv(layer, x, relu):
        y = conv_i8(quant_i8(x, layer.sin), layer.wq, layer.stride, layer.padding,
                    layer.dilation, layer.pad_mode, out=accum)
        return tq._in_act(y, layer.gamma, layer.beta, relu)

    x = channels_last(x_nhwc.to(torch.bfloat16).permute(0, 3, 1, 2))
    stem = F.conv2d(reflect_pad_hw(x, 4), qmodel.stem_w) + qmodel.stem_b.view(1, -1, 1, 1)
    xr = tq._in_act(stem, qmodel.stem_gamma.float(), qmodel.stem_beta.float(), True)
    for layer in qmodel.encoder:
        xr = conv(layer, xr, True)
    for block in qmodel.residual:
        xr = conv(block["conv2"], conv(block["conv1"], xr, True), False) + xr
    for layer in qmodel.decoder:
        xr = conv(layer, xr, True)
    out = F.conv2d(reflect_pad_hw(xr, 4), qmodel.out_w) + qmodel.out_b.view(1, -1, 1, 1)
    return out.permute(0, 2, 3, 1)


@pytest.fixture(scope="module")
def small_qmodel():
    torch.manual_seed(0)
    model = TransformerNet()
    calib = (np.random.default_rng(7).random((2, 24, 20, 3)) * 255).astype(np.float32)
    x = torch.as_tensor((np.random.default_rng(8).random((2, 24, 20, 3)) * 255)
                        .astype(np.float32))
    return tq.quantize_transformer(model, calib), x


@pytest.mark.parametrize("accum", [torch.int32, torch.bfloat16])
def test_forward_is_the_composition_bit_for_bit(small_qmodel, accum):
    qmodel, x = small_qmodel
    got = qmodel(x, accum=accum)
    want = composed_forward(qmodel, x, accum)
    assert got.dtype == torch.bfloat16 and got.float().abs().mean() > 0
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


def test_forward_makes_one_fused_call_an_instance_norm(small_qmodel, monkeypatch):
    """17 instance norms (the stem and 16 int8 convs): the codes for every int8 conv, the
    bf16 stream for the trunk input, the residual blocks read by a later add and the
    last decoder layer."""
    qmodel, x = small_qmodel
    calls, real = [], tq.in_act_q8

    def recording(acc, gamma, beta, relu, residual=None, inv_s=None, stream=True):
        calls.append((relu, residual is not None, inv_s is not None, stream))
        return real(acc, gamma, beta, relu, residual, inv_s, stream)

    monkeypatch.setattr(tq, "in_act_q8", recording)
    qmodel(x)
    enc = [(True, False, True, False)] * 3  # the stem and encoder convs 2-3
    trunk = [(True, False, True, True)]
    res = [(True, False, True, False), (False, True, True, True)] * 4 + [
        (True, False, True, False), (False, True, True, False)]
    dec = [(True, False, True, False)] * 2 + [(True, False, False, True)]
    assert calls == enc + trunk + res + dec
    assert sum(inv for *_, inv, _ in calls) == 16  # the int8 convs' inputs
