"""The int8 inference slice of the PyTorch port held against the JAX package on the CPU:
the quantizers, the int8 convolution (the plain version of kernel K2), the quantized
TransformerNet and ResNet-50, ``stylize_int8``, the int8 eval pipeline and
``inference.py --quantize``.

Inputs come from numpy seeds, the golden TransformerNet and its content image.
Tolerances:

- codes, scales and the int32 conv: exactly equal to JAX's (the same arithmetic:
  round half to even, an exact integer sum); the bf16 epilogue bit for bit; the
  dequant epilogue within one bf16 ulp (XLA may fuse the multiply and the add);
- the calibrated ``sin`` scales within 1e-5 relative: they are absmaxes of two
  f32 forwards whose convs sum in other orders;
- the int8 TransformerNet on shared qparams: > 55 dB PSNR against JAX (both
  accumulator dtypes), > 45 dB against the port's f32 forward and > 35 dB
  against the committed golden (``tests/test_quant.py:73,89,103``);
- the int8 classifier on shared qparams: logits within 0.02 std of JAX's int8
  logits with the same argmax, features within 0.02 of JAX's largest (a few bf16
  ulps); within 0.1 std of the port's real logits and features within 0.05 of
  their largest magnitude (``tests/test_resnet_q.py:69,83``).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from artist_style_transfer_tpu.models import resnet_q as jresnet_q
from artist_style_transfer_tpu.models import transformer_q as jtransformer_q
from artist_style_transfer_tpu.models.resnet import init_classifier_params
from artist_style_transfer_tpu.ops import qconv as jqconv
from artist_style_transfer_tpu.ops.pad import reflect_pad_hw as jreflect_pad_hw
from artist_style_transfer_tpu_torch import inference
from artist_style_transfer_tpu_torch.infer.evaluate import (
    evaluate_with_classifier,
    quantize_eval_pipeline,
)
from artist_style_transfer_tpu_torch.infer.stylize import load_transfer_params, stylize_int8
from artist_style_transfer_tpu_torch.models.resnet import (
    ARTISTS_19,
    ResNet50Classifier,
    init_classifier,
)
from artist_style_transfer_tpu_torch.models.resnet_q import (
    QuantizedClassifier,
    classifier_apply_int8,
    classifier_is_quantized,
    quantize_classifier,
)
from artist_style_transfer_tpu_torch.models.transformer import init_transformer
from artist_style_transfer_tpu_torch.models.transformer_q import (
    QuantizedTransformerNet,
    calibrate_transformer,
    quantize_transformer,
    transformer_apply_int8,
)
from artist_style_transfer_tpu_torch.ops import qconv
from artist_style_transfer_tpu_torch.utils.images import read_png
from artist_style_transfer_tpu_torch.utils.jax_params import (
    classifier_state_dict_from_jax,
    quantized_classifier_from_jax,
    quantized_transformer_from_jax,
)
from tests.test_torch_classifier import numpy_params
from tests.test_torch_data import one_torch_thread  # noqa: F401

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")


def psnr(a, b) -> float:
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return float(10.0 * np.log10(255.0**2 / mse)) if mse > 0 else float("inf")


def to_u8(out) -> np.ndarray:
    """The save-time clip of a stylized NHWC batch (reference inference.py:116)."""
    return np.clip(np.asarray(out, np.float32), 0, 255).astype(np.uint8)


def nchw(a: np.ndarray) -> torch.Tensor:
    """NHWC numpy -> NCHW tensor in channels_last (the port's layout)."""
    return torch.from_numpy(np.array(a)).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


def oihw(w_hwio: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(w_hwio)).permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).float().numpy()


# --- the quantizers -----------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantizers_give_jax_codes_and_scales(dtype):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 6, 7, 32)) * 3).astype(np.float32)
    x[0, 0, 0, :4] = [0.5, 1.5, -2.5, 2.5]  # ties, to hold the half-to-even rounding
    w = (rng.standard_normal((3, 3, 32, 16)) * 0.1).astype(np.float32)
    xj = jnp.asarray(x, dtype)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    s_j, s_t = jqconv.absmax_scale(xj), qconv.absmax_scale(xt)
    assert float(s_j) == s_t.item()
    np.testing.assert_array_equal(np.asarray(jqconv.quant_i8(xj, s_j)),
                                  qconv.quant_i8(xt, s_t).numpy())
    ties = qconv.quant_i8(torch.tensor([0.5, 1.5, -2.5, 2.5]), torch.tensor(1.0))
    assert ties.tolist() == [0, 2, -2, 2]
    wq_j, sw_j = jqconv.quant_weight(jnp.asarray(w, dtype))
    wq_t, sw_t = qconv.quant_weight(oihw(w).to(getattr(torch, dtype)))
    np.testing.assert_array_equal(np.asarray(wq_j), np.transpose(wq_t.numpy(), (2, 3, 1, 0)))
    np.testing.assert_array_equal(np.asarray(sw_j), sw_t.numpy())
    assert wq_t.dtype == torch.int8 and wq_t.is_contiguous(memory_format=torch.channels_last)


# --- the int8 conv: the plain version of K2 against JAX's XLA conv -------------------

# (name, N, H, C_in, C_out, k, stride, (lo, hi), lhs dilation, pad mode)
CONVS = [
    ("reflect_3x3", 2, 9, 32, 16, 3, 1, (1, 1), 1, "reflect"),
    ("reflect_3x3_s2", 2, 9, 32, 16, 3, 2, (1, 1), 1, "reflect"),
    ("zeros_3x3_s2", 2, 10, 64, 24, 3, 2, (1, 1), 1, "zeros"),
    ("transposed_3x3", 2, 5, 32, 16, 3, 1, (1, 2), 2, "zeros"),
    ("transposed_1x1", 1, 6, 32, 8, 1, 1, (0, 0), 1, "zeros"),
    ("zeros_1x1_s2", 2, 9, 64, 16, 1, 2, (0, 0), 1, "zeros"),
]


def conv_case(n, h, cin, cout, k, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.integers(-127, 128, (n, h, h + 1, cin)).astype(np.int8)
    w = rng.integers(-127, 128, (k, k, cin, cout)).astype(np.int8)
    return x, w


def jax_conv_i8(x, w, stride, pads, dil, mode, accum=jnp.int32):
    lo, hi = pads
    xj = jnp.asarray(x)
    if mode == "reflect":
        xj, pads2 = jreflect_pad_hw(xj, lo), ((0, 0), (0, 0))
    else:
        pads2 = ((lo, hi), (lo, hi))
    return np.asarray(jtransformer_q._conv_i8(xj, jnp.asarray(w), stride, pads2,
                                              (dil, dil) if dil > 1 else None, accum))


@pytest.mark.parametrize("case", CONVS, ids=[c[0] for c in CONVS])
def test_conv_i8_plain_equals_jax_int32_and_bf16(case):
    _, n, h, cin, cout, k, stride, pads, dil, mode = case
    x, w = conv_case(n, h, cin, cout, k)
    got = qconv.conv_i8(nchw(x), oihw(w), stride, pads, dil, mode)
    ref = jax_conv_i8(x, w, stride, pads, dil, mode)
    assert got.dtype == torch.int32 and got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), ref)
    got_bf16 = qconv.conv_i8(nchw(x), oihw(w), stride, pads, dil, mode, out=torch.bfloat16)
    ref_bf16 = jax_conv_i8(x, w, stride, pads, dil, mode, accum=jnp.bfloat16)
    np.testing.assert_array_equal(got_bf16.permute(0, 2, 3, 1).contiguous().view(torch.int16)
                                  .numpy().view(np.uint16), ref_bf16.view(np.uint16))


def test_conv_i8_plain_is_exact_where_f32_is_not():
    """127^2 * 4608 > 2^24: an f32 conv of the codes would round; the plain version does not."""
    x = np.full((1, 3, 3, 512), 127, np.int8)
    w = np.full((3, 3, 512, 2), -127, np.int8)
    w[0, 0, 0, 1] = -126
    got = qconv.conv_i8(nchw(x), oihw(w), 1, 0).flatten().tolist()
    assert got == [-127 * 127 * 4608, -127 * 127 * 4608 + 127]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("stride,padding", [(1, 1), (2, 1), (2, 0)])
def test_conv2d_frozen_int8_dequant_matches_jax(dtype, stride, padding):
    rng = np.random.default_rng(2)
    k = 3 if padding else 1
    x = rng.standard_normal((2, 8, 8, 32)).astype(np.float32)
    w = (rng.standard_normal((k, k, 32, 16)) * 0.1).astype(np.float32)
    b = rng.standard_normal(16).astype(np.float32)
    wq, sw = jqconv.quant_weight(jnp.asarray(w))
    ref = np.asarray(jqconv.conv2d_frozen_int8(jnp.asarray(x, dtype), wq, sw, jnp.asarray(b),
                                               padding, stride).astype(jnp.float32))
    got = qconv.conv2d_frozen_int8(nchw(x).to(getattr(torch, dtype)), oihw(np.asarray(wq)),
                                   torch.from_numpy(np.asarray(sw)), torch.from_numpy(b),
                                   padding, stride)
    assert got.dtype == getattr(torch, dtype)
    got = nhwc(got)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)  # one bf16 ulp
    assert np.all(np.abs(got - ref) <= ulp)


def test_conv_i8_refusals_and_no_grad():
    x, w = conv_case(1, 5, 32, 8, 3)
    xt, wt = nchw(x), oihw(w)
    with pytest.raises(ValueError, match="int8"):
        qconv.conv_i8(xt.float(), wt)
    with pytest.raises(ValueError, match="pad_mode"):
        qconv.conv_i8(xt, wt, padding=1, pad_mode="edge")
    with pytest.raises(ValueError, match="dilated"):
        qconv.conv_i8(xt, wt, padding=1, lhs_dilation=2, pad_mode="reflect")
    with pytest.raises(ValueError, match="under the size"):
        qconv.conv_i8(xt, wt, padding=5, pad_mode="reflect")
    with pytest.raises(ValueError, match="out must be"):
        qconv.conv_i8(xt, wt, out=torch.float16)
    wq, sw = qconv.quant_weight(torch.randn(8, 32, 3, 3))
    xr = torch.randn(1, 32, 5, 5, requires_grad=True)
    y = qconv.conv2d_frozen_int8(xr, wq, sw, None)  # the STE data gradient flows
    y.square().sum().backward()
    assert xr.grad.shape == xr.shape and torch.isfinite(xr.grad).all() and xr.grad.abs().max() > 0
    with torch.no_grad():  # without autograd the forward runs
        assert torch.equal(qconv.conv2d_frozen_int8(xr, wq, sw, None), y.detach())


# --- the quantized TransformerNet on the golden net -----------------------------------


@pytest.fixture(scope="module")
def golden():
    from artist_style_transfer_tpu.infer.stylize import load_transfer_params as jax_load

    content = read_png(os.path.join(GOLDENS, "content_landscape_256.png"))
    jparams = jax_load(os.path.join(GOLDENS, "golden_transfer.pth"))
    # Random calibration content, not the test image, as tests/test_quant.py draws it.
    calib = (np.random.default_rng(7).random((2, 128, 128, 3)) * 255).astype(np.float32)
    jq = jtransformer_q.quantize_transformer(jparams, jnp.asarray(calib))
    return {
        "x": content[None].astype(np.float32),
        "jparams": jparams,
        "calib": calib,
        "jq": jq,
        "jq_np": jax.tree.map(np.asarray, jq),
        "model": load_transfer_params(os.path.join(GOLDENS, "golden_transfer.pth"), "cpu"),
        "golden": read_png(os.path.join(GOLDENS, "golden_stylized.png")),
    }


def int8_codes(qmodel) -> dict:
    return {k: v for k, v in qmodel.state_dict().items() if v.dtype == torch.int8}


def test_quantize_transformer_matches_jax_codes_and_scales(golden):
    from_jax = quantized_transformer_from_jax(golden["jq_np"])
    ours = quantize_transformer(golden["model"], golden["calib"])
    assert isinstance(ours, QuantizedTransformerNet)
    codes, codes_jax = int8_codes(ours), int8_codes(from_jax)
    assert len(codes) == 16 and codes.keys() == codes_jax.keys()
    for k in codes:
        assert torch.equal(codes[k], codes_jax[k]), k
    sd, sd_jax = ours.state_dict(), from_jax.state_dict()
    assert sd.keys() == sd_jax.keys()
    for k in sd:
        if k.endswith("sin"):
            torch.testing.assert_close(sd[k], sd_jax[k], rtol=1e-5, atol=0)
        elif sd[k].dtype != torch.int8:  # gamma, beta, the bf16 endpoints: copied exactly
            assert sd[k].dtype == sd_jax[k].dtype and torch.equal(sd[k], sd_jax[k]), k
    # Given JAX's scales, the port's quantization is JAX's exactly.
    jscales = jax.tree.map(lambda a: torch.tensor(np.asarray(a)),
                           jtransformer_q.calibrate_transformer(golden["jparams"],
                                                                jnp.asarray(golden["calib"])))
    jscales["encoder"][0] = None
    exact = quantize_transformer(golden["model"], jscales).state_dict()
    assert all(torch.equal(exact[k], sd_jax[k]) for k in sd_jax)
    # And calibrate_transformer gives those scales up to the forwards' rounding.
    ours_scales = calibrate_transformer(golden["model"], golden["calib"])
    flat, flat_jax = (jax.tree.leaves(t, is_leaf=torch.is_tensor) for t in (ours_scales, jscales))
    assert len(flat) == len(flat_jax) == 16
    for a, b in zip(flat, flat_jax):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=0)


@pytest.mark.parametrize("accum", ["int32", "bfloat16"])
def test_transformer_int8_matches_jax_and_the_bars(golden, accum):
    qmodel = quantized_transformer_from_jax(golden["jq_np"])
    ref = np.asarray(jax.jit(lambda q, x: jtransformer_q.transformer_apply_int8(
        q, x, accum=getattr(jnp, accum)))(golden["jq"], jnp.asarray(golden["x"])).astype(
        jnp.float32))
    with torch.no_grad():
        out = transformer_apply_int8(qmodel, torch.from_numpy(golden["x"]),
                                     accum=getattr(torch, accum))
        real = golden["model"](torch.from_numpy(golden["x"])).numpy()
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == golden["x"].shape
    out = out.float().numpy()
    assert psnr(to_u8(out), to_u8(ref)) > 55.0
    assert psnr(to_u8(out), to_u8(real)) > 45.0
    assert psnr(to_u8(out)[0], golden["golden"]) > 35.0


def test_stylize_int8_is_the_clipped_bf16_forward(golden):
    qmodel = quantize_transformer(golden["model"], golden["calib"])
    x_u8 = to_u8(golden["x"][:, :64, :96])
    out = stylize_int8(qmodel, x_u8, device="cpu")
    with torch.no_grad():
        raw = qmodel(torch.from_numpy(x_u8), accum=torch.bfloat16)
    assert out.dtype == torch.uint8 and tuple(out.shape) == x_u8.shape
    assert torch.equal(out, raw.float().clamp(0, 255).to(torch.uint8))
    assert torch.equal(stylize_int8(qmodel, x_u8, clip=False, device="cpu"), raw)
    with pytest.raises(ValueError, match="not on"):
        stylize_int8(qmodel, x_u8, device="meta")


# --- the quantized ResNet-50 -----------------------------------------------------------


@pytest.fixture(scope="module")
def classifier_setup():
    params = numpy_params(init_classifier_params, 0)
    jq = jresnet_q.quantize_classifier(jax.tree.map(jnp.asarray, params))
    x = np.random.default_rng(1).standard_normal((2, 64, 64, 3)).astype(np.float32)
    real = ResNet50Classifier()
    real.load_state_dict(classifier_state_dict_from_jax(params))
    apply = jax.jit(jresnet_q.classifier_apply_int8, static_argnames=("return_features",))
    return {
        "x": x,
        "real": real,
        "jq_np": jax.tree.map(np.asarray, jq),
        "jax_logits": np.asarray(apply(jq, jnp.asarray(x)), np.float32),
        "jax_features": np.asarray(apply(jq, jnp.asarray(x), return_features=True), np.float32),
    }


def test_quantize_classifier_matches_jax_codes(classifier_setup):
    ours = quantize_classifier(classifier_setup["real"])
    from_jax = quantized_classifier_from_jax(classifier_setup["jq_np"])
    assert classifier_is_quantized(ours) and not classifier_is_quantized(classifier_setup["real"])
    codes, codes_jax = int8_codes(ours), int8_codes(from_jax)
    assert len(codes) == 52 and codes.keys() == codes_jax.keys()
    for k in codes:
        assert torch.equal(codes[k], codes_jax[k]), k
    sd, sd_jax = ours.state_dict(), from_jax.state_dict()
    for k in sd:  # folded scales and biases: f32 rounding of the fold
        torch.testing.assert_close(sd[k].float(), sd_jax[k].float(), rtol=1e-5, atol=1e-6)


def test_classifier_int8_matches_jax_and_the_real_net(classifier_setup):
    s = classifier_setup
    qmodel = quantized_classifier_from_jax(s["jq_np"])
    x = torch.from_numpy(s["x"])
    with torch.no_grad():
        logits = classifier_apply_int8(qmodel, x).float().numpy()
        feats = qmodel(x, return_features=True).float().numpy()
        real = s["real"](x).numpy()
        real_feats = s["real"](x, return_features=True).numpy()
    assert logits.shape == (2, 19) and feats.shape == (2, 512)
    jl = s["jax_logits"]
    assert np.abs(logits - jl).max() < 0.02 * jl.std()
    assert (logits.argmax(-1) == jl.argmax(-1)).all()
    jf = s["jax_features"]  # post-ReLU bf16: a few bf16 ulps of the largest
    assert np.abs(feats - jf).max() < 0.02 * np.abs(jf).max()
    assert np.abs(logits - real).max() < 0.1 * real.std()
    assert (logits.argmax(-1) == real.argmax(-1)).all()
    assert np.abs(feats - real_feats).max() / np.abs(real_feats).max() < 0.05


# --- the int8 eval pipeline ---------------------------------------------------------------


def decisive_pair():
    """A seeded TransformerNet and a classifier whose class 7 wins by far more than the
    quantization noise (JAX ``tests/test_resnet_q.py:225-245``)."""
    model = init_transformer(torch.Generator().manual_seed(0))
    clf = init_classifier(torch.Generator().manual_seed(1))
    with torch.no_grad():
        clf.get_submodule("1").get_submodule("8").bias[7] += 100.0
    return model, clf


def test_evaluate_quantized_equals_the_real_pipeline():
    model, clf = decisive_pair()
    images = (np.random.default_rng(2).random((4, 64, 64, 3)) * 255).astype(np.float32)
    kw = dict(artist_index=7, batch_size=4, wordy=False, crop_size=32, device="cpu")
    acc_q = evaluate_with_classifier(model, clf, images, quantize=True, **kw)
    acc_r = evaluate_with_classifier(model, clf, images, **kw)
    assert acc_q == acc_r == 100.0
    # The pipeline's pair: a quantized stylizer calibrated on those images, and the
    # quantized classifier; the originals are left as they were.
    qmodel, qclf = quantize_eval_pipeline(model, clf, images[:2])
    assert isinstance(qmodel, QuantizedTransformerNet) and isinstance(qclf, QuantizedClassifier)
    assert next(model.parameters()).dtype == torch.float32


def test_inference_cli_quantize_prints_acc(tmp_path, capsys):
    cv2 = pytest.importorskip("cv2")
    model, clf = decisive_pair()
    content = tmp_path / "content"
    content.mkdir()
    rng = np.random.default_rng(3)
    for i in range(2):
        cv2.imwrite(str(content / f"c{i}.jpg"), rng.integers(0, 256, (40, 48, 3), dtype=np.uint8))
    model_dir = tmp_path / "models" / ARTISTS_19[7] / "random"
    model_dir.mkdir(parents=True)
    torch.save(model.state_dict(), model_dir / "t.pth")
    torch.save({"model": clf.state_dict()}, tmp_path / "best-2.pth")
    acc = inference.main([
        "--no-display", "--quantize", "--artist", ARTISTS_19[7], "--model_filename", "t.pth",
        "--model_dir", str(tmp_path / "models"), "--content_dir", str(content),
        "--classifier_path", str(tmp_path / "best-2.pth"), "--num_images", "2",
        "--resize_size", "64", "--seed", "0", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "Grabbed 2 images!" in out and out.rstrip().endswith(f"Acc={acc}") and acc == 100.0
