"""TransformerNet, VGG16 and feed-forward stylize of the PyTorch port, held against
the JAX package and the committed goldens on the CPU.

Parameters move from JAX to the port through ``utils/jax_params.py``.
Tolerances: TransformerNet output PSNR > 45 dB against JAX (the f32 parity
bar of the JAX package's torch oracles), VGG taps within 1e-4 of the
largest tap value, the golden > 35 dB (the repo's north-star bar).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from artist_style_transfer_tpu_torch.infer import stylize as tstylize
from artist_style_transfer_tpu_torch.models import transformer as ttransformer
from artist_style_transfer_tpu_torch.models import vgg as tvgg
from artist_style_transfer_tpu_torch.utils.images import read_png
from artist_style_transfer_tpu_torch.utils.jax_params import (
    transformer_state_dict_from_jax,
    vgg16_state_dict_from_jax,
)
from tests.test_torch_data import one_torch_thread  # noqa: F401

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")


def psnr(a, b) -> float:
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return float(10.0 * np.log10(255.0**2 / mse)) if mse > 0 else float("inf")


def numpy_tree(params):
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def jax_transformer_params():
    from artist_style_transfer_tpu.models.transformer import init_transformer_params

    return init_transformer_params(jax.random.key(0))


@pytest.fixture(scope="module")
def port_transformer(jax_transformer_params):
    model = ttransformer.TransformerNet()
    model.load_state_dict(transformer_state_dict_from_jax(numpy_tree(jax_transformer_params)))
    return model.eval()


@pytest.fixture(scope="module")
def jax_vgg_params():
    from artist_style_transfer_tpu.models.vgg import init_vgg16_params

    return init_vgg16_params(jax.random.key(1))


@pytest.mark.parametrize("h,w", [(32, 32), (30, 34)])
def test_transformer_matches_jax(jax_transformer_params, port_transformer, h, w):
    """Same random params through both nets; odd sizes grow alike (172-style floors)."""
    from artist_style_transfer_tpu.models.transformer import transformer_apply

    x = np.random.default_rng(0).uniform(0, 255, (2, h, w, 3)).astype(np.float32)
    ref = np.asarray(transformer_apply(jax_transformer_params, jnp.asarray(x)))
    with torch.no_grad():
        got = port_transformer(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape
    assert psnr(got, ref) > 45.0


def test_transformer_fold_batch_is_the_same(port_transformer):
    x = torch.from_numpy(np.random.default_rng(1).uniform(0, 255, (2, 24, 24, 3)).astype(np.float32))
    with torch.no_grad():
        torch.testing.assert_close(port_transformer(x, fold_batch=True), port_transformer(x))


def test_transformer_param_count_and_keys():
    from tests.torch_ref import TorchTransformerNet

    model = ttransformer.TransformerNet()
    assert sum(p.numel() for p in model.parameters()) == ttransformer.TRANSFORMER_PARAM_COUNT
    ref_keys = set(TorchTransformerNet().state_dict())
    assert set(model.state_dict()) == ref_keys


def test_golden_pth_roundtrip_through_jax_is_exact():
    """.pth -> JAX params -> port state dict gives back the .pth exactly."""
    from artist_style_transfer_tpu.infer.stylize import load_transfer_params

    path = os.path.join(GOLDENS, "golden_transfer.pth")
    sd = torch.load(path, map_location="cpu", weights_only=True)
    back = transformer_state_dict_from_jax(numpy_tree(load_transfer_params(path)))
    assert set(back) == set(sd)
    for k, v in sd.items():
        torch.testing.assert_close(back[k], v, rtol=0, atol=0)


def test_golden_stylize_psnr_cpu():
    model = tstylize.load_transfer_params(os.path.join(GOLDENS, "golden_transfer.pth"), "cpu")
    content = read_png(os.path.join(GOLDENS, "content_landscape_256.png"))
    golden = read_png(os.path.join(GOLDENS, "golden_stylized.png"))
    out = tstylize.stylize(model, content[None], device="cpu")
    assert out.dtype == torch.uint8
    assert tuple(out.shape[1:]) == golden.shape
    assert psnr(out[0].numpy(), golden) > 35.0


def test_stylize_batched_matches_jax(jax_transformer_params, port_transformer):
    """Mixed shapes, uint8 and f32 inputs: same grouping, order and pixels."""
    from artist_style_transfer_tpu.infer.stylize import stylize_batched

    rng = np.random.default_rng(5)
    images = [
        rng.integers(0, 256, (20, 24, 3), dtype=np.uint8),
        rng.uniform(0, 255, (18, 22, 3)).astype(np.float32),
        rng.integers(0, 256, (20, 24, 3), dtype=np.uint8),
    ]
    ref = stylize_batched(jax_transformer_params, images, batch_size=1)
    got = tstylize.stylize_batched(port_transformer, images, batch_size=2, device="cpu")
    for g, r in zip(got, ref):
        assert g.dtype == np.uint8 and g.shape == r.shape
        # uint8 rounding can flip a value by one where JAX and torch differ in the last bit
        assert np.max(np.abs(g.astype(int) - r.astype(int))) <= 1


def test_stylize_refuses_model_on_other_device(port_transformer):
    with pytest.raises((ValueError, RuntimeError)):
        tstylize.stylize(port_transformer, np.zeros((1, 8, 8, 3), np.uint8), device="meta")


def test_blur_and_sharpen_match_jax():
    from artist_style_transfer_tpu.infer.stylize import gaussian_blur, sharpen

    im = np.random.default_rng(6).integers(0, 256, (12, 10, 3), dtype=np.uint8)
    np.testing.assert_array_equal(tstylize.gaussian_blur(im, 1.5, 5), gaussian_blur(im, 1.5, 5))
    np.testing.assert_array_equal(tstylize.sharpen(im, 30.0), sharpen(im, 30.0))


@pytest.mark.parametrize("just_content", [False, True])
def test_vgg16_features_match_jax(jax_vgg_params, just_content):
    from artist_style_transfer_tpu.models.vgg import vgg16_features

    x = np.random.default_rng(2).uniform(-120, 130, (2, 32, 32, 3)).astype(np.float32)
    ref = vgg16_features(jax_vgg_params, jnp.asarray(x), just_content=just_content)
    model = tvgg.VGG16Features()
    model.load_state_dict(vgg16_state_dict_from_jax(numpy_tree(jax_vgg_params)))
    with torch.no_grad():
        got = model(torch.from_numpy(x), just_content=just_content)
    if just_content:
        ref, got = {"relu2_2": ref}, {"relu2_2": got}
    assert list(got) == list(ref)
    for name, r in ref.items():
        g = got[name]
        assert g.is_contiguous(), name  # the NHWC view the Gram kernel reads
        r = np.asarray(r)
        assert g.shape == r.shape
        assert np.max(np.abs(g.numpy() - r)) / np.max(np.abs(r)) < 1e-4, name


def test_vgg16_odd_sizes_floor_like_jax(jax_vgg_params):
    from artist_style_transfer_tpu.models.vgg import vgg16_features

    x = np.random.default_rng(3).uniform(-100, 100, (1, 43, 22, 3)).astype(np.float32)
    ref = vgg16_features(jax_vgg_params, jnp.asarray(x))
    model = tvgg.VGG16Features()
    model.load_state_dict(vgg16_state_dict_from_jax(numpy_tree(jax_vgg_params)))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: tuple(v.shape) for k, v in ref.items()
    }


def test_vgg16_is_frozen_and_init_is_seeded():
    a = tvgg.init_vgg16(torch.Generator().manual_seed(3))
    b = tvgg.init_vgg16(torch.Generator().manual_seed(3))
    assert not any(p.requires_grad for p in a.parameters())
    for (ka, va), (_, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        torch.testing.assert_close(va, vb, rtol=0, atol=0)
    conv0 = a.features.get_submodule("0")
    assert conv0.weight.abs().max() <= 1 / 27**0.5
    assert conv0.weight.is_contiguous(memory_format=torch.channels_last)


def test_load_vgg16_ignores_layers_past_relu4_3(tmp_path):
    sd = tvgg.init_vgg16(torch.Generator().manual_seed(0)).state_dict()
    extra = {**sd, "features.24.weight": torch.zeros(1), "classifier.0.bias": torch.zeros(1)}
    path = str(tmp_path / "vgg.pth")
    torch.save(extra, path)
    loaded = tvgg.load_vgg16(path, "cpu")
    for k, v in sd.items():
        torch.testing.assert_close(loaded.state_dict()[k], v, rtol=0, atol=0)


def test_inference_cli_display_on_cpu(tmp_path, monkeypatch):
    cv2 = pytest.importorskip("cv2")
    pytest.importorskip("matplotlib")
    import shutil

    from artist_style_transfer_tpu_torch import inference

    model_dir = tmp_path / "models" / "Golden" / "random"
    model_dir.mkdir(parents=True)
    shutil.copy(os.path.join(GOLDENS, "golden_transfer.pth"), model_dir / "g.pth")
    cv2.imwrite(str(model_dir / "style.jpg"), np.zeros((8, 8, 3), np.uint8))
    argv = [
        "--artist", "Golden", "--model_filename", "g.pth",
        "--model_dir", str(tmp_path / "models"), "--fig_dir", str(tmp_path / "figs"),
        "--content_img", os.path.join(GOLDENS, "content_landscape_256.png"),
        "--content_size_w", "64", "--blur", "--sharpen", "--device", "cpu",
    ]
    fig = inference.main(argv)
    assert os.path.exists(fig) and fig.endswith("Golden_random.png")
    # --show on a host without a display writes the same figure and opens nothing.
    os.remove(fig)
    monkeypatch.delenv("DISPLAY", raising=False)
    assert inference.main(argv + ["--show"]) == fig and os.path.exists(fig)
    with pytest.raises(NotImplementedError):
        inference.main(["--model_filename", "missing.pth", "--device", "cpu"])
