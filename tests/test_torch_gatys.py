"""Losses and Gatys stylization of the PyTorch port, held against the JAX package
on the CPU with the same VGG parameters (moved across by ``utils/jax_params.py``).

Tolerances: losses within 1e-5 relative (f32 reductions in another order);
the 3-step Gatys loss trace within 1e-3 relative and the pixels within 0.5
on the 0-255 scale, the bounds the port is held to.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from artist_style_transfer_tpu_torch.models import vgg as tvgg
from artist_style_transfer_tpu_torch.ops import losses as tlosses
from artist_style_transfer_tpu_torch.train.gatys import gatys_stylize
from artist_style_transfer_tpu_torch.utils.jax_params import vgg16_state_dict_from_jax
from tests.test_torch_data import one_torch_thread  # noqa: F401

SIZE = 32


@pytest.fixture(scope="module")
def vgg_pair():
    from artist_style_transfer_tpu.models.vgg import init_vgg16_params

    params = init_vgg16_params(jax.random.key(0))
    model = tvgg.VGG16Features()
    model.load_state_dict(vgg16_state_dict_from_jax(jax.tree.map(np.asarray, params)))
    return params, model


def images(seed: int):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:SIZE, 0:SIZE].astype(np.float32)
    smooth = 127.5 + 100 * np.sin(xx / 5.0 + seed)[..., None] * np.cos(yy / 7.0)[..., None]
    noise = rng.uniform(-20, 20, (SIZE, SIZE, 3))
    return np.clip(smooth + noise, 0, 255).astype(np.float32)


def test_content_loss_matches_jax():
    from artist_style_transfer_tpu.ops.losses import content_loss

    rng = np.random.default_rng(0)
    a, b = (rng.standard_normal((2, 8, 8, 16)).astype(np.float32) for _ in range(2))
    ref = float(content_loss(jnp.asarray(a), jnp.asarray(b)))
    got = float(tlosses.content_loss(torch.from_numpy(a), torch.from_numpy(b)))
    assert abs(got - ref) <= 1e-5 * abs(ref)


@pytest.mark.parametrize("target_batch", [False, True])
def test_style_loss_gram_matches_jax(vgg_pair, target_batch):
    """(C, C) and (N, C, C) targets, on real VGG taps of two images."""
    from artist_style_transfer_tpu.models.vgg import vgg16_features
    from artist_style_transfer_tpu.ops.gram import gram_matrix_xla
    from artist_style_transfer_tpu.ops.losses import style_loss_gram

    params, model = vgg_pair
    x = np.stack([images(1), images(2)]) - 120.0
    s = images(3)[None] - 120.0
    jfeats = vgg16_features(params, jnp.asarray(x))
    jtargets = {k: gram_matrix_xla(v) for k, v in vgg16_features(params, jnp.asarray(s)).items()}
    if not target_batch:
        jtargets = {k: v[0] for k, v in jtargets.items()}
    ref = float(style_loss_gram(jfeats, jtargets))

    with torch.no_grad():
        tfeats = model(torch.from_numpy(x))
    targets = {k: torch.from_numpy(np.array(v)) for k, v in jtargets.items()}
    got = float(tlosses.style_loss_gram(tfeats, targets))
    assert abs(got - ref) <= 1e-5 * abs(ref)


def test_gatys_matches_jax(vgg_pair):
    """3 Adam steps at lr 4 from the same content: same loss trace and pixels."""
    from artist_style_transfer_tpu.train.gatys import gatys_stylize as jax_gatys

    params, model = vgg_pair
    content, style = images(4), images(5)
    ref_img, ref_losses = jax_gatys(params, jnp.asarray(content), jnp.asarray(style), num_steps=3)
    img, losses = gatys_stylize(model, content, style, num_steps=3, device="cpu")
    assert losses.device.type == "cpu" and losses.shape == (3,)
    np.testing.assert_allclose(losses.numpy(), np.asarray(ref_losses), rtol=1e-3)
    assert img.shape == (SIZE, SIZE, 3)
    assert np.max(np.abs(img.numpy() - np.asarray(ref_img))) < 0.5


def test_gatys_loss_falls_and_stays_in_range(vgg_pair):
    """The JAX package's own progress check (tests/test_inference.py
    test_gatys_reduces_loss): same VGG params, inputs, lr and steps."""
    _, model = vgg_pair
    rng = np.random.default_rng(3)
    content = (rng.random((SIZE, SIZE, 3)) * 255).astype(np.float32)
    style = (rng.random((SIZE, SIZE, 3)) * 255).astype(np.float32)
    img, losses = gatys_stylize(model, content, style, num_steps=30, lr=2.0, device="cpu")
    assert torch.isfinite(losses).all() and losses[-1] < 0.9 * losses[0]
    assert img.min() >= 0 and img.max() <= 255


def test_gatys_refuses_kernel_on_cpu(vgg_pair):
    _, model = vgg_pair
    with pytest.raises(ValueError, match="CUDA"):
        gatys_stylize(model, images(1), images(2), num_steps=1, use_kernel=True, device="cpu")


def test_stylize_gatys_cli_on_cpu(tmp_path):
    cv2 = pytest.importorskip("cv2")
    from artist_style_transfer_tpu_torch import stylize_gatys

    vgg_path = str(tmp_path / "vgg.pth")
    torch.save(tvgg.init_vgg16(torch.Generator().manual_seed(0)).state_dict(), vgg_path)
    for name, seed in (("c.png", 1), ("s.png", 2)):
        cv2.imwrite(str(tmp_path / name), images(seed).astype(np.uint8))
    out = stylize_gatys.main([
        "--content_img", str(tmp_path / "c.png"), "--style_img", str(tmp_path / "s.png"),
        "--size", "24", "--num_steps", "2", "--vgg_path", vgg_path,
        "--out", str(tmp_path / "figs" / "g.png"), "--device", "cpu",
    ])
    written = cv2.imread(out)
    assert written is not None and written.shape == (24, 24, 3)
