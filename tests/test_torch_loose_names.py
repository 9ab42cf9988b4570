"""Four public names of the JAX package that the PyTorch port had lacked, held against the
JAX functions on shared inputs: ``ops.losses.psnr``, ``utils.images.imshow_array``,
``ops.pad.reflect_pad_w`` (NCHW in the port, NHWC in JAX) and
``models.transformer.transformer_param_count``. Bars: PSNR rtol 1e-5 (both take the MSE
in f32); the rest exact.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from artist_style_transfer_tpu.models.transformer import (
    init_transformer_params,
)
from artist_style_transfer_tpu.models.transformer import (
    transformer_param_count as jtransformer_param_count,
)
from artist_style_transfer_tpu.ops.losses import psnr as jpsnr
from artist_style_transfer_tpu.ops.pad import reflect_pad_w as jreflect_pad_w
from artist_style_transfer_tpu.utils.images import imshow_array as jimshow_array
from artist_style_transfer_tpu_torch.models.transformer import (
    init_transformer,
    transformer_param_count,
)
from artist_style_transfer_tpu_torch.ops.losses import psnr
from artist_style_transfer_tpu_torch.ops.pad import reflect_pad_w
from artist_style_transfer_tpu_torch.utils.images import imshow_array
from tests.test_torch_data import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("noise", [0.5, 20.0])
def test_psnr_matches_jax(noise):
    rng = np.random.default_rng(int(noise))
    a = (rng.random((2, 8, 8, 3)) * 255).astype(np.float32)
    b = (a + rng.standard_normal(a.shape) * noise).astype(np.float32)
    got = float(psnr(torch.as_tensor(a), torch.as_tensor(b)))
    np.testing.assert_allclose(got, float(jpsnr(jnp.asarray(a), jnp.asarray(b))), rtol=1e-5)
    np.testing.assert_allclose(float(psnr(torch.as_tensor(a) / 255, torch.as_tensor(b) / 255,
                                          peak=1.0)), got, rtol=1e-4)
    assert float(psnr(torch.as_tensor(a), torch.as_tensor(a))) == float("inf")


def test_imshow_array_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    img = rng.uniform(-50, 400, (6, 5, 3))
    got = imshow_array(img)
    np.testing.assert_array_equal(got, jimshow_array(img))
    assert got.min() == 0.0 and got.max() == 1.0
    out = tmp_path / "figs" / "f.png"
    np.testing.assert_array_equal(imshow_array(img, out_path=str(out), title="t"), got)
    assert out.exists() and out.stat().st_size > 0


@pytest.mark.parametrize("pad", [0, 1, 3])
def test_reflect_pad_w_matches_jax(pad):
    x = np.random.default_rng(pad).standard_normal((2, 5, 7, 3)).astype(np.float32)
    want = np.asarray(jreflect_pad_w(jnp.asarray(x), pad))
    xt = torch.as_tensor(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    got = reflect_pad_w(xt, pad)
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


def test_transformer_param_count_matches_jax():
    model = init_transformer(torch.Generator().manual_seed(0))
    want = jtransformer_param_count(jax.eval_shape(init_transformer_params, jax.random.key(0)))
    assert transformer_param_count(model) == want == 1_712_771
