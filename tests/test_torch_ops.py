"""Ops of the PyTorch port held against the JAX package on the CPU.

Inputs come from numpy seeds and go through both packages; the port's ops
take NCHW tensors and torch-native weights, so inputs are transposed from
the JAX package's NHWC/HWIO here. Everything runs in "highest" precision
unless a test says otherwise. Tolerances are relative to the largest
magnitude of the reference: 1e-5 for f32 convolutions and norms (f32
rounding of different summation orders), as the JAX package's own parity
tests use.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from artist_style_transfer_tpu_torch.ops import conv as tconv
from artist_style_transfer_tpu_torch.ops import gram as tgram
from artist_style_transfer_tpu_torch.ops import image as timage
from artist_style_transfer_tpu_torch.ops import norm as tnorm
from artist_style_transfer_tpu_torch.ops import pad as tpad
from artist_style_transfer_tpu_torch.ops import precision as tprec
from artist_style_transfer_tpu_torch.ops.cuda import build as tbuild
from artist_style_transfer_tpu_torch.ops.cuda import gram_kernel as tgk
from artist_style_transfer_tpu_torch.utils import jax_params
from artist_style_transfer_tpu_torch.utils.device import resolve_device


def nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def to_nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


def rel_err(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


@pytest.mark.parametrize("h,w,k,s,cin,cout", [
    (32, 40, 9, 1, 3, 8), (32, 40, 3, 2, 8, 16), (17, 23, 9, 1, 3, 4),
    (33, 47, 3, 2, 4, 4), (16, 16, 1, 1, 8, 8),
])
def test_conv2d_reflect_matches_jax(h, w, k, s, cin, cout):
    from artist_style_transfer_tpu.ops.conv import conv2d_reflect

    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, h, w, cin)).astype(np.float32)
    wt = (rng.standard_normal((k, k, cin, cout)) * 0.1).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32)
    ref = np.asarray(conv2d_reflect(jnp.asarray(x), jnp.asarray(wt), jnp.asarray(b), stride=s))
    got = tconv.conv2d_reflect(nchw(x), jax_params._conv_w(wt), torch.from_numpy(b), stride=s)
    assert to_nhwc(got).shape == ref.shape
    assert rel_err(to_nhwc(got), ref) <= 1e-5


@pytest.mark.parametrize("k,s,op,cin,cout", [(3, 2, 1, 8, 4), (1, 1, 0, 8, 8), (3, 2, 1, 16, 8)])
def test_conv_transpose2d_matches_jax(k, s, op, cin, cout):
    """JAX stores transpose-conv weights spatially flipped; the converter
    must un-flip them (a missed flip keeps shapes and breaks values)."""
    from artist_style_transfer_tpu.ops.conv import conv_transpose2d

    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 7, 9, cin)).astype(np.float32)
    w_flipped_hwio = (rng.standard_normal((k, k, cin, cout)) * 0.1).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32)
    ref = np.asarray(conv_transpose2d(jnp.asarray(x), jnp.asarray(w_flipped_hwio), jnp.asarray(b),
                                      stride=s, padding=k // 2, output_padding=op))
    got = tconv.conv_transpose2d(nchw(x), jax_params._convT_w(w_flipped_hwio), torch.from_numpy(b),
                                 stride=s, padding=k // 2, output_padding=op)
    assert to_nhwc(got).shape == ref.shape
    assert rel_err(to_nhwc(got), ref) <= 1e-5


@pytest.mark.parametrize("mode", ["highest", "default"])
def test_instance_norm_matches_jax(mode):
    """Two-pass variance in parity mode, one-pass otherwise, as in JAX."""
    from artist_style_transfer_tpu.ops.norm import instance_norm
    from artist_style_transfer_tpu.ops.precision import precision as jprecision

    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 8, 9, 5)) * 3 + 1).astype(np.float32)
    gamma = rng.standard_normal(5).astype(np.float32)
    beta = rng.standard_normal(5).astype(np.float32)
    with jprecision(mode):
        ref = np.asarray(instance_norm(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta)))
    with tprec.precision(mode):
        got = tnorm.instance_norm(nchw(x), torch.from_numpy(gamma), torch.from_numpy(beta))
    assert rel_err(to_nhwc(got), ref) <= 1e-5


def test_reflect_pad_matches_numpy():
    x = np.arange(1 * 4 * 5 * 2, dtype=np.float32).reshape(1, 4, 5, 2)
    got = to_nhwc(tpad.reflect_pad_hw(nchw(x), 2))
    np.testing.assert_array_equal(got, np.pad(x, ((0, 0), (2, 2), (2, 2), (0, 0)), mode="reflect"))
    t = nchw(x)
    assert tpad.reflect_pad_hw(t, 0) is t


def test_vgg_caffe_preprocess_matches_jax():
    from artist_style_transfer_tpu.ops.image import bgr_to_rgb, vgg_caffe_preprocess

    x = np.random.default_rng(3).uniform(0, 255, (2, 4, 5, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        timage.vgg_caffe_preprocess(torch.from_numpy(x)).numpy(),
        np.asarray(vgg_caffe_preprocess(jnp.asarray(x))),
    )
    np.testing.assert_array_equal(
        timage.bgr_to_rgb(torch.from_numpy(x)).numpy(), np.asarray(bgr_to_rgb(jnp.asarray(x)))
    )


@pytest.mark.parametrize("shape", [(3, 6, 7, 4), (2, 16, 16, 64), (1, 5, 3, 130)])
def test_gram_plain_matches_xla(shape):
    from artist_style_transfer_tpu.ops.gram import gram_matrix_xla

    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    got = tgram.gram_matrix_plain(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(gram_matrix_xla(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-6)


def test_gram_plain_matches_pallas_interpret():
    """The TPU kernel, run in Pallas interpret mode, against the plain version."""
    from jax.experimental.pallas import tpu as pltpu

    from artist_style_transfer_tpu.ops.pallas.gram_kernel import gram_matrix_pallas

    x = np.random.default_rng(2).standard_normal((2, 16, 16, 128)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(gram_matrix_pallas(jnp.asarray(x)))
    got = tgram.gram_matrix_plain(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_gram_function_backward_matches_jax_vjp():
    from artist_style_transfer_tpu.ops.gram import _gram_xla_diff

    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 6, 5, 8)).astype(np.float32)
    dg = rng.standard_normal((2, 8, 8)).astype(np.float32)
    g_ref, vjp = jax.vjp(_gram_xla_diff, jnp.asarray(x))
    (dx_ref,) = vjp(jnp.asarray(dg))

    xt = torch.from_numpy(x).requires_grad_(True)
    g = tgram.gram_matrix(xt)  # "auto" on a CPU tensor: the plain forward
    g.backward(torch.from_numpy(dg))
    np.testing.assert_allclose(g.detach().numpy(), np.asarray(g_ref), rtol=1e-5, atol=1e-6)
    assert rel_err(xt.grad.numpy(), np.asarray(dx_ref)) <= 1e-5


def test_use_kernel_dispatch_on_cpu():
    x = torch.zeros(1, 4, 4, 8)
    assert tgram.resolve_use_kernel(x, "auto") is False
    assert tgram.resolve_use_kernel(x, False) is False
    with pytest.raises(ValueError, match="CUDA"):
        tgram.gram_matrix(x, use_kernel=True)
    with pytest.raises(ValueError):
        tgram.resolve_use_kernel(x, "yes")


def test_gram_kernel_wrapper_refuses_cpu_tensors():
    """The wrapper never falls back: a CPU tensor raises, and nothing counts."""
    before = tgk.LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        tgk.gram_matrix_cuda(torch.zeros(1, 4, 4, 8))
    assert tgk.LAUNCHES == before


@pytest.mark.parametrize("n,hw,c", [
    (1, 65536, 64), (1, 16384, 128), (1, 4096, 256), (1, 1024, 512),
    (4, 262144, 64), (4, 4096, 512), (2, 10, 3), (1, 43 * 64, 512),
])
def test_gram_split_plan_covers_hw(n, hw, c):
    splits, rows = tgk.split_plan(n, hw, c, sm_count=132)
    assert rows % tgk.CHUNK == 0 and rows >= tgk.MIN_ROWS_PER_SPLIT
    assert (splits - 1) * rows < hw <= splits * rows  # every row once, no empty split
    tiles = (-(-c // tgk.TILE)) ** 2
    assert n * tiles * splits <= tgk.BLOCKS_PER_SM * 132 + n * tiles  # about 4 blocks per SM


def test_build_needs_nvcc():
    """Without the CUDA toolkit the build raises instead of falling back."""
    import shutil

    from torch.utils.cpp_extension import CUDA_HOME

    if shutil.which("nvcc") or CUDA_HOME:
        pytest.skip("nvcc present: the build would run")
    with pytest.raises(RuntimeError, match="nvcc"):
        tbuild.build()
    assert len(tbuild.source_hash()) == 64
    assert [p.name for p in tbuild._sources()] == ["gram.cu"]


def test_precision_sets_tf32_flags():
    assert tprec.get_precision() == "highest"
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    with tprec.precision("default"):
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
    with pytest.raises(ValueError):
        tprec.set_precision("fast")


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device(None)
        with pytest.raises(RuntimeError):
            resolve_device("cuda")
