"""Row-sharded stylization in the PyTorch port (``parallel/spatial.py``,
``infer/stylize.stylize_spatial`` and ``stylize_spatial_int8``) against the JAX
package's on its 8 fake CPU devices, over 4 gloo ranks on the CPU (one launch).

The same numpy-seeded image and JAX's parameters (moved across by
``utils/jax_params.py``) feed both sides. Tolerances, JAX's own
(``tests/test_parallel.py:109-163``):

- f32: the output within rtol 1e-5, atol 5e-3 (on the 0-255 scale) of JAX's
  ``stylize_spatial`` and of the port's single-device ``stylize``, at 64x48 (bands of
  16, 8 and 4 rows at full, half and quarter resolution) and at 36x40 (9 rows, then
  uneven bands: 5/5/4/4 and 3/2/2/2, fewer than the 9x9 convs' 4-row halo); uint8
  equal to the port's single-device uint8 but where an f32 difference under the
  tolerance crosses a rounding boundary (at most 1);
- int8, on JAX's quantized parameters: the first int8 conv's codes and int32 sums
  over the bands identical to the single-device ones; the output within atol 1.5,
  mean under 0.2 of JAX's ``stylize_spatial_int8`` and within the same of the port's
  ``stylize_int8``. At 36x40 JAX's sharded int8 path does not compile (XLA's SPMD
  partitioner emits an s8 pad whose operand types differ, for the uneven quarter-
  resolution bands), so there the reference is JAX's single-device ``stylize_int8``;
- every rank returns the same whole image.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from artist_style_transfer_tpu.infer.stylize import stylize_spatial as jax_spatial
from artist_style_transfer_tpu.infer.stylize import stylize_int8 as jax_stylize_int8
from artist_style_transfer_tpu.infer.stylize import stylize_spatial_int8 as jax_spatial_int8
from artist_style_transfer_tpu.models.transformer import init_transformer_params
from artist_style_transfer_tpu.models.transformer_q import quantize_transformer as jax_quantize
from artist_style_transfer_tpu.ops.precision import precision as jax_precision
from artist_style_transfer_tpu.parallel import make_mesh as jmake_mesh
from artist_style_transfer_tpu_torch.infer.stylize import stylize, stylize_int8
from artist_style_transfer_tpu_torch.models.transformer import TransformerNet
from artist_style_transfer_tpu_torch.ops.qconv import conv_i8, quant_i8
from artist_style_transfer_tpu_torch.parallel import launch, workers
from artist_style_transfer_tpu_torch.utils.jax_params import (
    quantized_transformer_from_jax,
    transformer_state_dict_from_jax,
)
from tests.test_torch_data import one_torch_thread  # noqa: F401

RANKS = 4
SHAPES = [(64, 48), (36, 40)]


def stem_output(qmodel, image: np.ndarray) -> torch.Tensor:
    """The input of the first int8 conv, single-device: the bf16 stem's IN + ReLU."""
    from artist_style_transfer_tpu_torch.models import transformer_q as tq

    x = torch.as_tensor(image)[None].to(torch.bfloat16).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    return tq._in_relu_bf16(tq._reflect_conv_bf16(x, qmodel.stem_w, qmodel.stem_b),
                            qmodel.stem_gamma, qmodel.stem_beta)


@pytest.fixture(scope="module")
def spatial():
    params = init_transformer_params(jax.random.key(0))
    np_params = jax.tree.map(np.asarray, params)
    model = TransformerNet()
    model.load_state_dict(transformer_state_dict_from_jax(np_params))
    rng = np.random.default_rng(6)
    calib = jnp.asarray(rng.random((2, 64, 48, 3)) * 255, jnp.float32)
    with jax_precision("default"):
        jq = jax_quantize(params, calib)
    qmodel = quantized_transformer_from_jax(jax.tree.map(np.asarray, jq))
    images = {s: (np.random.default_rng(5 + i).random(s + (3,)) * 255).astype(np.float32)
              for i, s in enumerate(SHAPES)}
    x0 = stem_output(qmodel, images[SHAPES[0]])
    rows = workers.stylize_rows_rank
    jobs = ([(rows, (model, images[s], False), {}) for s in SHAPES]
            + [(rows, (model, images[SHAPES[0]], True), {})]
            + [(rows, (qmodel, images[s], False), {}) for s in SHAPES]
            + [(workers.first_int8_conv_rows_rank, (qmodel, x0.float().numpy()), {})])
    ranks = launch(workers.run_jobs, RANKS, jobs, backend="gloo", device="cpu")
    return dict(params=params, jq=jq, model=model, qmodel=qmodel, images=images, x0=x0,
                ranks=ranks)


@pytest.mark.parametrize("shape", SHAPES, ids=["64x48", "36x40"])
def test_stylize_spatial_matches_jax_and_single_device(spatial, shape):
    i = SHAPES.index(shape)
    got = spatial["ranks"][0][i]["out"]
    for r in spatial["ranks"][1:]:
        np.testing.assert_array_equal(r[i]["out"], got)
    img = spatial["images"][shape]
    ref = np.asarray(jax_spatial(spatial["params"], img, jmake_mesh(shape=(RANKS,)), clip=False))
    assert got.shape == ref.shape == img.shape
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=5e-3)
    single = stylize(spatial["model"], img[None], clip=False, device="cpu")[0].numpy()
    np.testing.assert_allclose(got, single, rtol=1e-5, atol=5e-3)


def test_stylize_spatial_uint8(spatial):
    got = spatial["ranks"][0][2]["out"]
    img = spatial["images"][SHAPES[0]]
    single = stylize(spatial["model"], img[None], device="cpu")[0].numpy()
    assert got.dtype == np.uint8 and got.shape == single.shape
    assert np.abs(got.astype(np.int16) - single.astype(np.int16)).max() <= 1
    ref = np.asarray(jax_spatial(spatial["params"], img[None], jmake_mesh(shape=(RANKS,))))
    assert ref.shape == (1,) + got.shape and ref.dtype == np.uint8
    assert np.abs(got.astype(np.int16) - ref[0].astype(np.int16)).max() <= 1


def test_first_int8_conv_over_bands_is_exact(spatial):
    """The halo rows quantize with the static scale to the single-device codes, and K2's
    plain version sums the same int32 over the bands as over the whole image."""
    got = spatial["ranks"][0][-1]
    layer = spatial["qmodel"].encoder[0]
    x0 = spatial["x0"]
    codes = quant_i8(x0, layer.sin)
    acc = conv_i8(codes, layer.wq, layer.stride, layer.padding, 1, "reflect")
    np.testing.assert_array_equal(got["codes"], codes.numpy())
    np.testing.assert_array_equal(got["acc"], acc.numpy())
    for r in spatial["ranks"][1:]:
        np.testing.assert_array_equal(r[-1]["acc"], got["acc"])


@pytest.mark.parametrize("shape", SHAPES, ids=["64x48", "36x40"])
def test_stylize_spatial_int8_matches_jax_and_single_device(spatial, shape):
    i = 3 + SHAPES.index(shape)
    got = spatial["ranks"][0][i]["out"]
    for r in spatial["ranks"][1:]:
        np.testing.assert_array_equal(r[i]["out"], got)
    img = spatial["images"][shape]
    with jax_precision("default"):
        if shape == SHAPES[0]:
            ref = np.asarray(jax_spatial_int8(spatial["jq"], img, jmake_mesh(shape=(RANKS,)),
                                              clip=False), np.float32)
        else:
            ref = np.asarray(jax_stylize_int8(spatial["jq"], jnp.asarray(img)[None],
                                              clip=False), np.float32)[0]
    single = stylize_int8(spatial["qmodel"], img[None], clip=False,
                          device="cpu")[0].float().numpy()
    assert got.shape == ref.shape == single.shape == img.shape
    for want in (ref, single):
        np.testing.assert_allclose(got, want, atol=1.5)
        assert float(np.mean(np.abs(got - want))) < 0.2


def _refusals(mesh, model, image):
    from artist_style_transfer_tpu_torch.infer.stylize import stylize_spatial
    from artist_style_transfer_tpu_torch.parallel import workers

    out = []
    for args in ((model, image[:7], mesh), (model, image, mesh),
                 (model, image[:7], workers.space_mesh(mesh, (2, 1))),
                 (model, image, workers.space_mesh(mesh, (1, 2)))):
        try:
            stylize_spatial(*args, device="cpu")
            out.append(None)
        except ValueError as e:
            out.append(str(e))
    return out


def test_stylize_spatial_refusals(spatial):
    """The ranks of the 'data' line must divide H, as JAX's sharding needs, on a
    ('data', 'space') mesh too (its rows spread over 'data'; a 'space' line repeats
    them); a mesh without the ranks its shape needs, or with a third axis, refuses."""
    import dataclasses

    from artist_style_transfer_tpu_torch.infer.stylize import stylize_spatial
    from tests.test_torch_distributed import space_mesh

    img = spatial["images"][SHAPES[0]]
    got = launch(_refusals, 2, spatial["model"], img, backend="gloo", device="cpu")[0]
    msg = "image height 7 does not divide over the 2-rank 'data' line"
    assert got == [msg, None, msg, None]
    with pytest.raises(ValueError, match="needs 2 ranks"):
        stylize_spatial(spatial["model"], img, space_mesh(), device="cpu")
    third = dataclasses.replace(space_mesh(), axis_names=("data", "space", "model"),
                                shape=(1, 1, 2))
    with pytest.raises(NotImplementedError, match="'data' and 'space' alone"):
        stylize_spatial(spatial["model"], img, third, device="cpu")
