"""Evaluation and stylization over a ('data', 'space') mesh in the PyTorch port:
``evaluate_with_classifier`` (f32 and ``quantize=True``) with each image's rows on the
'space' ranks, ``evaluate_classifier`` and ``stylize_spatial(_int8)`` on a 2-axis
mesh, on gloo ranks on the CPU.

JAX's own 'space' meshes are no reference on the CPU (XLA:CPU miscompiles halo'd
weight gradients, ``tests/test_parallel.py:164-181``, and the int8 spatial path fails
its HLO verifier), so the port is held against JAX's single-device functions and its
own one process, at 32x32, crop 16, B=4, over (1, 2), (2, 2) and (1, 4). Over (1, 4)
the bands are rows [0, 8), [8, 16), [16, 24), [24, 32), and the crop's rows [8, 24)
leave the first and last ranks' bands empty. Tolerances:

- f32: the logits within 2e-3 of JAX ``_eval_core``'s largest (the logits before its
  argmax) with the same argmax, and the ``Pred=`` and ``Acc=`` lines the ones JAX's
  predictions give;
- int8: the logits of ``quantize=True`` equal to the port's one-process int8 pipeline
  bit for bit (the stylizer's static scales are one set on every rank, the
  classifier's dynamic scales the max over every rank's rows), and so the
  predictions; from JAX's quantized pair, within 0.02 std of JAX
  ``_eval_core_int8``'s logits with the same argmax (``tests/test_torch_int8.py``'s
  bar for the int8 classifier);
- a height the 'space' line does not divide raises ``ValueError``;
- ``evaluate_classifier`` over (2, 2) equals the one process's accuracy;
  ``stylize_spatial`` and ``stylize_spatial_int8`` over (2, 1) and (1, 2) equal
  ``stylize`` and ``stylize_int8`` (up to one uint8 step where the IN sums' order moves
  a value across an integer, on at most 0.1% of the values).

Every launch has a time limit of its own, so a collective that one rank misses fails
the test instead of hanging the suite.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from artist_style_transfer_tpu.models import resnet_q as jresnet_q
from artist_style_transfer_tpu.models import transformer_q as jtransformer_q
from artist_style_transfer_tpu.models.resnet import classifier_apply, init_classifier_params
from artist_style_transfer_tpu.models.transformer import init_transformer_params, transformer_apply
from artist_style_transfer_tpu.ops.image import bgr_to_rgb, center_crop, torchvision_normalize
from artist_style_transfer_tpu_torch.infer.stylize import stylize, stylize_int8
from artist_style_transfer_tpu_torch.models.resnet import ARTISTS_19
from artist_style_transfer_tpu_torch.models.transformer import TransformerNet
from artist_style_transfer_tpu_torch.models.transformer_q import quantize_transformer
from artist_style_transfer_tpu_torch.parallel import launch, workers
from artist_style_transfer_tpu_torch.parallel.spatial import RowBands
from artist_style_transfer_tpu_torch.train.classifier import evaluate_classifier
from artist_style_transfer_tpu_torch.utils.jax_params import (
    quantized_classifier_from_jax,
    quantized_transformer_from_jax,
    transformer_state_dict_from_jax,
)
from tests.test_torch_classifier import numpy_params, port_classifier
from tests.test_torch_data import one_torch_thread  # noqa: F401

LAUNCH_S = 240  # each launch's own limit: a missed collective fails, never hangs
SIZE, CROP, B = 32, 16, 4
SHAPES = {2: ((1, 2),), 4: ((2, 2), (1, 4))}
STYLIZE_SHAPES = ((2, 1), (1, 2))
CLF_IMAGES = 9  # evaluate_classifier at batch 4: two sharded batches and a whole one


def images() -> np.ndarray:
    return np.random.default_rng(9).integers(0, 256, (B, SIZE, SIZE, 3), dtype=np.uint8)


def models() -> dict:
    tparams = numpy_params(init_transformer_params, 4)
    cparams = numpy_params(init_classifier_params, 0)
    model = TransformerNet()
    model.load_state_dict(transformer_state_dict_from_jax(tparams))
    jq = jtransformer_q.quantize_transformer(jax.tree.map(jnp.asarray, tparams),
                                             jnp.asarray(images()[:2].astype(np.float32)))
    jqc = jresnet_q.quantize_classifier(jax.tree.map(jnp.asarray, cparams))
    return {"tparams": tparams, "cparams": cparams, "jq": jq, "jqc": jqc,
            "model": model.eval(), "clf": port_classifier(cparams),
            "qmodel": quantized_transformer_from_jax(jax.tree.map(np.asarray, jq)),
            "qclf": quantized_classifier_from_jax(jax.tree.map(np.asarray, jqc))}


def height_refusal_rank(mesh, model, clf) -> str:
    """``evaluate_with_classifier`` of images 34 rows high over (1, 4): the message."""
    from artist_style_transfer_tpu_torch.infer.evaluate import evaluate_with_classifier

    mesh = workers.space_mesh(mesh, (1, 4))
    x = np.zeros((B, 34, SIZE, 3), np.uint8)
    try:
        evaluate_with_classifier(model, clf, x, 0, batch_size=B, crop_size=CROP, mesh=mesh,
                                 device="cpu", wordy=False)
    except ValueError as e:
        return str(e)
    return "no error"


def classifier_data():
    rng = np.random.default_rng(5)
    return (rng.standard_normal((CLF_IMAGES, SIZE, SIZE, 3)).astype(np.float32),
            rng.integers(0, 19, CLF_IMAGES))


def evaluate_classifier_rank(mesh, shape, clf) -> float:
    x, y = classifier_data()
    return evaluate_classifier(clf, x, y, batch_size=B, mesh=workers.space_mesh(mesh, shape))


def jobs(ranks: int) -> list:
    m, x = models(), images()
    eval_kw = dict(batch_size=B, artists=ARTISTS_19, crop_size=CROP)
    out = []
    for shape in SHAPES[ranks]:
        out += [(workers.eval_logits_rank, (shape, m["model"], m["clf"], x, CROP), {}),
                (workers.eval_logits_rank, (shape, m["model"], m["clf"], x, CROP, True), {}),
                (workers.eval_logits_rank, (shape, m["qmodel"], m["qclf"], x, CROP), {}),
                (workers.evaluate_rank, (m["model"], m["clf"], x, 3, eval_kw), {"shape": shape}),
                (workers.evaluate_rank, (m["model"], m["clf"], x, 3,
                                         dict(eval_kw, quantize=True)), {"shape": shape})]
    if ranks == 4:
        out += [(height_refusal_rank, (m["model"], m["clf"]), {}),
                (evaluate_classifier_rank, ((2, 2), m["clf"]), {})]
    else:
        qmodel = quantize_transformer(m["model"], x[:2].astype(np.float32))
        for shape in STYLIZE_SHAPES:
            out += [(workers.stylize_rows_rank, (net, x[0], True), {"shape": shape})
                    for net in (m["model"], qmodel)]
    return out


@pytest.fixture(scope="module")
def two_ranks():
    return launch(workers.run_jobs, 2, jobs(2), backend="gloo", device="cpu",
                  timeout_s=LAUNCH_S)


@pytest.fixture(scope="module")
def four_ranks():
    return launch(workers.run_jobs, 4, jobs(4), backend="gloo", device="cpu",
                  timeout_s=LAUNCH_S)


@pytest.fixture(scope="module")
def reference():
    """JAX's single-device logits (f32 and int8) and the port's one-process int8 ones."""
    m, x = models(), images()

    def logits(stylized, classify, cparams):  # JAX infer/evaluate.py:27-34, before the argmax
        out = jnp.floor(jnp.clip(stylized.astype(jnp.float32), 0.0, 255.0))
        return classify(cparams, torchvision_normalize(bgr_to_rgb(center_crop(out, CROP)) / 255.0))

    f32 = jax.jit(lambda tp, cp, v: logits(transformer_apply(tp, v), classifier_apply, cp))
    int8 = jax.jit(lambda q, qc, v: logits(jtransformer_q.transformer_apply_int8(
        q, v, accum=jnp.bfloat16), jresnet_q.classifier_apply_int8, qc))
    xj = jnp.asarray(x.astype(np.float32))
    return {"f32": np.asarray(f32(jax.tree.map(jnp.asarray, m["tparams"]),
                                  jax.tree.map(jnp.asarray, m["cparams"]), xj)),
            "int8": np.asarray(int8(m["jq"], m["jqc"], xj), np.float32),
            "port_int8": workers.eval_logits_rank(None, None, m["model"], m["clf"], x, CROP,
                                                  True)["logits"]}


def cases(two_ranks, four_ranks):
    """(shape, the ranks' results from that shape's jobs) for each eval mesh."""
    for ranks, got in ((2, two_ranks), (4, four_ranks)):
        for i, shape in enumerate(SHAPES[ranks]):
            yield shape, [r[5 * i: 5 * i + 5] for r in got]


def whole_batch(ranks: list, shape: tuple[int, int], job: int) -> np.ndarray:
    """The data slices' logits, from the first rank of each 'space' line, in order."""
    return np.concatenate([ranks[i * shape[1]][job]["logits"] for i in range(shape[0])])


def test_crop_leaves_bands_empty_over_four():
    line = type("Line", (), {"size": 4, "rank": 0})()
    from artist_style_transfer_tpu_torch.parallel.spatial import center_crop_rows

    bands = RowBands.split(line, SIZE)
    starts = []
    for r in range(4):
        line.rank = r
        x = torch.arange(SIZE, dtype=torch.float32).view(1, SIZE, 1, 1).expand(1, SIZE, SIZE, 1)
        y, out = center_crop_rows(x[:, slice(*bands.bounds())], bands, CROP)
        starts.append(out.starts)
        assert torch.equal(y[0, :, 0, 0], torch.arange(*out.bounds(), dtype=torch.float32) + 8)
    assert starts[0] == (0, 0, 8, 16, 16) and len(set(starts)) == 1


def test_eval_f32_over_space_matches_jax(two_ranks, four_ranks, reference):
    want = reference["f32"]
    preds = want.argmax(-1)
    lines = [f"Pred={ARTISTS_19[p]}\tActual={ARTISTS_19[3]}\timage_num={i + 1}"
             for i, p in enumerate(preds)]
    acc = round(100.0 * (preds == 3).sum() / B, 2)
    for shape, ranks in cases(two_ranks, four_ranks):
        got = whole_batch(ranks, shape, 0)
        assert np.abs(got - want).max() <= 2e-3 * np.abs(want).max(), shape
        np.testing.assert_array_equal(got.argmax(-1), preds)
        assert ranks[0][3]["stdout"].splitlines() == lines + [f"Acc={acc}"], shape
        assert all(r[3]["acc"] == acc and (r is ranks[0] or r[3]["stdout"] == "")
                   for r in ranks), shape


def test_eval_int8_over_space_matches_one_process_and_jax(two_ranks, four_ranks, reference):
    one, jax_int8 = reference["port_int8"], reference["int8"]
    preds = one.argmax(-1)
    for shape, ranks in cases(two_ranks, four_ranks):
        np.testing.assert_array_equal(whole_batch(ranks, shape, 1), one, err_msg=str(shape))
        from_jax = whole_batch(ranks, shape, 2)
        assert np.abs(from_jax - jax_int8).max() <= 0.02 * jax_int8.std(), shape
        np.testing.assert_array_equal(from_jax.argmax(-1), jax_int8.argmax(-1))
        acc = round(100.0 * (preds == 3).sum() / B, 2)
        assert all(r[4]["acc"] == acc for r in ranks), shape
        assert ranks[0][4]["stdout"].splitlines()[:B] == [
            f"Pred={ARTISTS_19[p]}\tActual={ARTISTS_19[3]}\timage_num={i + 1}"
            for i, p in enumerate(preds)], shape


def test_eval_refuses_a_height_the_space_line_does_not_divide(four_ranks):
    for r in four_ranks:
        assert r[10] == "image height 34 does not divide over the 4-rank 'space' line"


def test_evaluate_classifier_over_space_matches_one_process(four_ranks):
    x, y = classifier_data()
    want = evaluate_classifier(models()["clf"], x, y, batch_size=B)
    assert [r[11] for r in four_ranks] == [want] * 4


@pytest.mark.parametrize("shape", STYLIZE_SHAPES)
@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
def test_stylize_spatial_on_a_two_axis_mesh(two_ranks, shape, quantized):
    m, x = models(), images()
    if quantized:
        want = stylize_int8(quantize_transformer(m["model"], x[:2].astype(np.float32)), x[:1],
                            device="cpu")[0].numpy()
    else:
        want = stylize(m["model"], x[:1], device="cpu")[0].numpy()
    job = 2 * STYLIZE_SHAPES.index(shape) + int(quantized)
    for r in two_ranks:
        got = r[5 + job]["out"]
        assert got.shape == want.shape and got.dtype == want.dtype
        diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, (shape, diff.max())
