"""The classifier slice of the PyTorch port held against the JAX package on the CPU:
the ops it adds, the ResNet-50 artist classifier, the reference checkpoint
layout, ``evaluate_with_classifier`` and the ``--no-display`` CLI.

Inputs come from numpy seeds; JAX classifier weights get random BN running
statistics (fresh BN's mean 0 / var 1 would hide a statistics bug) and are
carried to the port by ``classifier_state_dict_from_jax``. Tolerances:

- ops: 1e-5 of the reference's largest magnitude (f32 rounding of other
  summation orders), exact where no arithmetic is involved (pools, crop);
- ResNet-50 logits and features: 2e-3 of max|logit| with identical argmax,
  the bar of the JAX package's own torch oracle (``tests/test_models_parity.py:151``);
- the eval pipeline: identical predictions and accuracy, logits within 2e-3.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from artist_style_transfer_tpu_torch import inference
from artist_style_transfer_tpu_torch.infer.evaluate import eval_logits, evaluate_with_classifier
from artist_style_transfer_tpu_torch.infer.stylize import load_transfer_params
from artist_style_transfer_tpu_torch.models.resnet import (
    ARTISTS_19,
    ResNet50Classifier,
    init_classifier,
    load_classifier,
)
from artist_style_transfer_tpu_torch.models.transformer import TransformerNet
from artist_style_transfer_tpu_torch.ops import conv as tconv
from artist_style_transfer_tpu_torch.ops import image as timage
from artist_style_transfer_tpu_torch.ops import losses as tlosses
from artist_style_transfer_tpu_torch.ops import norm as tnorm
from artist_style_transfer_tpu_torch.utils.jax_params import (
    classifier_state_dict_from_jax,
    transformer_state_dict_from_jax,
)
from tests.test_torch_data import one_torch_thread  # noqa: F401
from tests.test_torch_distributed import world_of_one


def rel_err(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


def nchw(a: np.ndarray) -> torch.Tensor:
    """NHWC numpy -> NCHW tensor in channels_last, as the port's models hold activations."""
    return torch.from_numpy(a).permute(0, 3, 1, 2)


def numpy_params(init_fn, seed: int) -> dict:
    """A numpy pytree in the layout of JAX ``init_fn``, drawn with numpy (jax.random's
    per-leaf draws cost seconds on the CPU): U(+-1/sqrt(fan_in)) weights, small biases,
    gamma near 1, and for BN random running statistics (mean 0 / var 1 would hide a
    statistics bug)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name, shape = str(getattr(path[-1], "key", "")), leaf.shape
        if name == "w":
            bound = 1.0 / np.sqrt(np.prod(shape[:-1]))
            out = rng.uniform(-bound, bound, shape)
        elif name in ("b", "beta"):
            out = rng.uniform(-0.1, 0.1, shape)
        elif name == "gamma":
            out = rng.uniform(0.8, 1.2, shape)
        elif name == "mean":
            out = rng.standard_normal(shape) * 0.5
        elif name == "var":
            out = rng.uniform(0.5, 2.5, shape)
        else:
            raise KeyError(name)
        return out.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, jax.eval_shape(init_fn, jax.random.key(0)))


def jax_classifier_params(seed: int) -> dict:
    from artist_style_transfer_tpu.models.resnet import init_classifier_params

    return numpy_params(init_classifier_params, seed)


def port_classifier(params: dict) -> ResNet50Classifier:
    model = ResNet50Classifier()
    model.load_state_dict(classifier_state_dict_from_jax(params))
    return model


@pytest.fixture(scope="module")
def clf_params():
    return jax_classifier_params(3)


# --- ops -------------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["nchw_channels_last", "nc"])
def test_batch_norm_inference_matches_jax(layout):
    from artist_style_transfer_tpu.ops.norm import batch_norm_inference

    rng = np.random.default_rng(1)
    shape = (2, 5, 6, 8) if layout != "nc" else (3, 8)
    x = rng.standard_normal(shape).astype(np.float32) * 3.0 + 1.0
    gamma, beta, mean = (rng.standard_normal(8).astype(np.float32) for _ in range(3))
    var = rng.uniform(0.2, 3.0, 8).astype(np.float32)
    ref = np.asarray(batch_norm_inference(*map(jnp.asarray, (x, gamma, beta, mean, var))))
    xt = nchw(x).contiguous(memory_format=torch.channels_last) if x.ndim == 4 else torch.from_numpy(x)
    got = tnorm.batch_norm_inference(xt, *map(torch.from_numpy, (gamma, beta, mean, var)))
    if x.ndim == 4:
        assert got.is_contiguous(memory_format=torch.channels_last)
        got = got.permute(0, 2, 3, 1)
    assert rel_err(got.numpy(), ref) <= 1e-5


@pytest.mark.parametrize("h,w", [(9, 9), (8, 11), (5, 6)])
def test_max_pool2d_3_2_1_pads_with_minus_inf_as_jax(h, w):
    """All-negative inputs: a zero border would win every edge window."""
    from artist_style_transfer_tpu.ops.conv import max_pool2d

    x = -np.random.default_rng(h * w).uniform(1.0, 5.0, (2, h, w, 4)).astype(np.float32)
    ref = np.asarray(max_pool2d(jnp.asarray(x), 3, 2, padding=1))
    got = tconv.max_pool2d(nchw(x).contiguous(memory_format=torch.channels_last), 3, 2, padding=1)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), ref)
    assert (ref < 0).all()


@pytest.mark.parametrize("memory_format", [torch.channels_last, torch.contiguous_format])
def test_global_pools_match_jax_in_either_memory_format(memory_format):
    from artist_style_transfer_tpu.ops.conv import avg_pool_global, max_pool_global

    x = np.random.default_rng(2).standard_normal((2, 5, 7, 16)).astype(np.float32)
    xt = nchw(x).contiguous(memory_format=memory_format)
    np.testing.assert_array_equal(tconv.max_pool_global(xt).numpy(),
                                  np.asarray(max_pool_global(jnp.asarray(x))))
    assert rel_err(tconv.avg_pool_global(xt).numpy(), avg_pool_global(jnp.asarray(x))) <= 1e-6


def test_linear_matches_jax():
    from artist_style_transfer_tpu.ops.conv import linear

    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 64)).astype(np.float32)
    w = rng.standard_normal((64, 10)).astype(np.float32)  # JAX (I, O)
    b = rng.standard_normal(10).astype(np.float32)
    ref = np.asarray(linear(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    got = tconv.linear(torch.from_numpy(x), torch.from_numpy(w.T.copy()), torch.from_numpy(b))
    assert rel_err(got.numpy(), ref) <= 1e-5


@pytest.mark.parametrize("typo", [False, True])
def test_torchvision_normalize_matches_jax(typo):
    from artist_style_transfer_tpu.ops.image import torchvision_normalize

    x = np.random.default_rng(4).uniform(0, 1, (2, 4, 5, 3)).astype(np.float32)
    ref = np.asarray(torchvision_normalize(jnp.asarray(x), reference_typo_stats=typo))
    got = timage.torchvision_normalize(torch.from_numpy(x), reference_typo_stats=typo)
    assert rel_err(got.numpy(), ref) <= 1e-6
    g_mean = 0.546 if typo else 0.456
    np.testing.assert_allclose(got[..., 1].numpy(), (x[..., 1] - g_mean) / 0.224, rtol=1e-6)


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("h,w,size", [(9, 12, 5), (5, 6, 8), (10, 3, 6), (7, 7, 7)])
def test_center_crop_matches_jax(batched, h, w, size):
    """Odd crops, odd pads (the odd pixel on the top/left), pad in one axis only."""
    from artist_style_transfer_tpu.ops.image import center_crop

    x = np.random.default_rng(h * w).uniform(1, 255, (h, w, 3)).astype(np.float32)
    if batched:
        x = np.stack([x, x[::-1]])
    ref = np.asarray(center_crop(jnp.asarray(x), size))
    got = timage.center_crop(torch.from_numpy(x), size)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_cross_entropy_loss_matches_jax():
    from artist_style_transfer_tpu.ops.losses import cross_entropy_loss

    rng = np.random.default_rng(5)
    logits = (rng.standard_normal((4, 19)) * 4).astype(np.float32)
    labels = np.array([9, 0, 18, 9])
    ref = float(cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels)))
    got = tlosses.cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels))
    assert got.dtype == torch.float32 and abs(got.item() - ref) <= 1e-5 * abs(ref)
    torch.testing.assert_close(got, torch.nn.functional.cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(labels)))


# --- the classifier ----------------------------------------------------------------------


@pytest.mark.parametrize("return_features", [False, True])
def test_resnet50_matches_jax_classifier_apply(clf_params, return_features):
    from artist_style_transfer_tpu.models.resnet import classifier_apply

    x = np.random.default_rng(6).standard_normal((2, 48, 48, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(classifier_apply, static_argnums=2)(
        jax.tree.map(jnp.asarray, clf_params), jnp.asarray(x), return_features))
    with torch.no_grad():
        got = port_classifier(clf_params)(torch.from_numpy(x), return_features=return_features)
    assert tuple(got.shape) == ref.shape == (2, 512 if return_features else 19)
    assert np.abs(got.numpy() - ref).max() <= 2e-3 * np.abs(ref).max()
    if not return_features:
        np.testing.assert_array_equal(got.numpy().argmax(-1), ref.argmax(-1))


def test_resnet50_parameter_count_and_keys(clf_params):
    """The port's parameters and BN statistics add up to the JAX pytree; the keys
    are the reference's (the oracle of the JAX package's own tests)."""
    from tests.torch_ref import make_torch_classifier

    model = port_classifier(clf_params)
    n_port = sum(v.numel() for k, v in model.state_dict().items() if v.is_floating_point())
    assert n_port == sum(np.size(a) for a in jax.tree.leaves(clf_params)) == 25_686_995
    assert sum(p.numel() for p in model.parameters()) == 25_624_659
    ref = make_torch_classifier(19).state_dict()
    assert list(model.state_dict()) == list(ref)
    assert all(model.state_dict()[k].shape == v.shape for k, v in ref.items())


def test_resnet50_is_frozen_channels_last_and_ignores_train_mode(clf_params):
    model = port_classifier(clf_params)
    assert not any(p.requires_grad for p in model.parameters())
    assert model.get_parameter("0.0.weight").is_contiguous(memory_format=torch.channels_last)
    x = torch.from_numpy(np.random.default_rng(7).standard_normal((2, 32, 32, 3)).astype(np.float32))
    with torch.no_grad():
        a = model.eval()(x)
        b = model.train()(x)
    torch.testing.assert_close(a, b, rtol=0, atol=0)  # BN never switches to batch statistics
    a = init_classifier(torch.Generator().manual_seed(1))
    b = init_classifier(torch.Generator().manual_seed(1))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        torch.testing.assert_close(va, vb, rtol=0, atol=0, msg=k)
    assert a.get_parameter("0.0.weight").abs().max() <= 1 / 147**0.5


def test_fastai_checkpoint_loads_in_both_packages(clf_params, tmp_path):
    """A ``{'model': sd, 'opt': ...}`` file as fastai writes ``best-2.pth``."""
    from artist_style_transfer_tpu.models.resnet import classifier_apply
    from artist_style_transfer_tpu.utils.torch_import import (
        classifier_params_from_torch,
        classifier_params_to_torch,
        load_torch_state_dict,
    )

    sd = classifier_state_dict_from_jax(clf_params)
    path = str(tmp_path / "best-2.pth")
    torch.save({"model": sd, "opt": {"lr": 0.01}}, path)
    port = load_classifier(path, "cpu")
    jax_params = classifier_params_from_torch(load_torch_state_dict(path))
    x = np.random.default_rng(8).standard_normal((2, 40, 40, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(classifier_apply)(jax_params, jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert np.abs(got - ref).max() <= 2e-3 * np.abs(ref).max()
    # The round trip is the identity, strictly: the JAX exporter's file loads too.
    for k, v in port.state_dict().items():
        torch.testing.assert_close(v, sd[k], rtol=0, atol=0, msg=k)
    exported = {k: torch.as_tensor(np.array(v)) for k, v in classifier_params_to_torch(
        jax.tree.map(jnp.asarray, clf_params)).items()}
    ResNet50Classifier().load_state_dict(exported, strict=True)
    for k, v in exported.items():
        torch.testing.assert_close(v, sd[k], rtol=0, atol=0, msg=k)
    # A bare state dict loads as well.
    torch.save(sd, path)
    torch.testing.assert_close(load_classifier(path, "cpu").state_dict()["1.8.bias"], sd["1.8.bias"])
    if not torch.cuda.is_available():  # no device means CUDA, never a silent CPU
        with pytest.raises(RuntimeError, match="device='cpu'"):
            load_classifier(path)


# --- evaluation -------------------------------------------------------------------------

CROP = 32
EVAL_B = 2
# Three images of one size (a full chunk and a padded one) and two of another,
# smaller than the crop in H (the crop zero-pads), interleaved.
EVAL_SHAPES = [(36, 40), (28, 36), (36, 40), (28, 36), (36, 40)]


@pytest.fixture(scope="module")
def eval_setup(clf_params):
    """Shared weights and images, and JAX's composed pipeline's logits per image."""
    from artist_style_transfer_tpu.models.resnet import classifier_apply
    from artist_style_transfer_tpu.models.transformer import (
        init_transformer_params,
        transformer_apply,
    )
    from artist_style_transfer_tpu.ops.image import bgr_to_rgb, center_crop, torchvision_normalize

    tparams = numpy_params(init_transformer_params, 4)
    rng = np.random.default_rng(9)
    images = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for h, w in EVAL_SHAPES]

    @jax.jit
    def logits_fn(tp, cp, x):  # JAX infer/evaluate.py:27-48, the logits before the argmax
        out = jnp.floor(jnp.clip(transformer_apply(tp, x), 0.0, 255.0))
        rgb01 = bgr_to_rgb(center_crop(out, CROP)) / 255.0
        return classifier_apply(cp, torchvision_normalize(rgb01))

    jt, jc = jax.tree.map(jnp.asarray, tparams), jax.tree.map(jnp.asarray, clf_params)
    ref_logits = np.zeros((len(images), 19), np.float32)
    for shape in sorted(set(EVAL_SHAPES)):
        idx = [i for i, s in enumerate(EVAL_SHAPES) if s == shape]
        batch = np.stack([images[i] for i in idx]).astype(np.float32)
        ref_logits[idx] = np.asarray(logits_fn(jt, jc, jnp.asarray(batch)))
    model = TransformerNet()
    model.load_state_dict(transformer_state_dict_from_jax(tparams))
    return dict(tparams=tparams, clf_params=clf_params, images=images, ref_logits=ref_logits,
                model=model.eval(), classifier=port_classifier(clf_params))


def test_eval_logits_match_jax_pipeline(eval_setup):
    s = eval_setup
    for shape in sorted(set(EVAL_SHAPES)):
        idx = [i for i, sh in enumerate(EVAL_SHAPES) if sh == shape]
        batch = torch.from_numpy(np.stack([s["images"][i] for i in idx]))
        got = eval_logits(s["model"], s["classifier"], batch, crop_size=CROP).numpy()
        ref = s["ref_logits"][idx]
        assert np.abs(got - ref).max() <= 2e-3 * np.abs(ref).max(), shape
        np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))


def test_evaluate_with_classifier_matches_jax(eval_setup, capsys):
    """Mixed sizes with a padded final chunk: the same predictions and accuracy as JAX's
    ``evaluate_with_classifier``, which runs the same pipeline."""
    from artist_style_transfer_tpu.infer.evaluate import evaluate_with_classifier as jax_eval

    s = eval_setup
    preds = s["ref_logits"].argmax(-1)
    artist = int(preds[0])  # the class of the first image: a non-zero accuracy
    floats = [im.astype(np.float32) for im in s["images"]]
    ref_acc = jax_eval(jax.tree.map(jnp.asarray, s["tparams"]),
                       jax.tree.map(jnp.asarray, s["clf_params"]),
                       floats, artist, batch_size=EVAL_B, wordy=False, crop_size=CROP)
    capsys.readouterr()
    acc = evaluate_with_classifier(s["model"], s["classifier"], s["images"], artist,
                                   batch_size=EVAL_B, artists=ARTISTS_19, crop_size=CROP,
                                   device="cpu")
    assert acc == ref_acc == round(100.0 * (preds == artist).sum() / len(preds), 2) > 0
    out = capsys.readouterr().out.splitlines()
    assert out[-1] == f"Acc={acc}"
    assert out[:-1] == [f"Pred={ARTISTS_19[p]}\tActual={ARTISTS_19[artist]}\timage_num={i + 1}"
                        for i, p in enumerate(preds)]
    # fold_batch changes nothing; float input gives what uint8 gives.
    assert evaluate_with_classifier(s["model"], s["classifier"], floats, artist,
                                    batch_size=EVAL_B, wordy=False, fold_batch=True,
                                    crop_size=CROP, device="cpu") == acc


def test_evaluate_with_classifier_refusals(eval_setup):
    s = eval_setup
    args = (s["model"], s["classifier"], s["images"][:1], 0)
    # a world of one over gloo: the accuracy without a mesh
    from artist_style_transfer_tpu_torch.parallel import make_mesh

    with world_of_one():
        assert (evaluate_with_classifier(*args, mesh=make_mesh(device="cpu"), wordy=False,
                                         device="cpu")
                == evaluate_with_classifier(*args, wordy=False, device="cpu"))
    with pytest.raises(ValueError, match="not on"):
        evaluate_with_classifier(*args, device="meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            evaluate_with_classifier(*args)


@pytest.mark.parametrize("resize", [True, False])
def test_inference_cli_no_display_matches_direct_call(tmp_path, capsys, resize):
    """``--no-display`` on cv2-written JPEGs: the Acc= of a direct call on the same images.

    Without ``--resize_imgs`` the 100x100 image is below the reference's 224 floor
    and is skipped; the unreadable ``.jpg`` and the ``.png`` are skipped either way.
    """
    cv2 = pytest.importorskip("cv2")
    import random

    content = tmp_path / "content"
    content.mkdir()
    rng = np.random.default_rng(10)
    sizes = [(224, 232), (100, 100), (228, 224), (240, 224)]
    for i, (h, w) in enumerate(sizes):
        cv2.imwrite(str(content / f"c{i}.jpg"), rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
    (content / "broken.jpg").write_bytes(b"not a jpeg")
    cv2.imwrite(str(content / "skip.png"), np.zeros((8, 8, 3), np.uint8))
    model_dir = tmp_path / "models" / "Pablo_Picasso" / "random"
    model_dir.mkdir(parents=True)
    torch.save(TransformerNet().state_dict(), model_dir / "t.pth")
    clf = init_classifier(torch.Generator().manual_seed(2))
    torch.save({"model": clf.state_dict()}, tmp_path / "best-2.pth")

    argv = ["--no-display", "--artist", "Pablo_Picasso", "--model_filename", "t.pth",
            "--model_dir", str(tmp_path / "models"), "--content_dir", str(content),
            "--classifier_path", str(tmp_path / "best-2.pth"), "--num_images", "3",
            "--resize_size", "64", "--seed", "5", "--device", "cpu"]
    acc = inference.main(argv + ([] if resize else ["--no-resize_imgs"]))
    out = capsys.readouterr().out
    assert "Grabbed 3 images!" in out and out.rstrip().endswith(f"Acc={acc}")

    files = [f for f in os.listdir(content) if ".jpg" in f or ".JPEG" in f]  # the CLI's order
    random.Random(5).shuffle(files)
    images = [cv2.imread(str(content / f)) for f in files]
    images = [im for im in images if im is not None]
    if resize:
        images = [cv2.resize(im, (64, 64)) for im in images]
    else:
        images = [im for im in images if min(im.shape[:2]) >= 224]
    direct = evaluate_with_classifier(
        load_transfer_params(str(model_dir / "t.pth"), "cpu"), load_classifier(
            str(tmp_path / "best-2.pth"), "cpu"), images[:3],
        ARTISTS_19.index("Pablo_Picasso"), wordy=False, device="cpu")
    assert acc == direct
    # --quantize: the int8 pipeline, the Acc= of a direct quantized call on the same images.
    acc_q = inference.main(argv + ["--quantize"] + ([] if resize else ["--no-resize_imgs"]))
    assert capsys.readouterr().out.rstrip().endswith(f"Acc={acc_q}")
    assert acc_q == evaluate_with_classifier(
        load_transfer_params(str(model_dir / "t.pth"), "cpu"), load_classifier(
            str(tmp_path / "best-2.pth"), "cpu"), images[:3],
        ARTISTS_19.index("Pablo_Picasso"), wordy=False, quantize=True, device="cpu")
    assert argv[-2:] == ["--device", "cpu"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            inference.main(argv[:-2])
