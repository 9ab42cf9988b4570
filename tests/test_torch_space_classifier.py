"""'classifier' mode over a ('data', 'space') mesh in the PyTorch port: the banded
ResNet-50 (``ResNet50Classifier.forward_rows``, ``QuantizedClassifier.forward_rows``),
the primitives it needs (``parallel/spatial.py``'s 3x3/2 max pool, ``row_max`` and the
mean consumed whole), the banded 'classifier' step and ``train()`` over the mesh, on
gloo ranks on the CPU.

JAX runs no training over 'space' on the CPU (``tests/test_torch_spatial_train.py``
says why), so the port is held against JAX's single-device functions on the same
global batch, and against its own one process. Tolerances:

- each primitive over 2 and 3 ranks (H = 10: the pool's windows straddle two bands;
  H = 2 over 3: a band is empty), against one process's autograd on the whole image:
  outputs and input gradients within 1e-5 of the largest magnitude. ``row_max``'s input
  holds a channel of zeros (every position ties, as after a ReLU) and a channel whose
  max sits in two bands; its cotangent and the mean's pass through (a rule that summed
  them over the ranks would give gradients 2 or 3 times too large, which the test
  checks fails);
- ``ResNet50Classifier.forward_rows`` at 40x40 over (1, 2) and (1, 4) (the last stage's
  2 rows leave two of four ranks empty): logits within 2e-3 of JAX ``classifier_apply``'s
  largest with the same argmax (the ROADMAP bar; measured 1.1e-6), and within 1e-5 of
  the port's one process (measured 2.5e-7); the input gradient of Σ logits·R within
  1e-3 of JAX's largest (measured 1.0e-6) and 1e-5 of the one process's (measured
  5.5e-7);
- ``QuantizedClassifier.forward_rows`` against its one-process forward: every dynamic
  scale bit-identical (so every int8 code is the one process's), the bf16 logits equal;
- one banded 'classifier' step on (1, 2), (2, 2) and (1, 4) with the redrawn
  TransformerNet, f32 ResNet-50 and through the int8 ResNet-50 (and the int8 VGG16,
  as ``quantize_loss`` gives it), the ranks bit-identical. Against the port's one
  process (no mesh): losses within rtol 1e-5; every f32 gradient within 1e-4 of its
  leaf's largest (of the net's largest for the leaves whose exact gradient is 0;
  measured 5.8e-6), every int8 one within 2e-3 (measured 3.3e-4) with the relative L2
  error of the whole gradient within 1e-4 (measured 2.8e-5): the STE data gradient's
  halo rows are summed in f32 on their owner, where the one process sums them in
  int32 before the dequant, so a backward scale moves by an ulp and a cotangent code
  on a .5 flips. Against JAX's single-device ``jax.value_and_grad`` of its
  ``make_step_fns(..., use_pallas=False)`` loss: losses within rtol 1e-5 (f32,
  measured 1.1e-6) and 1e-3 (int8, measured 3.6e-5), the gradients' relative L2
  error within 3e-3 (measured 8.7e-4, the port's one process's own distance from JAX:
  at 32x32, B=4 a ReLU or max-pool decision of the ResNet-50 sits within f32 rounding
  of its boundary in every seed tried, and moves a whole gradient entry). The seed
  puts no such decision on another side in the bands than in the one process (two
  seeds of four tried do: up to 4.3e-2 of a leaf's max, in f32 as in int8);
- ``train()`` over (1, 2), 2 epochs, against the port's one process: 'classifier' f32
  and through the int8 classifier, per-step losses within rtol 1e-4 (measured 8.5e-7 and
  2.4e-5); ``fold_batch="vgg"``
  equal to the unfolded run bit for bit (the fold runs the direct banded path, as JAX
  folds nothing under a mesh of more than one device).

Every launch has a time limit of its own (``launch(timeout_s=...)``), so a collective
that one rank misses fails the test instead of hanging the suite.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from artist_style_transfer_tpu.ops.precision import precision as jprecision
from artist_style_transfer_tpu_torch.parallel import launch, make_mesh, workers
from artist_style_transfer_tpu_torch.parallel.spatial import (
    RowBands,
    max_pool_rows,
    row_max,
    row_mean,
)
from artist_style_transfer_tpu_torch.utils.jax_params import (
    classifier_state_dict_from_jax,
    quantized_classifier_from_jax,
    quantized_vgg16_from_jax,
    transformer_state_dict_from_jax,
    transformer_state_dict_to_jax,
    vgg16_state_dict_from_jax,
)
from tests.test_torch_classifier import numpy_params
from tests.test_torch_data import one_torch_thread  # noqa: F401
from tests.test_torch_spatial_train import close, redrawn_transformer
from tests.test_torch_train_loop import zero_grad_leaf

LAUNCH_S = 240  # each launch's own limit: a missed collective fails, never hangs

# --- the primitives ----------------------------------------------------------------------

PRIMITIVES = ("max_pool3", "row_max", "row_mean_whole")
HEIGHTS = {2: (10, 7), 3: (10, 2)}  # H = 10: windows straddle bands; H = 2 over 3: empty
N, C, W = 2, 4, 6


def case_inputs(name: str, h: int) -> dict:
    """x (NCHW, post-ReLU, channel 0 all zeros, channel 1's max in two bands: rows 0
    and h-1) and the output cotangent R."""
    rng = np.random.default_rng([PRIMITIVES.index(name), h, 7])
    x = np.maximum(rng.normal(size=(N, C, h, W)), 0).astype(np.float32)
    x[:, 0] = 0.0
    x[:, 1, 0, 1] = x[:, 1, h - 1, 2] = 9.0
    return {"x": x, "R": rng.normal(size=(N, C, 2 * h, W)).astype(np.float32)}


def apply_primitive(name: str, x: torch.Tensor, r: torch.Tensor, bands: RowBands | None,
                    wrong: bool = False):
    """The primitive and the loss whose input gradient the test compares: for the pool,
    Σ y·R over this rank's output band (the bands' losses add up); for the two head
    pools, Σ y·R of the pooled vector, which every rank holds whole. ``wrong``: the
    mean's cotangent summed over the ranks, the rule of a mean each band consumes."""
    if name == "max_pool3":
        if bands is None:
            y = torch.nn.functional.max_pool2d(x, 3, 2, 1)
            return y, (y * r[:, :, : y.shape[2], : y.shape[3]]).sum()
        y, rows = max_pool_rows(x, bands)
        a, b = rows.bounds()
        return y, (y * r[:, :, a:b, : y.shape[3]]).sum()
    if name == "row_max":
        y = x.amax(dim=(2, 3)) if bands is None else row_max(x, bands)
    else:
        y = (x.mean(dim=(2, 3)) if bands is None
             else row_mean(x, bands, replicated=not wrong)[:, :, 0, 0])
    return y, (y * r[:, :, 0, 0]).sum()


def run_primitive(name: str, h: int, bands: RowBands | None, wrong: bool = False) -> dict:
    inputs = case_inputs(name, h)
    x = torch.as_tensor(inputs["x"])
    if bands is not None:
        a, b = bands.bounds()
        x = x[:, :, a:b]
    x = x.contiguous(memory_format=torch.channels_last).requires_grad_(True)
    y, loss = apply_primitive(name, x, torch.as_tensor(inputs["R"]), bands, wrong)
    loss.backward()
    return {"y": y.detach().numpy(), "dx": x.grad.numpy()}


def primitives_rank(mesh) -> dict:
    out = {(name, h): run_primitive(name, h, RowBands.split(mesh, h))
           for name in PRIMITIVES for h in HEIGHTS[mesh.size]}
    out["wrong_mean"] = run_primitive("row_mean_whole", 10, RowBands.split(mesh, 10), True)
    return out


# --- the banded ResNet-50 against JAX's classifier_apply ----------------------------------

CLF_SIZE, CLF_B = 40, 2


def clf_case() -> dict:
    """JAX-layout classifier params drawn with numpy (random BN statistics), images and
    the logits' cotangent."""
    from artist_style_transfer_tpu.models.resnet import init_classifier_params

    rng = np.random.default_rng(41)
    return {"params": numpy_params(init_classifier_params, 5),
            "x": rng.normal(size=(CLF_B, CLF_SIZE, CLF_SIZE, 3)).astype(np.float32),
            "R": rng.normal(size=(CLF_B, 19)).astype(np.float32)}


def port_classifier(params: dict):
    from artist_style_transfer_tpu_torch.models.resnet import ResNet50Classifier

    model = ResNet50Classifier()
    model.load_state_dict(classifier_state_dict_from_jax(params))
    return model


def resnet_rows_rank(mesh, shape, case: dict) -> dict:
    """``forward_rows`` of the classifier on this rank's band over a mesh of ``shape``
    (None: ``forward`` on the whole images): the logits, and the band's gradient of
    Σ logits·R."""
    model = port_classifier(case["params"])
    x = torch.as_tensor(case["x"])
    if shape is None:
        x.requires_grad_(True)
        logits = model(x)
    else:
        space = workers.space_mesh(mesh, shape).axis_mesh("space")
        bands = RowBands.split(space, x.shape[1])
        a, b = bands.bounds()
        x = x[:, a:b].clone().requires_grad_(True)
        logits = model.forward_rows(x, bands)
    (logits * torch.as_tensor(case["R"])).sum().backward()
    return {"logits": logits.detach().numpy(), "dx": x.grad.numpy()}


def qclassifier_rows_rank(mesh, shape, qparams: dict, x: np.ndarray) -> dict:
    """The int8 classifier's logits from this rank's band over a mesh of ``shape`` (None:
    ``forward`` on the whole images), and every dynamic scale it took."""
    model = quantized_classifier_from_jax(qparams)
    xt = torch.as_tensor(x)
    with workers.recorded_scales() as scales:
        if shape is None:
            logits = model(xt)
        else:
            m = workers.space_mesh(mesh, shape)
            bands = RowBands.split(m.axis_mesh("space"), xt.shape[1])
            a, b = bands.bounds()
            logits = model.forward_rows(xt[:, a:b], bands, mesh=m)
    return {"logits": logits.float().numpy(), "scales": np.asarray(scales)}


def jax_qclassifier(case: dict) -> dict:
    from artist_style_transfer_tpu.models.resnet_q import quantize_classifier

    return jax.tree.map(np.asarray, quantize_classifier(jax.tree.map(jnp.asarray,
                                                                     case["params"])))


# --- the banded step against JAX's single device -------------------------------------------

STEP_SIZE, STEP_B, CW, SW = 32, 4, 17.0, 25.0
STEP_SEED = 3  # no ReLU or pool decision of its f32 step flips between bands and one process
ARTIST_INDEX = 0  # workers.space_step_rank's artist: ARTISTS_19[0]


def jax_nets(int8: bool) -> dict:
    """JAX's frozen nets (numpy draws), quantized as ``quantize_loss`` and
    ``quantize_classifier`` make them for the int8 step."""
    from artist_style_transfer_tpu.models.resnet import init_classifier_params
    from artist_style_transfer_tpu.models.resnet_q import quantize_classifier
    from artist_style_transfer_tpu.models.vgg import init_vgg16_params, quantize_vgg16_loss

    vgg = jax.tree.map(jnp.asarray, numpy_params(init_vgg16_params, 11))
    clf = jax.tree.map(jnp.asarray, numpy_params(init_classifier_params, 12))
    if int8:
        vgg = quantize_vgg16_loss(vgg, "deep", dtype=jnp.float32)
        clf = quantize_classifier(clf)
    return {"vgg": vgg, "clf": clf}


def step_setup(int8: bool, seed: int = 0) -> dict:
    """The port's side of one 'classifier' step: the redrawn TransformerNet, JAX's nets
    moved across, the global batch."""
    from artist_style_transfer_tpu_torch.models.vgg import VGG16Features

    nets = jax.tree.map(np.asarray, jax_nets(int8))
    if int8:
        vgg, clf = quantized_vgg16_from_jax(nets["vgg"]), quantized_classifier_from_jax(nets["clf"])
    else:
        vgg = VGG16Features()
        vgg.load_state_dict(vgg16_state_dict_from_jax(nets["vgg"]))
        clf = port_classifier(nets["clf"])
    rng = np.random.default_rng(300 + seed)
    return dict(mode="classifier", model=redrawn_transformer(200 + seed), vgg=vgg,
                classifier=clf,
                content=rng.uniform(0, 255, (STEP_B, STEP_SIZE, STEP_SIZE, 3)).astype(np.float32),
                batch_size=STEP_B, content_weight=CW, style_weight=SW, step=0)


def jax_step(setup: dict, int8: bool):
    """JAX's single-device loss and parameter gradients of the same step."""
    from artist_style_transfer_tpu.train.loop import make_optimizer, make_step_fns
    from artist_style_transfer_tpu.train.loop import precompute_content_relu2_2 as jprecompute
    from artist_style_transfer_tpu.train.styles import build_style_targets as jbuild_targets

    nets = jax_nets(int8)
    params = jax.tree.map(jnp.asarray, transformer_state_dict_to_jax(setup["model"].state_dict()))
    with jprecision("highest"):
        targets = jbuild_targets("classifier", nets["vgg"], "X", batch_size=STEP_B,
                                 artist_index=ARTIST_INDEX)
        fns = make_step_fns("classifier", nets["vgg"], nets["clf"], targets, content_weight=CW,
                            style_weight=SW, batch_size=STEP_B, num_content=STEP_B,
                            tx=make_optimizer(1e-3, 0.0, 1, 1, 1), use_pallas=False)
        data = jnp.asarray(setup["content"])
        r22 = jprecompute(nets["vgg"], data)
        (total, (c, s)), g = jax.jit(jax.value_and_grad(fns.loss_fn, has_aux=True))(
            params, data, r22, None, targets.labels, jnp.int32(setup["step"]))
    grads = {k: v.numpy() for k, v in
             transformer_state_dict_from_jax(jax.tree.map(np.asarray, g)).items()}
    return np.array([c, s, total], np.float64), grads


def rel_l2(got: dict, want: dict) -> float:
    num = sum(float(((got[k] - v).astype(np.float64) ** 2).sum()) for k, v in want.items())
    return float(np.sqrt(num / sum(float((v.astype(np.float64) ** 2).sum())
                                   for v in want.values())))


def leaf_close(got: dict, want: dict, rel: float) -> None:
    top = max(np.abs(v).max() for v in want.values())
    assert sorted(got) == sorted(want)
    for k, g in got.items():
        scale = top if zero_grad_leaf(k) else np.abs(want[k]).max()
        assert np.abs(g - want[k]).max() <= rel * scale, k


# --- train() over (1, 2) against one process ------------------------------------------------

TRAIN_SIZE, TRAIN_N, TRAIN_B = 32, 8, 4
TRAIN_CASES = {"classifier": {}, "classifier-int8": {"int8": True},
               "classifier-fold-vgg": {"fold_batch": "vgg"}}


def train_kwargs(case: str) -> dict:
    from artist_style_transfer_tpu_torch.models.resnet import ARTISTS_19, init_classifier
    from artist_style_transfer_tpu_torch.models.resnet_q import quantize_classifier
    from artist_style_transfer_tpu_torch.models.vgg import init_vgg16

    extra = TRAIN_CASES[case]
    rng = np.random.default_rng(6)
    s = TRAIN_SIZE
    clf = init_classifier(torch.Generator().manual_seed(2))
    kw = dict(style_method="classifier", artist=ARTISTS_19[3], num_epochs=2,
              batch_size=TRAIN_B, seed=3,
              content_images=rng.uniform(0, 255, (TRAIN_N, s, s, 3)).astype(np.float32),
              vgg=init_vgg16(torch.Generator().manual_seed(1)),
              classifier=quantize_classifier(clf) if extra.get("int8") else clf,
              save_every=0, wordy=False, lr=1e-3, log_every_batches=1)
    if extra.get("int8"):
        kw["quantize_loss"] = True
    if "fold_batch" in extra:
        kw["fold_batch"] = extra["fold_batch"]
    return kw


def step_losses(model_dir: str) -> np.ndarray:
    with open(os.path.join(model_dir, os.listdir(model_dir)[0], "classifier",
                           "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return np.array([[r["content_loss"], r["style_loss"], r["total_loss"]]
                     for r in rows if r["event"] == "batch"])


# --- launches: every check of a rank count in one ----------------------------------------


@pytest.fixture(scope="module")
def cases():
    case = clf_case()
    return {"clf": case, "qclf": jax_qclassifier(case), "f32": step_setup(False, STEP_SEED),
            "int8": step_setup(True, STEP_SEED)}


@pytest.fixture(scope="module")
def two_ranks(cases, tmp_path_factory):
    root = tmp_path_factory.mktemp("space_classifier")
    jobs = [(primitives_rank, (), {}),
            (resnet_rows_rank, ((1, 2), cases["clf"]), {}),
            (qclassifier_rows_rank, ((1, 2), cases["qclf"], cases["clf"]["x"]), {}),
            (workers.space_step_rank, ((1, 2), cases["f32"]), {}),
            (workers.space_step_rank, ((1, 2), cases["int8"]), {"record_scales": True})]
    jobs += [(workers.train_rank, (dict(train_kwargs(name), model_dir=str(root / name)),),
              {"shape": (1, 2)}) for name in TRAIN_CASES]
    ranks = launch(workers.run_jobs, 2, jobs, backend="gloo", device="cpu", threads=2,
                   timeout_s=LAUNCH_S)
    return {"ranks": ranks, "root": root}


@pytest.fixture(scope="module")
def three_ranks():
    return launch(primitives_rank, 3, backend="gloo", device="cpu", timeout_s=LAUNCH_S)


@pytest.fixture(scope="module")
def four_ranks(cases):
    jobs = [(resnet_rows_rank, ((1, 4), cases["clf"]), {}),
            (qclassifier_rows_rank, ((1, 4), cases["qclf"], cases["clf"]["x"]), {})]
    jobs += [(workers.space_step_rank, (shape, cases[k]), {"record_scales": k == "int8"})
             for shape in ((2, 2), (1, 4)) for k in ("f32", "int8")]
    return launch(workers.run_jobs, 4, jobs, backend="gloo", device="cpu", timeout_s=LAUNCH_S)


@pytest.fixture(scope="module")
def one_process(cases):
    mesh = make_mesh(device="cpu")
    return {k: workers.space_step_rank(mesh, None, cases[k], record_scales=k == "int8")
            for k in ("f32", "int8")}


# --- the tests ------------------------------------------------------------------------------


@pytest.mark.parametrize("ranks", [2, 3])
@pytest.mark.parametrize("name", PRIMITIVES)
def test_banded_head_primitives_match_one_process(two_ranks, three_ranks, name, ranks):
    got_ranks = [r[0] for r in two_ranks["ranks"]] if ranks == 2 else three_ranks
    fake = type("FakeMesh", (), {"size": ranks, "rank": 0})()  # only splits rows
    for h in HEIGHTS[ranks]:
        want = run_primitive(name, h, None)
        got = [g[(name, h)] for g in got_ranks]
        bands = RowBands.split(fake, h)
        assert any(b == a for a, b in zip(bands.starts, bands.starts[1:])) == (h < ranks)
        dx = np.concatenate([g["dx"] for g in got], axis=2)
        assert close(dx, want["dx"]), (name, h, "dx")
        if name == "max_pool3":
            assert close(np.concatenate([g["y"] for g in got], axis=2), want["y"]), (name, h)
        else:  # the same whole vector on every rank
            for g in got:
                assert close(g["y"], want["y"]), (name, h)
    if name == "row_max":  # the ties: every position of channel 0, two of channel 1
        assert np.count_nonzero(want["dx"][:, 1]) == 2 * N


@pytest.mark.parametrize("ranks", [2, 3])
def test_a_mean_consumed_whole_passes_its_cotangent_through(two_ranks, three_ranks, ranks):
    """The head's mean with the cotangent summed over the ranks (an instance norm's rule)
    gives each band ``ranks`` times its gradient: the rule matters, and the test of
    ``row_mean(replicated=True)`` above would catch the wrong one."""
    got_ranks = [r[0] for r in two_ranks["ranks"]] if ranks == 2 else three_ranks
    want = run_primitive("row_mean_whole", 10, None)
    wrong = np.concatenate([g["wrong_mean"]["dx"] for g in got_ranks], axis=2)
    np.testing.assert_allclose(wrong, ranks * want["dx"], rtol=1e-5)
    assert not close(wrong, want["dx"])


@pytest.fixture(scope="module")
def jax_classifier(cases):
    from artist_style_transfer_tpu.models.resnet import classifier_apply

    case = cases["clf"]
    params = jax.tree.map(jnp.asarray, case["params"])

    def loss(x):
        logits = classifier_apply(params, x)
        return (logits * jnp.asarray(case["R"])).sum(), logits

    with jprecision("highest"):
        (_, logits), dx = jax.jit(jax.value_and_grad(loss, has_aux=True))(jnp.asarray(case["x"]))
    return {"logits": np.asarray(logits), "dx": np.asarray(dx)}


@pytest.mark.parametrize("shape", [(1, 2), (1, 4)], ids=["1x2", "1x4"])
def test_banded_resnet50_matches_jax_and_one_process(two_ranks, four_ranks, cases,
                                                     jax_classifier, shape):
    got = ([r[1] for r in two_ranks["ranks"]] if shape == (1, 2)
           else [r[0] for r in four_ranks])
    one = resnet_rows_rank(None, None, cases["clf"])
    ref = jax_classifier
    dx = np.concatenate([g["dx"] for g in got], axis=1)
    for g in got:  # the same logits on every rank
        np.testing.assert_array_equal(g["logits"], got[0]["logits"])
    assert np.abs(got[0]["logits"] - ref["logits"]).max() <= 2e-3 * np.abs(ref["logits"]).max()
    assert (got[0]["logits"].argmax(1) == ref["logits"].argmax(1)).all()
    assert close(got[0]["logits"], one["logits"])
    assert np.abs(dx - ref["dx"]).max() <= 1e-3 * np.abs(ref["dx"]).max()
    assert close(dx, one["dx"])


@pytest.mark.parametrize("shape", [(1, 2), (1, 4)], ids=["1x2", "1x4"])
def test_banded_int8_resnet50_takes_the_one_process_scales(two_ranks, four_ranks, cases, shape):
    got = ([r[2] for r in two_ranks["ranks"]] if shape == (1, 2)
           else [r[1] for r in four_ranks])
    one = qclassifier_rows_rank(None, None, cases["qclf"], cases["clf"]["x"])
    assert len(one["scales"]) == 52  # each of the 52 int8 convs takes one
    for g in got:
        np.testing.assert_array_equal(g["scales"], one["scales"])
        np.testing.assert_array_equal(g["logits"], one["logits"])


@pytest.fixture(scope="module")
def jax_steps(cases):
    return {k: jax_step(cases[k], k == "int8") for k in ("f32", "int8")}


@pytest.mark.parametrize("kind", ["f32", "int8"])
@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (1, 4)], ids=["1x2", "2x2", "1x4"])
def test_banded_classifier_step_matches_jax_and_one_process(two_ranks, four_ranks, one_process,
                                                            jax_steps, shape, kind):
    if shape == (1, 2):
        got = [r[3 if kind == "f32" else 4] for r in two_ranks["ranks"]]
    else:
        got = [r[2 + 2 * [(2, 2), (1, 4)].index(shape) + (kind == "int8")] for r in four_ranks]
    one = one_process[kind]
    np.testing.assert_allclose(got[0]["losses"], one["losses"], rtol=1e-5)
    leaf_close(got[0]["grads"], one["grads"], 1e-4 if kind == "f32" else 2e-3)
    if kind == "int8":
        assert rel_l2(got[0]["grads"], one["grads"]) <= 1e-4
    want_losses, want_grads = jax_steps[kind]
    np.testing.assert_allclose(got[0]["losses"], want_losses,
                               rtol=1e-5 if kind == "f32" else 1e-3)
    assert rel_l2(got[0]["grads"], want_grads) <= 3e-3
    for r in got[1:]:  # every rank holds the same synced gradients, losses and scales
        np.testing.assert_array_equal(r["losses"], got[0]["losses"])
        for k, g in r["grads"].items():
            np.testing.assert_array_equal(g, got[0]["grads"][k], err_msg=k)
        if kind == "int8":
            np.testing.assert_array_equal(r["scales"], got[0]["scales"])


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_train_classifier_mode_over_data_space_mesh_matches_one_process(two_ranks, case):
    from artist_style_transfer_tpu_torch.train import train

    i = 5 + list(TRAIN_CASES).index(case)
    ranks = [r[i] for r in two_ranks["ranks"]]
    one_dir = str(two_ranks["root"] / f"{case}-one")
    kw = train_kwargs(case)
    kw.pop("fold_batch", None)  # the one process runs the direct path
    _, losses = train(device="cpu", model_dir=one_dir, **kw)
    steps = step_losses(str(two_ranks["root"] / case))
    want = step_losses(one_dir)
    assert steps.shape == want.shape == (2 * TRAIN_N // TRAIN_B, 3)
    assert np.isfinite(steps).all()
    np.testing.assert_allclose(steps, want, rtol=1e-4)
    np.testing.assert_allclose(ranks[0]["losses"], losses, rtol=1e-4)
    for r in ranks[1:]:  # one model on every rank
        np.testing.assert_array_equal(r["losses"], ranks[0]["losses"])
        for k, v in r["params"].items():
            np.testing.assert_array_equal(v, ranks[0]["params"][k], err_msg=k)
    if case == "classifier-fold-vgg":  # the fold runs the direct banded path
        direct = [r[5] for r in two_ranks["ranks"]][0]
        np.testing.assert_array_equal(ranks[0]["losses"], direct["losses"])
