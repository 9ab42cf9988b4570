"""The int8 training options over a ('data', 'space') mesh in the PyTorch port: the
int8 Gram on row bands (``ops.gram.gram_matrix_int8_rows``, its int32 sum over the
ranks), the banded int8 VGG16 (``QuantizedVGG16Features.forward_rows``), the banded
QAT TransformerNet (``models.transformer_qat.transformer_apply_qat_rows``), the banded
'cycle' step with ``quantize_loss``, ``qat="all"`` and ``quantize_gram=True``, and
``train()`` over the mesh, on gloo ranks on the CPU.

As in ``tests/test_torch_spatial_train.py``, the port is held against JAX's
single-device step on the same global batch and against its own one process. Every
int8 product runs through its f64 plain version here (exact). Tolerances:

- the int8 Gram over 2 and 3 ranks (H = 10 and 7 over 2; 10 and 2 over 3, an empty
  band): the Gram bit-identical to the one process's ``gram_matrix_int8`` of the whole
  image (the band's int32 products summed in int32 equal the whole image's, and its
  scale is the max over the ranks), the input gradient within 1e-5 of the largest
  (measured 0);
- the banded int8 VGG16 ("deep" and "all") at 24x24 over (1, 2) and (1, 4) (relu4_3's
  3 rows leave one of four ranks empty): every dynamic scale bit-identical to the
  one process's and every tap within 1e-5 of its largest (so the int8 codes are the
  one process's; measured 0: the taps equal bit for bit);
- one banded 'cycle' step on (1, 2), (2, 2) and (1, 4) with every TransformerNet
  weight redrawn, for ``quantize_loss=True`` (the int8 VGG16 from conv3_1 and the int8
  Gram of relu3_3 and relu4_3), ``qat="all"`` (16 QAT convs, 3 of them lhs-dilated)
  and ``qat=True, quantize_gram=True`` (the int8 Gram of the real VGG16's taps), the
  ranks bit-identical, losses and scales too. Against the port's one process (no
  mesh): losses within rtol 1e-5 (measured 1.1e-7) and the whole gradient's relative
  L2 error within 1e-2 (measured 3.2e-7 without QAT, up to 2.2e-3 with it); each leaf
  within 1e-4 of its largest (of the net's largest for the leaves whose exact gradient
  is 0) without QAT (measured 9.9e-6), 0.25 with it (measured 1.0e-1). With QAT, some
  int8 code of the step lands on the other side of a .5 at every seed tried: an
  instance norm's sums over bands run in another order than the one process's, and
  the STE data gradient's halo rows are summed in f32 on their owner where the one
  process sums them in int32 before the dequant, so a scale or a value moves by an ulp
  (the one process's own gradients move by up to 7e-2 of a leaf's max when the
  content moves by one ulp). So each kind is also held in f64, at a seed whose f32
  step flips codes: the real values then differ by f64 rounding alone, every f32 value
  the quantizers read is the same, and the bands equal the one process within 1e-6 of
  each leaf's max. Against JAX's single-device ``jax.value_and_grad`` of its
  ``make_step_fns(..., use_pallas=False)`` loss: losses within rtol 1e-4 (measured
  6.2e-6) and the gradient's relative L2 error within 5e-2 (measured 2.0e-4 without
  QAT, 1.6e-2 with it, as far as the port's one process is from JAX: the two
  frameworks' real convs sum in other orders, so their codes part where one sits on
  a .5);
- ``train()`` over (1, 2), 2 epochs, 'cycle' with ``quantize_loss=True`` and with
  ``qat="all"``: per-step losses within rtol 1e-3 of the port's one process (a code
  flip in one step moves the next steps' losses by the quantization's noise; measured
  4.6e-5 for both), the ranks' parameters bit-identical.

Every launch has a time limit of its own (``launch(timeout_s=...)``), so a collective
that one rank misses fails the test instead of hanging the suite.
"""

import copy
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from artist_style_transfer_tpu.ops.precision import precision as jprecision
from artist_style_transfer_tpu_torch.parallel import launch, make_mesh, workers
from artist_style_transfer_tpu_torch.parallel.spatial import RowBands
from artist_style_transfer_tpu_torch.utils.jax_params import (
    quantized_vgg16_from_jax,
    transformer_state_dict_from_jax,
    transformer_state_dict_to_jax,
    vgg16_state_dict_from_jax,
)
from tests.test_torch_classifier import numpy_params
from tests.test_torch_data import one_torch_thread  # noqa: F401
from tests.test_torch_space_classifier import leaf_close, rel_l2
from tests.test_torch_spatial_train import close, redrawn_transformer
from tests.test_torch_train_loop import zero_grad_leaf

LAUNCH_S = 240  # each launch's own limit: a missed collective fails, never hangs

# --- the int8 Gram on bands ---------------------------------------------------------------

HEIGHTS = {2: (10, 7), 3: (10, 2)}
GN, GW, GC = 2, 3, 256


def gram_inputs(h: int) -> dict:
    rng = np.random.default_rng([h, 13])
    return {"f": np.maximum(rng.normal(size=(GN, h, GW, GC)), 0).astype(np.float32),
            "R": rng.normal(size=(GN, GC, GC)).astype(np.float32)}


def run_gram(h: int, bands: RowBands | None) -> dict:
    """The int8 Gram of the whole image (``bands`` None) or of this rank's band, and the
    input gradient of Σ G·R, the loss every rank holds whole."""
    from artist_style_transfer_tpu_torch.ops.gram import gram_matrix_int8, gram_matrix_int8_rows

    inputs = gram_inputs(h)
    f = torch.as_tensor(inputs["f"])
    if bands is not None:
        a, b = bands.bounds()
        f = f[:, a:b]
    f = f.clone().requires_grad_(True)
    g = gram_matrix_int8(f) if bands is None else gram_matrix_int8_rows(f, bands)
    (g * torch.as_tensor(inputs["R"])).sum().backward()
    return {"g": g.detach().numpy(), "df": f.grad.numpy()}


def gram_rank(mesh) -> dict:
    return {h: run_gram(h, RowBands.split(mesh, h)) for h in HEIGHTS[mesh.size]}


# --- the banded int8 VGG16 --------------------------------------------------------------

VGG_SIZE = 24


def vgg_case() -> dict:
    from artist_style_transfer_tpu.models.vgg import init_vgg16_params, quantize_vgg16_loss

    vgg = jax.tree.map(jnp.asarray, numpy_params(init_vgg16_params, 21))
    rng = np.random.default_rng(22)
    return {"x": rng.normal(0, 60, (2, VGG_SIZE, 16, 3)).astype(np.float32),
            **{layers: jax.tree.map(np.asarray, quantize_vgg16_loss(vgg, layers,
                                                                     dtype=jnp.float32))
               for layers in ("deep", "all")}}


def qvgg_rows_rank(mesh, shape, case: dict, layers: str) -> dict:
    """The int8 VGG16's taps on this rank's band over a mesh of ``shape`` (None: ``forward``
    on the whole images), and every dynamic scale it took."""
    vgg = quantized_vgg16_from_jax(case[layers])
    x = torch.as_tensor(case["x"])
    with workers.recorded_scales() as scales:
        if shape is None:
            taps = {k: v.numpy() for k, v in vgg(x).items()}
        else:
            m = workers.space_mesh(mesh, shape)
            bands = RowBands.split(m.axis_mesh("space"), x.shape[1])
            a, b = bands.bounds()
            taps = {k: v.contiguous().numpy() for k, (v, _) in
                    vgg.forward_rows(x[:, a:b], bands, mesh=m).items()}
    return {"taps": taps, "scales": np.asarray(scales)}


# --- the banded step against JAX's single device -------------------------------------------

STEP_SIZE, STEP_B, CW, SW = 32, 4, 17.0, 25.0
STEP_SEED = 2
KINDS = {"qloss": {"quantize_loss": True}, "qat_all": {"qat": "all"},
         "qat_qgram": {"qat": True, "quantize_gram": True}}
FLIP_SEEDS = {"qloss": 0, "qat_all": 1, "qat_qgram": 1}  # f32 steps that flip codes


def jax_vgg(quantize: bool):
    from artist_style_transfer_tpu.models.vgg import init_vgg16_params, quantize_vgg16_loss

    vgg = jax.tree.map(jnp.asarray, numpy_params(init_vgg16_params, 11))
    return quantize_vgg16_loss(vgg, "deep", dtype=jnp.float32) if quantize else vgg


def step_setup(kind: str, seed: int = STEP_SEED) -> dict:
    """The port's side of one 'cycle' step: the redrawn TransformerNet, JAX's VGG16 (or its
    int8 extractor) moved across, the global batch and the paintings."""
    from artist_style_transfer_tpu_torch.models.vgg import VGG16Features

    opts = KINDS[kind]
    nets = jax.tree.map(np.asarray, jax_vgg(bool(opts.get("quantize_loss"))))
    if opts.get("quantize_loss"):
        vgg = quantized_vgg16_from_jax(nets)
    else:
        vgg = VGG16Features()
        vgg.load_state_dict(vgg16_state_dict_from_jax(nets))
    rng = np.random.default_rng(500 + seed)
    return dict(model=redrawn_transformer(400 + seed), vgg=vgg,
                content=rng.uniform(0, 255, (STEP_B, STEP_SIZE, STEP_SIZE, 3)).astype(np.float32),
                paintings=rng.uniform(0, 255, (3, STEP_SIZE, STEP_SIZE, 3)).astype(np.float32),
                batch_size=STEP_B, content_weight=CW, style_weight=SW, step=1,
                qat=opts.get("qat", False), quantize_gram=opts.get("quantize_gram", "auto"))


def jax_step(setup: dict, kind: str):
    """JAX's single-device loss and parameter gradients of the same step."""
    from artist_style_transfer_tpu.train.loop import make_optimizer, make_step_fns
    from artist_style_transfer_tpu.train.loop import precompute_content_relu2_2 as jprecompute
    from artist_style_transfer_tpu.train.styles import build_style_targets as jbuild_targets

    opts = KINDS[kind]
    vgg = jax_vgg(bool(opts.get("quantize_loss")))
    params = jax.tree.map(jnp.asarray, transformer_state_dict_to_jax(setup["model"].state_dict()))
    with jprecision("highest"):
        targets = jbuild_targets("cycle", vgg, "X", paintings=setup["paintings"])
        fns = make_step_fns("cycle", vgg, None, targets, content_weight=CW, style_weight=SW,
                            batch_size=STEP_B, num_content=STEP_B,
                            tx=make_optimizer(1e-3, 0.0, 1, 1, 1), use_pallas=False,
                            qat=opts.get("qat", False),
                            quantize_gram=opts.get("quantize_gram", "auto"))
        data = jnp.asarray(setup["content"])
        r22 = jprecompute(vgg, data)
        (total, (c, s)), g = jax.jit(jax.value_and_grad(fns.loss_fn, has_aux=True))(
            params, data, r22, targets.grams, None, jnp.int32(setup["step"]))
    grads = {k: v.numpy() for k, v in
             transformer_state_dict_from_jax(jax.tree.map(np.asarray, g)).items()}
    return np.array([c, s, total], np.float64), grads


def f64_step_rank(mesh, shape, setup: dict) -> dict:
    """The banded step of :func:`workers.space_step_rank` in f64 over a ('data', 'space')
    mesh of ``shape`` (None: one process, no mesh): every parameter's synced gradient."""
    from artist_style_transfer_tpu_torch.ops.image import vgg_caffe_preprocess
    from artist_style_transfer_tpu_torch.train import loop, styles
    from tests.test_torch_spatial_train import gram_f64

    mesh = None if shape is None else workers.space_mesh(mesh, shape)
    model, vgg = copy.deepcopy(setup["model"]).double(), copy.deepcopy(setup["vgg"]).double()
    paintings = torch.as_tensor(setup["paintings"], dtype=torch.float64)
    grams = {k: gram_f64(v) for k, v in vgg(vgg_caffe_preprocess(paintings)).items()}
    targets = styles.StyleTargets("cycle", grams=grams, num_cycle=len(paintings))
    opt, sched = loop.make_optimizer(model.parameters(), 0.0, 0.0, 1, 1, 1)
    content = torch.as_tensor(setup["content"], dtype=torch.float64)
    fns = loop.make_step_fns("cycle", model, vgg, targets, opt, sched, content_weight=CW,
                             style_weight=SW, batch_size=STEP_B, num_content=STEP_B,
                             qat=setup["qat"], quantize_gram=setup["quantize_gram"], mesh=mesh)
    fns.step_fn(content, loop.precompute_content_relu2_2(vgg, content), setup["step"])
    return {k: p.grad.numpy().copy() for k, p in model.named_parameters()}


# --- train() over (1, 2) against one process ------------------------------------------------

TRAIN_SIZE, TRAIN_N, TRAIN_B = 32, 8, 4
TRAIN_CASES = {"cycle-quantize_loss": {"quantize_loss": True}, "cycle-qat_all": {"qat": "all"}}


def train_kwargs(case: str) -> dict:
    from artist_style_transfer_tpu_torch.models.vgg import init_vgg16

    rng = np.random.default_rng(8)
    s = TRAIN_SIZE
    return dict(style_method="cycle", artist="A", num_epochs=2, batch_size=TRAIN_B, seed=3,
                content_images=rng.uniform(0, 255, (TRAIN_N, s, s, 3)).astype(np.float32),
                paintings=rng.uniform(0, 255, (3, s, s, 3)).astype(np.float32),
                vgg=init_vgg16(torch.Generator().manual_seed(1)), save_every=0,
                wordy=False, lr=1e-3, log_every_batches=1, **TRAIN_CASES[case])


def step_losses(model_dir: str) -> np.ndarray:
    with open(os.path.join(model_dir, "A", "cycle", "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return np.array([[r["content_loss"], r["style_loss"], r["total_loss"]]
                     for r in rows if r["event"] == "batch"])


# --- launches: every check of a rank count in one ----------------------------------------


@pytest.fixture(scope="module")
def cases():
    return {"vgg": vgg_case(), **{k: step_setup(k) for k in KINDS},
            **{f"f64_{k}": step_setup(k, seed) for k, seed in FLIP_SEEDS.items()}}


@pytest.fixture(scope="module")
def two_ranks(cases, tmp_path_factory):
    root = tmp_path_factory.mktemp("space_int8")
    jobs = [(gram_rank, (), {})]
    jobs += [(qvgg_rows_rank, ((1, 2), cases["vgg"], layers), {}) for layers in ("deep", "all")]
    jobs += [(workers.space_step_rank, ((1, 2), cases[k]), {"record_scales": True})
             for k in KINDS]
    jobs += [(f64_step_rank, ((1, 2), cases[f"f64_{k}"]), {}) for k in KINDS]
    jobs += [(workers.train_rank, (dict(train_kwargs(name), model_dir=str(root / name)),),
              {"shape": (1, 2)}) for name in TRAIN_CASES]
    ranks = launch(workers.run_jobs, 2, jobs, backend="gloo", device="cpu", threads=2,
                   timeout_s=LAUNCH_S)
    return {"ranks": ranks, "root": root}


@pytest.fixture(scope="module")
def three_ranks():
    return launch(gram_rank, 3, backend="gloo", device="cpu", timeout_s=LAUNCH_S)


@pytest.fixture(scope="module")
def four_ranks(cases):
    jobs = [(qvgg_rows_rank, ((1, 4), cases["vgg"], layers), {}) for layers in ("deep", "all")]
    jobs += [(workers.space_step_rank, (shape, cases[k]), {"record_scales": True})
             for shape in ((2, 2), (1, 4)) for k in KINDS]
    jobs += [(f64_step_rank, ((1, 4), cases[f"f64_{k}"]), {}) for k in KINDS]
    return launch(workers.run_jobs, 4, jobs, backend="gloo", device="cpu", timeout_s=LAUNCH_S)


@pytest.fixture(scope="module")
def one_process(cases):
    mesh = make_mesh(device="cpu")
    return {k: workers.space_step_rank(mesh, None, cases[k], record_scales=True) for k in KINDS}


# --- the tests ------------------------------------------------------------------------------


@pytest.mark.parametrize("ranks", [2, 3])
def test_banded_int8_gram_is_the_one_process_gram(two_ranks, three_ranks, ranks):
    got_ranks = [r[0] for r in two_ranks["ranks"]] if ranks == 2 else three_ranks
    fake = type("FakeMesh", (), {"size": ranks, "rank": 0})()
    for h in HEIGHTS[ranks]:
        want = run_gram(h, None)
        bands = RowBands.split(fake, h)
        assert any(b == a for a, b in zip(bands.starts, bands.starts[1:])) == (h < ranks)
        for g in got_ranks:  # the int32 sum over the bands: bit for bit, on every rank
            np.testing.assert_array_equal(g[h]["g"], want["g"])
        assert close(np.concatenate([g[h]["df"] for g in got_ranks], axis=1), want["df"]), h


@pytest.mark.parametrize("layers", ["deep", "all"])
@pytest.mark.parametrize("shape", [(1, 2), (1, 4)], ids=["1x2", "1x4"])
def test_banded_int8_vgg16_takes_the_one_process_codes(two_ranks, four_ranks, cases, shape,
                                                       layers):
    i = ("deep", "all").index(layers)
    got = [r[1 + i] for r in two_ranks["ranks"]] if shape == (1, 2) else [r[i] for r in four_ranks]
    one = qvgg_rows_rank(None, None, cases["vgg"], layers)
    assert len(one["scales"]) == (6 if layers == "deep" else 9)
    for g in got:
        np.testing.assert_array_equal(g["scales"], one["scales"])
    for name, want in one["taps"].items():
        band = np.concatenate([g["taps"][name] for g in got], axis=1)
        assert close(band, want), name
    if shape == (1, 4):  # relu4_3's 3 rows leave the last rank none
        assert got[3]["taps"]["relu4_3"].shape[1] == 0


@pytest.fixture(scope="module")
def jax_steps(cases):
    return {k: jax_step(cases[k], k) for k in KINDS}


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (1, 4)], ids=["1x2", "2x2", "1x4"])
def test_banded_int8_step_matches_jax_and_one_process(two_ranks, four_ranks, one_process,
                                                      jax_steps, shape, kind):
    k = list(KINDS).index(kind)
    if shape == (1, 2):
        got = [r[3 + k] for r in two_ranks["ranks"]]
    else:
        got = [r[2 + len(KINDS) * [(2, 2), (1, 4)].index(shape) + k] for r in four_ranks]
    one = one_process[kind]
    assert len(got[0]["scales"]) == len(one["scales"]) > 0
    np.testing.assert_allclose(got[0]["losses"], one["losses"], rtol=1e-5)
    assert rel_l2(got[0]["grads"], one["grads"]) <= 1e-2
    leaf_close(got[0]["grads"], one["grads"], 0.25 if KINDS[kind].get("qat") else 1e-4)
    want_losses, want_grads = jax_steps[kind]
    np.testing.assert_allclose(got[0]["losses"], want_losses, rtol=1e-4)
    assert rel_l2(got[0]["grads"], want_grads) <= 5e-2
    for r in got[1:]:  # every rank holds the same synced gradients, losses and scales
        np.testing.assert_array_equal(r["losses"], got[0]["losses"])
        np.testing.assert_array_equal(r["scales"], got[0]["scales"])
        for name, g in r["grads"].items():
            np.testing.assert_array_equal(g, got[0]["grads"][name], err_msg=name)


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("shape", [(1, 2), (1, 4)], ids=["1x2", "1x4"])
def test_banded_int8_step_in_f64_matches_one_process(two_ranks, four_ranks, cases, shape, kind):
    """At these seeds the f32 step flips int8 codes between the bands and the one
    process. In f64 the real values differ by f64 rounding alone, so every f32 value the
    quantizers read is the same, and the bands equal the one process within 1e-6 of
    each leaf's max."""
    k = list(KINDS).index(kind)
    got = (two_ranks["ranks"][0][3 + len(KINDS) + k] if shape == (1, 2)
           else four_ranks[0][2 + 2 * len(KINDS) + k])
    want = f64_step_rank(None, None, cases[f"f64_{kind}"])
    top = max(np.abs(v).max() for v in want.values())
    for k, g in got.items():
        scale = top if zero_grad_leaf(k) else np.abs(want[k]).max()
        assert np.abs(g - want[k]).max() <= 1e-6 * scale, k


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_train_int8_over_data_space_mesh_matches_one_process(two_ranks, case):
    from artist_style_transfer_tpu_torch.train import train

    i = 3 + 2 * len(KINDS) + list(TRAIN_CASES).index(case)
    ranks = [r[i] for r in two_ranks["ranks"]]
    one_dir = str(two_ranks["root"] / f"{case}-one")
    _, losses = train(device="cpu", model_dir=one_dir, **train_kwargs(case))
    steps, want = step_losses(str(two_ranks["root"] / case)), step_losses(one_dir)
    assert steps.shape == want.shape == (2 * TRAIN_N // TRAIN_B, 3)
    assert np.isfinite(steps).all()
    np.testing.assert_allclose(steps, want, rtol=1e-3)
    np.testing.assert_allclose(ranks[0]["losses"], losses, rtol=1e-3)
    for r in ranks[1:]:  # one model on every rank
        np.testing.assert_array_equal(r["losses"], ranks[0]["losses"])
        for k, v in r["params"].items():
            np.testing.assert_array_equal(v, ranks[0]["params"][k], err_msg=k)
