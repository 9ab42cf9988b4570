"""Repairs and loose ends of the PyTorch port on the CPU (ROADMAP Queue 3 and item 16):

- the native decode pool's library is keyed on the host, so a library another host
  built is never loaded;
- ``save_figure`` writes the reference's 2-/3-panel figure with OpenCV where
  matplotlib is missing, in the same place as matplotlib's;
- the refusals of ``train()`` name the int8 items that bring them (10b, 10c);
- ``train()``'s ``fold_batch``, ``remat``, ``preview_every`` and ``profile_dir``;
- ``inference.run_from_config`` and the exports the JAX package has.

Tolerances: ``remat`` against the plain step's losses within 1e-6 relative (the
same ops recomputed); ``fold_batch`` equal (it selects nothing); the previews
are the files JAX's ``train()`` writes, of the same size and panel count.
"""

import inspect
import json
import os
import platform
import sys

import numpy as np
import pytest
import torch

import jax

from artist_style_transfer_tpu_torch.data import native_loader
from artist_style_transfer_tpu_torch.infer.stylize import save_figure
from artist_style_transfer_tpu_torch.models.vgg import init_vgg16
from artist_style_transfer_tpu_torch.train import loop as tloop
from artist_style_transfer_tpu_torch.train import train
from tests.test_torch_data import one_torch_thread  # noqa: F401

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
SIZE = 32


def panel_boxes(fig_bgr: np.ndarray) -> list[tuple[int, int]]:
    """The (first, last) columns of each panel of a figure: runs of columns that hold a
    non-white pixel in the middle band of rows, below the titles."""
    h = fig_bgr.shape[0]
    ink = (fig_bgr[int(h * 0.3):int(h * 0.7)] != 255).any(axis=(0, 2))
    edges = np.flatnonzero(np.diff(np.concatenate([[0], ink.astype(np.int8), [0]])))
    return [(int(a), int(b) - 1) for a, b in zip(edges[::2], edges[1::2])]


# --- the native decode pool: keyed on the host ----------------------------------------


def test_native_loader_never_loads_a_foreign_hosts_library(tmp_path, monkeypatch):
    assert native_loader.host_key().startswith(platform.machine())
    monkeypatch.setattr(native_loader, "BUILD_DIR", tmp_path)
    real_key = native_loader.host_key
    monkeypatch.setattr(native_loader, "host_key", lambda: "foreign-machine avx512f amx_tile")
    foreign = native_loader.library_path()
    foreign.write_bytes(b"\x7fELF a library another host built")
    monkeypatch.setattr(native_loader, "host_key", real_key)
    ours = native_loader.library_path()
    assert ours != foreign and ours.parent == foreign.parent
    for name, value in (("_tried", False), ("_lib", None), ("load_error", None)):
        monkeypatch.setattr(native_loader, name, value)
    if native_loader.available():  # this host builds its own and loads it
        assert ours.exists()
    else:  # or cannot build one; either way the foreign file was not what it tried
        assert str(foreign) not in native_loader.load_error
    assert foreign.read_bytes() == b"\x7fELF a library another host built"


# --- save_figure without matplotlib ------------------------------------------------------


@pytest.mark.parametrize("with_style", [False, True], ids=["2-panel", "3-panel"])
def test_save_figure_without_matplotlib_writes_the_same_panels(tmp_path, monkeypatch,
                                                                with_style):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(0)
    content = rng.integers(0, 256, (40, 60, 3)).astype(np.float32)
    out = rng.integers(0, 256, (40, 60, 3), dtype=np.uint8)
    style = rng.integers(0, 256, (30, 30, 3), dtype=np.uint8) if with_style else None
    try:  # matplotlib's figure first, where it is installed, to hold the two against
        import matplotlib  # noqa: F401

        mpl_path = str(tmp_path / "figs" / "mpl.png")
        save_figure(mpl_path, content, out, style)
    except ImportError:
        mpl_path = None
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # import matplotlib now raises
    path = str(tmp_path / "figs" / "cv2.png")
    save_figure(path, content, out, style)
    fig = cv2.imread(path)
    assert fig is not None and fig.shape == (500, 1800, 3)
    boxes = panel_boxes(fig)
    assert len(boxes) == (3 if with_style else 2)
    # In reference order: the first panel is the content, the last the transformed image.
    for (x0, x1), img in ((boxes[0], content), (boxes[-1], out)):
        rows = np.flatnonzero((fig[:, x0:x1 + 1] != 255).any(axis=(1, 2)))
        rows = rows[rows >= 50]  # below the titles
        y0, y1 = rows[0], rows[-1] + 1
        # The centre of each source pixel's block in the panel holds that pixel.
        ys = (y0 + (np.arange(img.shape[0]) + 0.5) * (y1 - y0) / img.shape[0]).astype(int)
        xs = (x0 + (np.arange(img.shape[1]) + 0.5) * (x1 + 1 - x0) / img.shape[1]).astype(int)
        np.testing.assert_array_equal(fig[ys][:, xs], img.astype(np.uint8))
    if mpl_path is None:
        return
    mpl = cv2.imread(mpl_path)
    assert mpl.shape == fig.shape
    assert len(panel_boxes(mpl)) == len(boxes)
    for (a0, a1), (b0, b1) in zip(panel_boxes(mpl), boxes):
        assert abs(a0 - b0) <= 3 and abs(a1 - b1) <= 3


def test_save_figure_needs_a_writer(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "cv2", None)
    img = np.zeros((8, 8, 3), np.uint8)
    with pytest.raises(RuntimeError, match="matplotlib or OpenCV"):
        save_figure(str(tmp_path / "f.png"), img, img)


# --- train(): the refusals, and the options of item 16 ------------------------------


@pytest.fixture(scope="module")
def hooks():
    rng = np.random.default_rng(0)
    return dict(
        content_images=rng.uniform(0, 255, (4, SIZE, SIZE, 3)).astype(np.float32),
        paintings=rng.uniform(0, 255, (3, SIZE, SIZE, 3)).astype(np.float32),
        vgg=init_vgg16(torch.Generator().manual_seed(0)),
        device="cpu",
        wordy=False,
    )


def run(hooks, mode="cycle", **kw):
    args = dict(batch_size=2, num_epochs=2, lr=0.01, seed=3, model_dir=None)
    args.update(kw)
    return train(mode, "A", **hooks, **args)


REFUSALS = [
    (dict(qat=True, fold_batch=True), "batch->H folded"),
    (dict(quantize_loss="all", fold_batch="vgg"), "use quantize_loss='deep'"),
    (dict(quantize_loss=3, fold_batch=True), "use quantize_loss='deep'"),
]


@pytest.mark.parametrize("kw,item", REFUSALS,
                         ids=["-".join(f"{k}={v}" for k, v in kw.items()) for kw, _ in REFUSALS])
def test_refusals_name_the_int8_items(hooks, tmp_path, kw, item):
    """The int8 options refuse only what JAX refuses: QAT with the full fold, and a
    quantized conv1_2..conv2_2 with either fold (JAX train/loop.py:301-315)."""
    with pytest.raises(NotImplementedError, match=item):
        run(hooks, model_dir=str(tmp_path), **kw)
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("fold", [True, "vgg"])
def test_train_fold_batch_runs_the_direct_path(hooks, fold):
    np.testing.assert_array_equal(run(hooks, fold_batch=fold)[1], run(hooks)[1])


def test_train_fold_batch_refuses_unknown_values(hooks):
    with pytest.raises(ValueError, match="fold_batch"):
        run(hooks, fold_batch="on")


@pytest.mark.parametrize("mode", ["cycle", "classifier"])
def test_train_remat_matches_the_plain_step(hooks, monkeypatch, mode):
    """remat recomputes the transformer's and the VGG's activations (torch.utils.checkpoint):
    the same losses, step by step, within 1e-6."""
    extra = {}
    if mode == "classifier":
        from artist_style_transfer_tpu_torch.models.resnet import ARTISTS_19, init_classifier

        extra = dict(classifier=init_classifier(torch.Generator().manual_seed(1)),
                     artist=ARTISTS_19[0])
    calls = []

    def counted(fn, *args, **kwargs):
        calls.append(fn)
        return torch.utils.checkpoint.checkpoint(fn, *args, **kwargs)

    monkeypatch.setattr(tloop, "checkpoint", counted)
    hooks = {k: v for k, v in hooks.items() if not (mode == "classifier" and k == "paintings")}

    def go(remat):
        args = dict(batch_size=2, num_epochs=2, lr=0.01, seed=3, model_dir=None, remat=remat)
        return train(mode, extra.get("artist", "A"), **hooks, **args,
                     **{k: v for k, v in extra.items() if k != "artist"})

    plain = go(False)[1]
    assert not calls
    remat = go(True)[1]
    assert len(calls) == 2 * 2 * 2  # the transformer and the VGG, 2 steps, 2 epochs
    np.testing.assert_allclose(remat, plain, rtol=1e-6, atol=0)


def test_train_preview_every_writes_what_jax_writes(hooks, tmp_path):
    """The preview figures of JAX ``train()`` (``train/api.py:390-406``): one every
    ``preview_every`` epochs from epoch 0, Content/Style/Transformed."""
    cv2 = pytest.importorskip("cv2")
    from artist_style_transfer_tpu.models.vgg import init_vgg16_params
    from artist_style_transfer_tpu.train import train as jax_train

    kw = dict(num_epochs=3, batch_size=2, preview_every=2, wordy=False, content_data_size=4)
    jax_train("random", "A", content_images=hooks["content_images"],
              paintings=hooks["paintings"], vgg_params=init_vgg16_params(jax.random.key(0)),
              model_dir=str(tmp_path / "jax"), **kw)
    train("random", "A", content_images=hooks["content_images"], paintings=hooks["paintings"],
          vgg=hooks["vgg"], device="cpu", model_dir=str(tmp_path / "port"), **kw)

    def previews(root):
        d = root / "A" / "random"
        return {f: cv2.imread(str(d / f)) for f in sorted(os.listdir(d)) if f.startswith("preview")}

    ours, theirs = previews(tmp_path / "port"), previews(tmp_path / "jax")
    assert list(ours) == list(theirs) == ["preview_0.png", "preview_2.png"]
    for name, fig in ours.items():
        assert fig.shape == theirs[name].shape
        assert len(panel_boxes(fig)) == len(panel_boxes(theirs[name])) == 3


def test_train_profile_dir_traces_the_second_epoch(hooks, tmp_path):
    prof = tmp_path / "prof"
    run(hooks, num_epochs=3, model_dir=str(tmp_path / "m"), profile_dir=str(prof))
    assert sorted(os.listdir(prof)) == ["trace_epoch2.json"]
    with open(prof / "trace_epoch2.json") as fh:
        trace = json.load(fh)
    assert any("conv" in ev.get("name", "") for ev in trace["traceEvents"])
    assert any(ev.get("name") == "ast:train.step" for ev in trace["traceEvents"])
    with open(tmp_path / "m" / "A" / "cycle" / "metrics.jsonl") as fh:
        events = [json.loads(line) for line in fh]
    written = [e for e in events if e["event"] == "profile_written"]
    assert len(written) == 1 and written[0]["dir"] == str(prof)


# --- inference: run_from_config, and the exports --------------------------------------


def test_run_from_config_is_the_cli(tmp_path):
    cv2 = pytest.importorskip("cv2")
    import shutil

    from artist_style_transfer_tpu_torch import InferenceConfig, inference

    model_dir = tmp_path / "models" / "Golden" / "cycle"
    model_dir.mkdir(parents=True)
    shutil.copy(os.path.join(GOLDENS, "golden_transfer.pth"), model_dir / "g.pth")
    cfg = InferenceConfig(style_method="cycle", artist="Golden", model_filename="g.pth",
                          model_dir=str(tmp_path / "models"), fig_dir=str(tmp_path / "a"),
                          content_img=os.path.join(GOLDENS, "content_landscape_256.png"),
                          content_size_w=64, device="cpu")
    fig = inference.run_from_config(cfg)
    cli = inference.main(["--style_method", "cycle", "--artist", "Golden", "--model_filename",
                          "g.pth", "--model_dir", str(tmp_path / "models"), "--fig_dir",
                          str(tmp_path / "b"), "--content_img", cfg.content_img,
                          "--content_size_w", "64", "--device", "cpu"])
    assert fig.endswith("Golden_cycle.png") and os.path.basename(cli) == os.path.basename(fig)
    np.testing.assert_array_equal(cv2.imread(fig), cv2.imread(cli))
    over = inference.run_from_config(cfg, fig_dir=str(tmp_path / "c"))  # overrides win
    assert over.startswith(str(tmp_path / "c"))


def test_exports_of_the_jax_package():
    import artist_style_transfer_tpu_torch as port
    from artist_style_transfer_tpu.infer.stylize import gaussian_blur_3x3 as jax_blur
    from artist_style_transfer_tpu.ops.image import rgb_to_bgr as jax_rgb_to_bgr
    from artist_style_transfer_tpu_torch import infer, models, ops
    from artist_style_transfer_tpu_torch.infer.stylize import gaussian_blur_3x3
    from artist_style_transfer_tpu_torch.utils import config

    assert port.TrainConfig is config.TrainConfig
    assert port.InferenceConfig is config.InferenceConfig
    for name in ("load_transfer_params", "stylize_batched", "stylize_int8",
                 "evaluate_with_classifier"):
        assert callable(getattr(infer, name)), name
    assert inspect.ismodule(infer.stylize)  # the submodule is not shadowed
    for name in ("TransformerNet", "init_transformer", "TRANSFORMER_PARAM_COUNT",
                 "quantize_transformer", "calibrate_transformer", "transformer_apply_int8",
                 "VGG16Features", "init_vgg16", "VGG_LAYER_NAMES", "ResNet50Classifier",
                 "init_classifier", "ARTISTS_19", "quantize_classifier",
                 "classifier_apply_int8"):
        assert hasattr(models, name), name
    from artist_style_transfer_tpu import ops as jax_ops

    jax_names = {n for n in vars(jax_ops) if not n.startswith("_")
                 and not inspect.ismodule(getattr(jax_ops, n))}
    assert jax_names <= set(vars(ops)), jax_names - set(vars(ops))
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 255, (2, 5, 6, 3)).astype(np.float32)
    np.testing.assert_array_equal(ops.rgb_to_bgr(torch.from_numpy(x)).numpy(),
                                  np.asarray(jax_rgb_to_bgr(x)))
    img = rng.integers(0, 256, (9, 11, 3), dtype=np.uint8)
    np.testing.assert_array_equal(gaussian_blur_3x3(img, 1.3), np.asarray(jax_blur(img, 1.3)))
