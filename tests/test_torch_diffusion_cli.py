"""The diffusion CLI of the PyTorch port (``python -m
artist_style_transfer_tpu_torch.diffusion.cli``) on the CPU: the JAX package's CLI case
(``tests/test_clis.py``, train, DDPM, DDIM and DPM++ sampling, the label-space
refusal, eval) rerun with ``--device cpu`` on a seeded workspace in the reference
layout; a JAX-trained ``diff_model.npz`` (with its ``.labels.json``) sampled by the
port; the missing-sidecar warning and the guidance label space; and the refusals of a
CUDA device where there is no CUDA.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax

from artist_style_transfer_tpu.diffusion.train import train_diffusion as jtrain_diffusion
from artist_style_transfer_tpu.train.checkpoint import save_params_npz as jsave_params_npz
from artist_style_transfer_tpu_torch.diffusion import cli
from artist_style_transfer_tpu_torch.diffusion import (
    GaussianDiffusion,
    diff_sample,
    init_diff_model,
    train_diffusion,
)
from artist_style_transfer_tpu_torch.diffusion.evaluate import classifier_features
from artist_style_transfer_tpu_torch.models.resnet import init_classifier
from artist_style_transfer_tpu_torch.train.checkpoint import load_diff_model_npz, save_params_npz
from artist_style_transfer_tpu_torch.utils.jax_params import diff_model_state_dict_from_jax
from tests.test_torch_data import one_torch_thread  # noqa: F401

cv2 = pytest.importorskip("cv2")

SMALL = ["--image_size", "16", "--num_timesteps", "8", "--base_channels", "32",
         "--device", "cpu"]


@pytest.fixture()
def workspace(tmp_path, monkeypatch):
    """images/archive (two artists, seeded paintings) and models/best-2.pth (a seeded
    classifier as fastai's ``{'model': sd}``), the reference layout."""
    rng = np.random.default_rng(0)
    resized = tmp_path / "images" / "archive" / "resized" / "resized"
    resized.mkdir(parents=True)
    (tmp_path / "dicts").mkdir()
    (tmp_path / "models").mkdir()
    with open(tmp_path / "images" / "archive" / "artists.csv", "w") as f:
        f.write("id,name,paintings\n0,Alfred Sisley,2\n1,Some Painter,2\n")
    for name in ("Alfred_Sisley", "Some_Painter"):
        for i in (1, 2):
            img = (rng.random((40, 48, 3)) * 255).astype(np.uint8)
            cv2.imwrite(str(resized / f"{name}_{i}.jpg"), img)
    clf = init_classifier(torch.Generator().manual_seed(0))
    torch.save({"model": clf.state_dict()}, tmp_path / "models" / "best-2.pth")
    monkeypatch.chdir(tmp_path)
    return tmp_path


def test_diffusion_cli_train_and_sample(workspace):
    model_path = cli.main(["train", "--num_epochs", "1", "--batch_size", "2",
                           "--out", "models/diffusion/diff_model.npz", *SMALL])
    assert os.path.exists(model_path)
    with open(model_path + ".labels.json") as f:
        assert json.load(f)["names"] == ["Alfred_Sisley", "Some_Painter"]
    sample = ["sample", "--model", model_path, "--artist", "Alfred_Sisley",
              "--num_samples", "2", *SMALL]
    for extra, name in (([], "ddpm"), (["--ddim_steps", "4"], "ddim"),
                        (["--dpmpp_steps", "4"], "dpmpp"),
                        (["--ddim_steps", "4", "--guidance_scale", "1.0"], "guided")):
        out = cli.main(sample + extra + ["--out", f"figs/{name}.png"])
        grid = cv2.imread(out)
        assert grid is not None and grid.shape == (16, 32, 3), name
    # an artist outside the model's label space fails loudly
    with pytest.raises(SystemExit):
        cli.main(["sample", "--model", model_path, "--artist", "Edgar_Degas", *SMALL])
    # guidance needs an artist of the classifier's 19
    with pytest.raises(SystemExit):
        cli.main(["sample", "--model", model_path, "--artist", "Some_Painter",
                  "--guidance_scale", "1.0", *SMALL])
    score = cli.main(["eval", "--model", model_path, "--artist", "Alfred_Sisley",
                      "--num_samples", "2", "--sample_batch", "2", *SMALL])
    assert np.isfinite(score) and score >= 0.0


def test_port_cli_samples_a_jax_trained_model(workspace):
    """A model trained and saved by the JAX package loads bit-exactly and samples."""
    rng = np.random.default_rng(3)
    imgs = (rng.random((4, 16, 16, 3)) * 255).astype(np.float32)
    params, _, _ = jtrain_diffusion(imgs, np.array([0, 1, 0, 1]), num_classes=2,
                                    num_timesteps=8, num_epochs=1, batch_size=2,
                                    base_channels=32, wordy=False)
    os.makedirs("models/diffusion")
    path = "models/diffusion/jax_model.npz"
    jsave_params_npz(path, params)
    with open(path + ".labels.json", "w") as f:
        json.dump({"names": ["Alfred_Sisley", "Some_Painter"]}, f)
    sd, want = load_diff_model_npz(path), diff_model_state_dict_from_jax(
        jax.tree.map(np.asarray, params))
    assert sd.keys() == want.keys() and all(torch.equal(sd[k], want[k]) for k in want)
    out = cli.main(["sample", "--model", path, "--artist", "Some_Painter", "--num_samples",
                    "3", "--dpmpp_steps", "3", "--out", "figs/jax.png", *SMALL])
    assert cv2.imread(out).shape == (16, 48, 3)


def test_missing_sidecar_assumes_artists_19(workspace):
    model = init_diff_model(19, 32, generator=torch.Generator().manual_seed(1))
    os.makedirs("models/diffusion")
    save_params_npz("models/diffusion/legacy.npz", model)
    with pytest.warns(UserWarning, match="ARTISTS_19"):
        out = cli.main(["sample", "--model", "models/diffusion/legacy.npz", "--artist",
                        "Vincent_van_Gogh", "--num_samples", "1", "--ddim_steps", "2",
                        "--out", "figs/legacy.png", *SMALL])
    assert os.path.exists(out)


def test_cuda_device_without_cuda_raises(workspace):
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here: nothing to refuse")
    model = init_diff_model(2, 32, generator=torch.Generator().manual_seed(0))
    imgs = np.zeros((2, 16, 16, 3), np.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_diffusion(imgs, np.array([0, 1]), num_classes=2, num_timesteps=8, num_epochs=1,
                        batch_size=2, base_channels=32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        diff_sample(model, GaussianDiffusion.make(8), torch.Generator(), [0], shape=(16, 16))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        classifier_features(init_classifier(torch.Generator().manual_seed(0)), imgs)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["train", "--num_epochs", "1", "--image_size", "16"])
    # a model on another device than the one named
    with pytest.raises(ValueError, match="not on"):
        diff_sample(model, GaussianDiffusion.make(8), torch.Generator(), [0], shape=(16, 16),
                    device="meta")
