"""The training CLI of the PyTorch port, and ``train()`` from directories, on the CPU
at 32x32 over a seeded workspace (``tests/test_torch_data.py``'s) and a VGG16
``.pth`` from ``init_vgg16``.

``train()`` from directories must give exactly the losses of ``train()`` given the
loaders' arrays through its hooks: the same arrays on the same device through
the same arithmetic.
"""

import json
import os

import numpy as np
import pytest
import torch

pytest.importorskip("cv2")

from artist_style_transfer_tpu_torch import train_style_transfer
from artist_style_transfer_tpu_torch.data import get_content_dataset, get_painting_dataset
from artist_style_transfer_tpu_torch.data.datasets import decoder_route, get_avg_dataset
from artist_style_transfer_tpu_torch.infer.stylize import load_transfer_params, stylize
from artist_style_transfer_tpu_torch.models.vgg import init_vgg16
from artist_style_transfer_tpu_torch.ops import precision
from artist_style_transfer_tpu_torch.train import train, train_from_config
from artist_style_transfer_tpu_torch.utils.config import TrainConfig
from tests.test_torch_data import one_torch_thread, write_workspace  # noqa: F401

SIZE = 32
ARTIST = "Artist_One"


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    root = tmp_path_factory.mktemp("ws")
    ws = write_workspace(root)
    ws["root"] = str(root)
    ws["vgg_path"] = str(root / "vgg16-00b39a1b.pth")
    torch.save(init_vgg16(torch.Generator().manual_seed(0)).state_dict(), ws["vgg_path"])
    return ws


def cli(ws, model_dir, *extra):
    return train_style_transfer.main([
        "--artist", ARTIST, "--num_epochs", "2", "--batch_size", "2", "--content_data_size", "4",
        "--train_size", str(SIZE), "--content_dir", ws["content"], "--archive_dir",
        ws["archive"], "--cache_dir", ws["cache"], "--vgg_path", ws["vgg_path"], "--model_dir",
        str(model_dir), "--device", "cpu", "--quiet", *extra])


def test_cli_trains_from_directories_and_writes_the_reference_artifacts(ws, tmp_path):
    model, losses = cli(ws, tmp_path, "--style_method", "random", "--save_every", "1")
    assert losses.shape == (2, 3) and np.isfinite(losses).all() and losses[1, 2] < losses[0, 2]
    d = tmp_path / ARTIST / "random"
    names = set(os.listdir(d))
    assert {"transfer_17-25_0.ckpt", "transfer_17-25_1.ckpt", "transfer_17-25_2.ckpt",
            "transfer_17-25_2.npy", "transfer_17-25_2.npz", "transfer_17-25_2.pth",
            "style.jpg", "metrics.jsonl"} <= names
    events = [json.loads(line) for line in open(d / "metrics.jsonl")]
    data = next(e for e in events if e["event"] == "data")
    assert data["content"]["decoder"] == data["paintings"]["decoder"] == decoder_route()
    assert data["content"]["images"] == 4 and data["paintings"]["images"] == 5
    probe = np.random.default_rng(0).uniform(0, 255, (1, SIZE, SIZE, 3)).astype(np.float32)
    reloaded = load_transfer_params(str(d / "transfer_17-25_2.pth"), "cpu")
    torch.testing.assert_close(stylize(reloaded, probe, clip=False, device="cpu"),
                               stylize(model, probe, clip=False, device="cpu"),
                               rtol=1e-5, atol=1e-3)


def test_cli_precision_follows_the_compute_dtype(ws, tmp_path):
    try:
        cli(ws, tmp_path, "--style_method", "average", "--num_epochs", "1",
            "--compute_dtype", "bfloat16", "--max_epochs_this_run", "1")
        assert precision.get_precision() == "default"
        cli(ws, tmp_path, "--style_method", "average", "--num_epochs", "1", "--resume")
        assert precision.get_precision() == "highest"
    finally:
        precision.set_precision("highest")
    names = os.listdir(tmp_path / ARTIST / "average")
    assert "style.jpg" in names and "transfer_17-25_1.pth" in names


LATER = [
    (["--qat", "--fold_batch", "on"], "batch->H folded"),
    (["--quantize_loss", "all", "--fold_batch", "vgg"], "quantize_loss='deep'"),
]


@pytest.mark.parametrize("flags,slice_name", LATER, ids=["".join(f) for f, _ in LATER])
def test_cli_flags_of_later_slices_reach_train(ws, tmp_path, flags, slice_name):
    with pytest.raises(NotImplementedError, match=slice_name):
        cli(ws, tmp_path, "--style_method", "cycle", *flags)
    assert not os.listdir(tmp_path)  # refused before anything was written


def test_cli_data_parallel_trains_as_a_world_of_one(ws, tmp_path):
    """``--data_parallel`` in a world of one over gloo: exactly the losses and the weights
    of the run without it (one rank's all-reduce is the identity)."""
    from tests.test_torch_distributed import world_of_one

    model, losses = cli(ws, tmp_path / "one", "--style_method", "cycle")
    with world_of_one():
        dp_model, dp_losses = cli(ws, tmp_path / "dp", "--style_method", "cycle",
                                  "--data_parallel")
    np.testing.assert_array_equal(dp_losses, losses)
    for k, v in model.state_dict().items():
        assert torch.equal(dp_model.state_dict()[k], v), k
    assert sorted(os.listdir(tmp_path / "dp" / ARTIST / "cycle")) == sorted(
        os.listdir(tmp_path / "one" / ARTIST / "cycle"))


@pytest.mark.parametrize("flags", [["--quantize_loss"], ["--qat", "all"],
                                   ["--quantize_gram", "on"]],
                         ids=["quantize_loss", "qat-all", "quantize_gram-on"])
def test_cli_int8_flags_train(ws, tmp_path, flags):
    """The int8 flags train from directories: one epoch, finite losses, a .pth that
    reloads."""
    _, losses = cli(ws, tmp_path, "--style_method", "cycle", "--num_epochs", "1", *flags)
    assert losses.shape == (1, 3) and np.isfinite(losses).all()
    model = load_transfer_params(str(tmp_path / ARTIST / "cycle" / "transfer_17-25_1.pth"),
                                 device="cpu")
    assert isinstance(model, torch.nn.Module)


DONE = [["--fold_batch", "on"], ["--fold_batch", "vgg"], ["--preview_every", "1"],
        ["--profile_dir"]]


@pytest.mark.parametrize("flags", DONE, ids=["".join(f) for f in DONE])
def test_cli_flags_of_done_items_run(ws, tmp_path, flags):
    """The flags of ROADMAP item 16 reach ``train()``, which now runs them: the fold is
    the direct path (the same losses), a preview figure every epoch, a trace of epoch 2."""
    if flags == ["--profile_dir"]:
        flags = flags + [str(tmp_path / "prof")]
    _, losses = cli(ws, tmp_path / "a", "--style_method", "random", *flags)
    d = tmp_path / "a" / ARTIST / "random"
    if flags[0] == "--fold_batch":
        _, plain = cli(ws, tmp_path / "b", "--style_method", "random")
        np.testing.assert_array_equal(losses, plain)
    elif flags[0] == "--preview_every":
        assert {"preview_0.png", "preview_1.png"} <= set(os.listdir(d))
    else:
        assert os.listdir(tmp_path / "prof") == ["trace_epoch2.json"]


def test_cli_defaults_match_the_jax_cli():
    from artist_style_transfer_tpu import train_style_transfer as jax_cli

    ours = vars(train_style_transfer.build_parser().parse_args([]))
    theirs = vars(jax_cli.build_parser().parse_args([]))
    assert ours.pop("device") is None
    assert ours == theirs


@pytest.mark.parametrize("mode", ["cycle", "average", "classifier"])
def test_train_from_directories_equals_train_from_hooks(ws, mode):
    """The loaders' arrays, passed through the hooks, give exactly the same run."""
    vgg = init_vgg16(torch.Generator().manual_seed(0))
    kw = dict(num_epochs=1, batch_size=2, content_data_size=4, train_size=SIZE, vgg=vgg,
              device="cpu", wordy=False, model_dir=None, seed=3)
    artist = "Pablo_Picasso" if mode == "classifier" else ARTIST
    if mode == "classifier":
        from artist_style_transfer_tpu_torch.models.resnet import init_classifier

        kw["classifier"] = init_classifier(torch.Generator().manual_seed(0))
    _, from_dirs = train(mode, artist, content_dir=ws["content"], archive_dir=ws["archive"],
                         cache_dir=ws["cache"], **kw)
    hooks = {"content_images": get_content_dataset(4, SIZE, SIZE, ws["content"], seed=3)}
    if mode == "cycle":
        hooks["paintings"] = get_painting_dataset(False, SIZE, SIZE, archive_dir=ws["archive"],
                                                  cache_dir=ws["cache"])[ARTIST]
    if mode == "average":
        hooks["avg_image"] = get_avg_dataset(SIZE, SIZE, archive_dir=ws["archive"],
                                             cache_dir=ws["cache"])[ARTIST]
    _, from_hooks = train(mode, artist, **hooks, **kw)
    np.testing.assert_array_equal(from_dirs, from_hooks)


def test_train_from_config_reads_data_dir(ws, tmp_path):
    cfg = TrainConfig(style_method="smartaverage", artist=ARTIST, num_epochs=1, batch_size=2,
                      content_data_size=4, train_size=SIZE, model_dir=str(tmp_path),
                      data_dir=os.path.join(ws["root"], "images"), device="cpu")
    vgg = init_vgg16(torch.Generator().manual_seed(0))
    _, losses = train_from_config(cfg, vgg=vgg, wordy=False, cache_dir=ws["cache"])
    assert losses.shape == (1, 3) and np.isfinite(losses).all()
    events = [json.loads(line)
              for line in open(tmp_path / ARTIST / "smartaverage" / "metrics.jsonl")]
    data = next(e for e in events if e["event"] == "data")
    assert data["content"]["source"] == "files" and data["paintings"]["images"] == 5
