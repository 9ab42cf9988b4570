"""``train()``, checkpoints and exports of the PyTorch port on the CPU: resume,
``.npz`` interop with the JAX package in both directions, the reference's
``transfer_``/``transfer2_`` naming, the ``.pth`` export, the refusals of
what later slices bring, the data arguments of ``train()``, and
``train_from_config``.

Tolerances: a resumed run equals an uninterrupted one exactly (same device,
same arithmetic); TransformerNet outputs across packages > 45 dB PSNR, the
f32 parity bar of the JAX package's torch oracles.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from artist_style_transfer_tpu_torch.infer.stylize import load_transfer_params
from artist_style_transfer_tpu_torch.models.transformer import TransformerNet, init_transformer
from artist_style_transfer_tpu_torch.models.vgg import init_vgg16
from artist_style_transfer_tpu_torch.train import checkpoint as tckpt
from artist_style_transfer_tpu_torch.train import train, train_from_config
from artist_style_transfer_tpu_torch.utils.config import TrainConfig
from artist_style_transfer_tpu_torch.utils.jax_params import transformer_state_dict_from_jax
from artist_style_transfer_tpu_torch.utils.logging import MetricLogger
from tests.test_torch_data import one_torch_thread  # noqa: F401
from tests.test_torch_distributed import space_mesh, world_of_one

SIZE = 32


def psnr(a, b) -> float:
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return float(10.0 * np.log10(255.0**2 / mse)) if mse > 0 else float("inf")


@pytest.fixture(scope="module")
def hooks():
    """In-memory data and VGG for train(): 4 content images, 3 paintings, seeded."""
    rng = np.random.default_rng(0)
    return dict(
        content_images=rng.uniform(0, 255, (4, SIZE, SIZE, 3)).astype(np.float32),
        paintings=rng.uniform(0, 255, (3, SIZE, SIZE, 3)).astype(np.float32),
        vgg=init_vgg16(torch.Generator().manual_seed(0)),
        device="cpu",
        wordy=False,
    )


def run(hooks, model_dir, **kw):
    args = dict(batch_size=2, num_epochs=2, lr=0.01, seed=3,
                model_dir=None if model_dir is None else str(model_dir))
    args.update(kw)
    return train("cycle", "Artist", **hooks, **args)


def test_resume_equals_uninterrupted(hooks, tmp_path):
    model_a, losses_a = run(hooks, tmp_path / "a")
    _, losses_b1 = run(hooks, tmp_path / "b", max_epochs_this_run=1)
    assert losses_b1[0, 0] > 0 and (losses_b1[1] == -1).all()
    model_b, losses_b = run(hooks, tmp_path / "b", resume=True)
    np.testing.assert_array_equal(losses_b, losses_a)
    for (k, a), b in zip(model_a.state_dict().items(), model_b.state_dict().values()):
        torch.testing.assert_close(b, a, rtol=0, atol=0, msg=k)
    events = [json.loads(line)["event"]
              for line in open(tmp_path / "b" / "Artist" / "cycle" / "metrics.jsonl")]
    assert events.count("resumed") == 1 and events.count("epoch") == 2


def test_train_writes_the_reference_artifacts(hooks, tmp_path):
    model, losses = run(hooks, tmp_path, save_every=1, log_every_batches=1)
    assert isinstance(model, TransformerNet) and losses.shape == (2, 3)
    assert losses.dtype == np.float64 and np.isfinite(losses).all()
    np.testing.assert_allclose(losses[:, 2], losses[:, 0] + losses[:, 1], rtol=1e-6)
    d = tmp_path / "Artist" / "cycle"
    names = set(os.listdir(d))
    assert {"transfer_17-25_0.ckpt", "transfer_17-25_1.ckpt", "transfer_17-25_2.ckpt",
            "transfer_17-25_2.npy", "transfer_17-25_2.npz", "transfer_17-25_2.pth",
            "metrics.jsonl"} <= names
    np.testing.assert_array_equal(np.load(d / "transfer_17-25_2.npy"), losses)
    records = [json.loads(line) for line in open(d / "metrics.jsonl")]
    batches = [r for r in records if r["event"] == "batch"]
    assert len(batches) == 4 and [r["batch"] for r in batches] == [1, 2, 1, 2]
    epoch_totals = [sum(r["total_loss"] for r in batches if r["epoch"] == e) for e in (1, 2)]
    np.testing.assert_allclose(epoch_totals, losses[:, 2], rtol=1e-6)
    x = torch.from_numpy(hooks["content_images"][:1])
    with torch.no_grad():
        want = model(x).numpy()
    for ext in ("pth", "npz"):
        loaded = load_transfer_params(str(d / f"transfer_17-25_2.{ext}"), device="cpu")
        with torch.no_grad():
            np.testing.assert_array_equal(loaded(x).numpy(), want)


def test_content_data_size_caps_the_corpus(hooks):
    """The first ``content_data_size`` hook images are the corpus: 2 of 4 at B=2 is one
    step an epoch, and the run equals one given just those 2 images."""
    _, capped = run(hooks, None, num_epochs=1, content_data_size=2)
    _, given = run(dict(hooks, content_images=hooks["content_images"][:2]), None, num_epochs=1)
    _, whole = run(hooks, None, num_epochs=1)
    np.testing.assert_array_equal(capped, given)
    assert not np.array_equal(capped, whole)


@pytest.mark.parametrize("mode", ["random", "average", "smartaverage"])
def test_train_other_gram_modes(hooks, tmp_path, mode):
    _, losses = train(mode, "Artist", num_epochs=1, batch_size=2, model_dir=str(tmp_path),
                      avg_image=hooks["paintings"].mean(0), **hooks)
    assert losses.shape == (1, 3) and np.isfinite(losses).all()


def test_train_bf16_epoch(hooks):
    model, losses = run(hooks, None, num_epochs=1, compute_dtype="bfloat16")
    assert losses.shape == (1, 3) and np.isfinite(losses).all()
    assert all(p.dtype == torch.float32 for p in model.parameters())


def test_export_pth_loads_into_the_torch_oracle(tmp_path):
    from tests.torch_ref import TorchTransformerNet

    model = init_transformer(torch.Generator().manual_seed(1))
    path = str(tmp_path / "t.pth")
    tckpt.export_pth(path, model)
    sd = torch.load(path, weights_only=True)
    assert all(v.dtype == torch.float64 and v.is_contiguous() for v in sd.values())
    oracle = TorchTransformerNet().double()
    oracle.load_state_dict(sd)  # strict: the reference keys, no more, no less
    x = np.random.default_rng(1).uniform(0, 255, (1, SIZE, SIZE, 3)).astype(np.float32)
    with torch.no_grad():
        ref = oracle(torch.from_numpy(x).double().permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        got = model(torch.from_numpy(x))
    assert psnr(got.numpy(), ref.numpy()) > 45.0


def test_port_npz_reads_in_jax(tmp_path):
    """JAX ``load_params_npz`` reads the port's .npz; its forward is > 45 dB from the port's."""
    from artist_style_transfer_tpu.infer.stylize import load_transfer_params as jax_load
    from artist_style_transfer_tpu.models.transformer import transformer_apply

    model = init_transformer(torch.Generator().manual_seed(2))
    path = str(tmp_path / "p.npz")
    tckpt.save_params_npz(path, model)
    params = jax_load(path)
    x = np.random.default_rng(2).uniform(0, 255, (2, SIZE, SIZE, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(transformer_apply)(params, jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert psnr(got, ref) > 45.0


def test_jax_npz_reads_in_the_port(tmp_path):
    from artist_style_transfer_tpu.models.transformer import (
        init_transformer_params,
        transformer_apply,
    )
    from artist_style_transfer_tpu.train.checkpoint import save_params_npz

    params = init_transformer_params(jax.random.key(4))
    path = str(tmp_path / "j.npz")
    save_params_npz(path, params)
    model = load_transfer_params(path, device="cpu")
    want = transformer_state_dict_from_jax(jax.tree.map(np.asarray, params))
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=0)
    x = np.random.default_rng(4).uniform(0, 255, (2, SIZE, SIZE, 3)).astype(np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert psnr(got, np.asarray(jax.jit(transformer_apply)(params, jnp.asarray(x)))) > 45.0


def test_transfer2_prefix_naming(hooks, tmp_path):
    from artist_style_transfer_tpu.train import checkpoint as jckpt

    first = tckpt.save_dir_prefix(str(tmp_path), "A", "cycle", 17.0, 25.0)
    assert first == jckpt.save_dir_prefix(str(tmp_path), "A", "cycle", 17.0, 25.0)
    assert first.endswith("transfer_17-25")
    open(first + "_0.npy", "w").close()
    second = tckpt.save_dir_prefix(str(tmp_path), "A", "cycle", 17.0, 2.5)
    assert second == jckpt.save_dir_prefix(str(tmp_path), "A", "cycle", 17.0, 2.5)
    assert second.endswith("transfer2_17-2.5")
    assert tckpt.save_dir_prefix(str(tmp_path), "A", "cycle", 17, 25, bump=False) == first
    # A second train() in a used directory writes under transfer2_.
    run(hooks, tmp_path / "m", num_epochs=1)
    run(hooks, tmp_path / "m", num_epochs=1)
    names = os.listdir(tmp_path / "m" / "Artist" / "cycle")
    assert "transfer_17-25_1.pth" in names and "transfer2_17-25_1.pth" in names


@pytest.mark.parametrize("w", [17, 17.0, 2.5, 0.001, 1e-4])
def test_fmt_weight_matches_jax(w):
    from artist_style_transfer_tpu.train.checkpoint import fmt_weight

    assert tckpt.fmt_weight(w) == fmt_weight(w)


def test_resume_prefix_and_latest_checkpoint_match_jax(tmp_path):
    """Both packages pick the same stem and epoch from the same directory."""
    from artist_style_transfer_tpu.train import checkpoint as jckpt

    root = str(tmp_path)
    with pytest.warns(UserWarning, match="starting fresh"):
        fresh = tckpt.resume_prefix(root, "A", "m", 17, 25)
    assert fresh.endswith("transfer_17-25")
    model = TransformerNet()
    d = tmp_path / "A" / "m"
    tckpt.save_checkpoint(str(d / "transfer_17-25"), 3, model)
    tckpt.save_checkpoint(str(d / "transfer_17-25"), 10, model)
    os.utime(d / "transfer_17-25_10.ckpt", (1, 1))  # older than what follows
    tckpt.save_checkpoint(str(d / "transfer2_17-25"), 1, model)
    assert tckpt.resume_prefix(root, "A", "m", 17, 25) == jckpt.resume_prefix(root, "A", "m", 17, 25)
    assert tckpt.resume_prefix(root, "A", "m", 17, 25).endswith("transfer2_17-25")
    prefix = str(d / "transfer_17-25")
    assert tckpt.latest_checkpoint(prefix) == jckpt.latest_checkpoint(prefix)
    assert tckpt.latest_checkpoint(prefix)[1] == 10


def test_checkpoint_roundtrip_restores_model_and_optimizer(tmp_path):
    from artist_style_transfer_tpu_torch.train.loop import make_optimizer

    model = init_transformer(torch.Generator().manual_seed(5))
    opt, sched = make_optimizer(model.parameters(), 0.01, 1e-4, 4, 2, 1)
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    sched.step()
    path = tckpt.save_checkpoint(str(tmp_path / "c"), 0, model, opt, sched, np.zeros((4, 3)))
    other = init_transformer(torch.Generator().manual_seed(6))
    opt2, sched2 = make_optimizer(other.parameters(), 0.01, 1e-4, 4, 2, 1)
    assert tckpt.restore_checkpoint(path, other, opt2, sched2) == 1
    for a, b in zip(model.state_dict().values(), other.state_dict().values()):
        assert torch.equal(a, b)
    assert opt2.state_dict()["state"][0]["step"] == 1
    assert sched2.last_epoch == sched.last_epoch == 1
    assert opt2.param_groups[0]["lr"] == opt.param_groups[0]["lr"]


UNPORTED = [
    (dict(mesh=space_mesh()), "item 12b"),
    (dict(qat=True, fold_batch=True), "batch->H folded"),
    (dict(quantize_loss="all", fold_batch=True), "use quantize_loss='deep'"),
]


@pytest.mark.parametrize("kw,slice_name", UNPORTED,
                         ids=["-".join(f"{k}={v!r}"[:24] for k, v in kw.items()) for kw, _ in UNPORTED])
def test_train_refuses_what_later_slices_bring(hooks, tmp_path, kw, slice_name):
    """A mesh with a 'space' axis waits for item 12b; the int8 options refuse what JAX
    refuses."""
    args = dict(hooks, style_method="cycle", artist="A", num_epochs=1, batch_size=2,
                model_dir=str(tmp_path))
    args.update(kw)
    with pytest.raises(NotImplementedError, match=slice_name):
        train(**args)
    assert not os.listdir(tmp_path)  # refused before anything was written


@pytest.mark.parametrize("kw", [dict(qat=True), dict(quantize_loss=True), dict(quantize_gram=True)],
                         ids=["qat", "quantize_loss", "quantize_gram"])
def test_train_runs_the_int8_options_and_checkpoints(hooks, tmp_path, kw):
    """Each int8 option trains one tiny epoch and writes its checkpoint and exports."""
    _, losses = run(hooks, tmp_path, num_epochs=1, **kw)
    assert losses.shape == (1, 3) and np.isfinite(losses).all()
    names = os.listdir(tmp_path / "Artist" / "cycle")
    assert {"transfer_17-25_1.ckpt", "transfer_17-25_1.pth"} <= set(names)


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    pytest.importorskip("cv2")
    from tests.test_torch_data import write_workspace

    return write_workspace(tmp_path_factory.mktemp("ws"))


def data_record(model_dir) -> dict:
    events = [json.loads(line)
              for line in open(os.path.join(model_dir, "Artist_One", "cycle", "metrics.jsonl"))]
    return next(e for e in events if e["event"] == "data")


# What the data-pipeline slice brought, each once refused: the loaders read the
# workspace where a hook is None, and a loader argument beside a hook changes nothing.
DATA_ARGS = [
    (dict(content_stream="stream"), "stream"),
    (dict(content_images=None), "files"),
    (dict(paintings=None), "hook"),
    (dict(style_method="average", avg_image=None), "hook"),
    (dict(train_size=SIZE), "hook"),
    (dict(content_dir="c/"), "hook"),
    (dict(archive_dir="a/"), "hook"),
    (dict(cache_dir="d/"), "hook"),
]


@pytest.mark.parametrize("kw,content_source", DATA_ARGS,
                         ids=["-".join(f"{k}={v!r}"[:24] for k, v in kw.items())
                              for kw, _ in DATA_ARGS])
def test_train_takes_what_the_data_slice_brings(hooks, workspace, tmp_path, kw, content_source):
    common = dict(hooks, artist="Artist_One", num_epochs=1, batch_size=2)
    args = dict(common, style_method="cycle", model_dir=str(tmp_path))
    args.update(kw)
    if content_source != "hook" or "paintings" in kw or "avg_image" in kw:
        for k in ("content", "archive", "cache"):
            args.setdefault(f"{k}_dir", workspace[k])
        args.setdefault("train_size", SIZE)
    if kw.get("content_stream"):
        content = hooks["content_images"]
        args.update(content_images=None,
                    content_stream=lambda epoch: (content[i : i + 2] for i in (0, 2)))
    _, losses = train(**args)
    assert losses.shape == (1, 3) and np.isfinite(losses).all()
    if args["style_method"] == "cycle":
        rec = data_record(tmp_path)
        assert rec["content"]["source"] == content_source
        assert ("paintings" in rec) == (args["paintings"] is None)
    if len(args) == len(common) + 3:  # a loader argument beside every hook
        # The hooks win: the loaders' argument changes nothing.
        np.testing.assert_array_equal(
            losses, train(**common, style_method="cycle", model_dir=None)[1])


def test_train_device_and_mode_checks(hooks, tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal where CUDA is absent")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train("cycle", "A", num_epochs=1, batch_size=2, model_dir=None,
              **dict(hooks, device=None))
    assert train("nope", "A", model_dir=str(tmp_path), **hooks) == 0
    assert "enter valid style method!" in capsys.readouterr().out


def test_train_from_config(hooks, tmp_path):
    cfg = TrainConfig(style_method="cycle", artist="Cfg", num_epochs=1, batch_size=2,
                      model_dir=str(tmp_path), device="cpu")
    model, losses = train_from_config(cfg, content_images=hooks["content_images"],
                                      paintings=hooks["paintings"], vgg=hooks["vgg"], wordy=False)
    assert losses.shape == (1, 3) and os.path.exists(tmp_path / "Cfg" / "cycle" / "transfer_17-25_1.pth")
    # mesh_shape=(1,): a world of one over gloo trains exactly as without a mesh
    with world_of_one():
        _, dp = train_from_config(TrainConfig(**dict(cfg.__dict__, model_dir=None,
                                                     mesh_shape=(1,))),
                                  content_images=hooks["content_images"],
                                  paintings=hooks["paintings"], vgg=hooks["vgg"], wordy=False)
    np.testing.assert_array_equal(dp, losses)
    with pytest.raises(FileNotFoundError, match="elsewhere/content/"):
        train_from_config(TrainConfig(data_dir=str(tmp_path / "elsewhere"), device="cpu"),
                          vgg=hooks["vgg"], wordy=False, model_dir=None)
    with pytest.raises(TypeError, match="TrainConfig"):
        train_from_config(dataclasses.asdict(cfg))


def test_metric_logger_writes_jsonl(tmp_path, capsys):
    log = MetricLogger(jsonl_path=str(tmp_path / "x" / "m.jsonl"), stdout=True)
    log.log("epoch", loss=1.5, epoch=1)
    log.log("batch", loss=2.0, stdout=False)
    log.close()
    recs = [json.loads(line) for line in open(tmp_path / "x" / "m.jsonl")]
    assert [r["event"] for r in recs] == ["epoch", "batch"] and recs[0]["loss"] == 1.5
    err = capsys.readouterr().err
    assert "[epoch] loss=1.5000\tepoch=1" in err and "batch" not in err
