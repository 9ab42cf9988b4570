"""Artist-classifier training in the PyTorch port (``train/classifier.py``, train-mode BN,
the ``best-2.pth`` export) held against the JAX package on the CPU.

Inputs come from numpy seeds; JAX classifier weights (``numpy_params``) are carried to
the port by ``classifier_state_dict_from_jax``. Tolerances:

- ``batch_norm_train``: 1e-5 (one f32 BN, summed in another order);
- ``classifier_apply_train`` at 32x32, B=4: the train-mode ResNet-50 on random weights is
  ill-conditioned in f32 (each BN over 4 images rescales rounding noise; the port's own
  f32 logits are 3e-3 of max|logit| from its f64 ones), so 1e-4 is below what f32 can
  give. The logits and every BN statistic are held within 3x the port's own f32 error
  (its f32 forward against its f64 forward) plus 1e-6 of their magnitude, with the same
  argmax; that bound is 1.3x what JAX and the port differ by (measured);
- ``update_running_stats``: 1e-6 relative (the same momentum arithmetic);
- the one-cycle LR: 1e-6 relative to optax's schedule at every step, optax evaluated in
  f64 (its f32 arithmetic alone is up to 2e-6 off);
- ``train_classifier(augment=False)``, 3 epochs on JAX's permutations: per-epoch loss
  within rtol 1e-3, train and validation accuracies and the best epoch equal, the
  head's update within 1% of JAX's and the BN running statistics within 1e-3 of their
  magnitude. At lr 1e-5: the f32 gradients of this random net are accurate to a few
  percent in either package (the port's f32 against its f64: 5% median), and at 1e-3
  Adam's sign-like first steps turn that into diverging trajectories (4-9% apart by
  epoch 3, measured; JAX against itself would part the same way);
- the ``.pth`` and ``.npz`` exports: exact (the same f32 values).
"""

import contextlib
import functools
import json
import os
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from artist_style_transfer_tpu.models import resnet as jresnet
from artist_style_transfer_tpu.ops.norm import batch_norm_train as jbatch_norm_train
from artist_style_transfer_tpu.train import classifier as jclassifier
from artist_style_transfer_tpu.train.loop import epoch_permutation as jepoch_permutation
from artist_style_transfer_tpu_torch.models.resnet import (
    ResNet50Classifier,
    classifier_apply_train,
    init_classifier,
    load_classifier,
    update_running_stats,
)
from artist_style_transfer_tpu_torch.ops.norm import batch_norm_train
from artist_style_transfer_tpu_torch.train import classifier as tclassifier
from artist_style_transfer_tpu_torch.train.checkpoint import (
    export_classifier_pth,
    save_params_npz,
)
from artist_style_transfer_tpu_torch.utils.jax_params import (
    classifier_state_dict_from_jax,
    classifier_state_dict_to_jax,
)
from tests.test_torch_classifier import numpy_params
from tests.test_torch_data import one_torch_thread  # noqa: F401
from tests.test_torch_distributed import space_mesh, world_of_one


def port_name(jax_key: str) -> str:
    """A JAX BN path (``stages.1.0.down_bn``, ``head.bn1``) -> the port's module name."""
    parts = jax_key.split(".")
    if parts[0] == "stem":
        return "0.1"
    if parts[0] == "head":
        return {"bn1": "1.2", "bn2": "1.6"}[parts[1]]
    stage, block, layer = parts[1:]
    return f"0.{4 + int(stage)}.{block}.{ {'down_bn': 'downsample.1'}.get(layer, layer)}"


def port_param(path: tuple) -> str:
    """A JAX parameter path (keys and indices) -> the port's parameter name."""
    *mod, leaf = (str(getattr(p, "key", getattr(p, "idx", ""))) for p in path)
    if mod[0] == "stages":
        mod = ["stages", ".".join(mod[1:3])] + mod[3:]
    name = {"stem.conv": "0.0", "stem.bn": "0.1", "head.bn1": "1.2", "head.fc1": "1.4",
            "head.bn2": "1.6", "head.fc2": "1.8"}.get(".".join(mod))
    if name is None:
        stage, block = mod[1].split(".")
        layer = {"down_conv": "downsample.0", "down_bn": "downsample.1"}.get(mod[2], mod[2])
        name = f"0.{4 + int(stage)}.{block}.{layer}"
    return f"{name}.{ {'w': 'weight', 'b': 'bias', 'gamma': 'weight', 'beta': 'bias'}[leaf]}"


def port_classifier(params: dict, dtype=torch.float32) -> ResNet50Classifier:
    num_classes = np.asarray(params["head"]["fc2"]["b"]).shape[0]
    model = ResNet50Classifier(num_classes)
    model.load_state_dict(classifier_state_dict_from_jax(params))
    return model.to(dtype)


# --- batch norm in train mode ---------------------------------------------------------------


@pytest.mark.parametrize("shape", [(4, 6, 5, 3), (8, 5)], ids=["2d", "1d"])
def test_batch_norm_train_matches_jax(shape):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(shape) * 2 + 1).astype(np.float32)
    gamma, beta = (rng.standard_normal(shape[-1]).astype(np.float32) for _ in range(2))
    want = [np.asarray(a) for a in jbatch_norm_train(jnp.asarray(x), jnp.asarray(gamma),
                                                     jnp.asarray(beta))]
    xt = torch.from_numpy(x)
    if xt.dim() == 4:
        xt = xt.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    y, mean, var = batch_norm_train(xt, torch.from_numpy(gamma), torch.from_numpy(beta))
    if y.dim() == 4:
        assert y.is_contiguous(memory_format=torch.channels_last)
        y = y.permute(0, 2, 3, 1)
    for got, ref in zip((y, mean, var), want):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    # The statistics are those nn.BatchNorm's train mode folds into its buffers.
    bn = (torch.nn.BatchNorm2d if xt.dim() == 4 else torch.nn.BatchNorm1d)(shape[-1], momentum=1.0)
    bn.train()(xt)
    torch.testing.assert_close(mean, bn.running_mean, rtol=0, atol=0)
    torch.testing.assert_close(var, bn.running_var, rtol=0, atol=0)


# --- the train-mode ResNet-50 ---------------------------------------------------------------


@pytest.fixture(scope="module")
def train_forward():
    params = numpy_params(jresnet.init_classifier_params, 0)
    x = np.random.default_rng(1).standard_normal((4, 32, 32, 3)).astype(np.float32)
    logits, stats = jax.jit(jresnet.classifier_apply_train)(jax.tree.map(jnp.asarray, params),
                                                            jnp.asarray(x))
    out = {"params": params, "x": x, "jax": (np.asarray(logits),
                                              {port_name(k): tuple(np.asarray(a) for a in v)
                                               for k, v in stats.items()})}
    for dtype in (torch.float32, torch.float64):
        with torch.no_grad():
            logits, stats = classifier_apply_train(port_classifier(params, dtype),
                                                   torch.from_numpy(x).to(dtype))
        out[dtype] = (logits.double().numpy(),
                      {k: tuple(a.double().numpy() for a in v) for k, v in stats.items()})
    return out


def within_f32_error(jax_val, f32, f64) -> bool:
    scale = np.abs(f64).max()
    return np.abs(jax_val - f32).max() <= 3 * (np.abs(f32 - f64).max() + 1e-6 * scale)


def test_classifier_apply_train_matches_jax(train_forward):
    jl, js = train_forward["jax"]
    l32, s32 = train_forward[torch.float32]
    l64, s64 = train_forward[torch.float64]
    assert l32.shape == (4, 19) and np.isfinite(l32).all()
    assert within_f32_error(jl, l32, l64)
    assert (jl.argmax(-1) == l32.argmax(-1)).all()
    # One entry per BN: stem + 16 blocks x 3 + 4 downsample + 2 head = 55, keyed as JAX's.
    assert len(s32) == len(js) == 55 and s32.keys() == js.keys()
    for name in js:
        for i in (0, 1):
            assert within_f32_error(js[name][i], s32[name][i], s64[name][i]), (name, i)


def test_update_running_stats_matches_jax(train_forward):
    params = train_forward["params"]
    model = port_classifier(params)
    _, stats = classifier_apply_train(model, torch.from_numpy(train_forward["x"]))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    # Both packages fold the port's statistics, so the update alone is compared.
    jstats = {k: (jnp.asarray(stats[port_name(k)][0].detach().numpy()),
                  jnp.asarray(stats[port_name(k)][1].detach().numpy()))
              for k in ["stem.bn", "stages.1.0.down_bn", "stages.3.2.bn3", "head.bn1",
                        "head.bn2"]}
    new = jresnet.update_running_stats(jax.tree.map(jnp.asarray, params), jstats, momentum=0.1)
    update_running_stats(model, {port_name(k): stats[port_name(k)] for k in jstats}, 0.1)
    want = classifier_state_dict_from_jax(jax.tree.map(np.asarray, new))
    after = model.state_dict()
    for k in after:
        if k.endswith("num_batches_tracked"):
            moved = k[: -len("num_batches_tracked")] + "running_mean"
            assert int(after[k]) == (0 if torch.equal(after[moved], before[moved]) else 1), k
        else:
            torch.testing.assert_close(after[k], want[k], rtol=1e-6, atol=0)
    # Only the five named layers moved; every weight and other statistic is untouched.
    moved = {k for k in after if not torch.equal(after[k], before[k])}
    assert moved == {f"{port_name(j)}.{b}" for j in jstats
                     for b in ("running_mean", "running_var", "num_batches_tracked")}


# --- optimizer: the trained and decayed sets, the schedule ----------------------------------


@pytest.fixture(scope="module")
def small_model():
    return init_classifier(torch.Generator().manual_seed(0), "cpu", 3)


@pytest.mark.parametrize("freeze_body", [True, False])
def test_trained_and_decayed_sets_match_jax(small_model, freeze_body):
    shapes = jax.eval_shape(functools.partial(jresnet.init_classifier_params, num_classes=3),
                            jax.random.key(0))
    jlabels = jax.tree_util.tree_flatten_with_path(
        jclassifier.trainable_labels(shapes, freeze_body))[0]
    jmask = dict(jax.tree_util.tree_flatten_with_path(jclassifier.weight_decay_mask(shapes))[0])
    # JAX labels the BN running statistics 'freeze'; in the port they are buffers.
    want_train = {port_param(p) for p, label in jlabels if label == "train"}
    want_decay = {port_param(p) for p, keep in jmask.items() if keep}
    names = {n for n, _ in small_model.named_parameters()}
    assert {port_param(p) for p, _ in jlabels if str(p[-1].key) not in ("mean", "var")} == names
    labels = tclassifier.trainable_labels(small_model, freeze_body)
    assert {n for n, v in labels.items() if v == "train"} == want_train
    assert {n for n, v in tclassifier.weight_decay_mask(small_model).items() if v} == want_decay
    # What the optimizer holds: the trained set, the decay group its masked part.
    opt, _ = tclassifier.make_classifier_optimizer(small_model, 1e-3, 10, 1e-2, freeze_body)
    by_id = {id(p): n for n, p in small_model.named_parameters()}
    decayed, plain = ({by_id[id(p)] for p in g["params"]} for g in opt.param_groups)
    assert [g["weight_decay"] for g in opt.param_groups] == [1e-2, 0.0]
    assert decayed | plain == want_train and decayed == want_train & want_decay
    assert {n for n, p in small_model.named_parameters() if p.requires_grad} == want_train


def test_onecycle_lr_matches_optax(small_model):
    import optax

    lr = 1e-3
    for total in range(1, 51):
        ref = optax.cosine_onecycle_schedule(total, lr, pct_start=0.25)
        # optax's schedule in f64: in f32 its cancellation costs up to 2e-6 relative
        # (step 0: 1e-3 + (4e-5 - 1e-3)); the port computes in Python floats.
        with warnings.catch_warnings(), jax.enable_x64(True):
            warnings.simplefilter("ignore", RuntimeWarning)  # optax's 0/0 below 4 steps
            want = np.array([float(ref(t)) for t in range(total + 2)])
        if total < 4:  # the first interval is empty: optax gives NaN at every step
            assert np.isnan(want).all()
            with pytest.raises(ValueError, match="one-cycle"):
                tclassifier.make_classifier_optimizer(small_model, lr, total, 0.0, True)
            continue
        opt, sched = tclassifier.make_classifier_optimizer(small_model, lr, total, 0.0, True)
        got = []
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)  # the scheduler steps alone here
            for _ in range(total + 2):
                got.append(opt.param_groups[0]["lr"])
                sched.step()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    opt, sched = tclassifier.make_classifier_optimizer(small_model, lr, 3, 0.0, True, "constant")
    assert opt.param_groups[0]["lr"] == lr
    with pytest.raises(ValueError, match="schedule"):
        tclassifier.make_classifier_optimizer(small_model, lr, 10, 0.0, True, "cyclic")


# --- augmentation -----------------------------------------------------------------------


def test_augment_batch_is_flip_crop_of_padded_input():
    """Every augmented image is one (flip, crop offset) candidate of the reflect-padded
    input; the same generator seed gives the same batch, another seed another."""
    x = np.random.default_rng(0).standard_normal((4, 6, 5, 3)).astype(np.float32)
    pad = 2

    def run(seed):
        gen = torch.Generator().manual_seed(seed)
        return tclassifier.augment_batch(gen, torch.from_numpy(x), pad=pad).numpy()

    out = run(1)
    assert out.shape == x.shape
    np.testing.assert_array_equal(out, run(1))
    assert not np.array_equal(out, run(2))
    h, w = x.shape[1:3]
    for i in range(x.shape[0]):
        candidates = []
        for img in (x[i], x[i, :, ::-1]):
            padded = np.pad(img, ((pad, pad), (pad, pad), (0, 0)), mode="reflect")
            candidates += [padded[oy: oy + h, ox: ox + w]
                           for oy in range(2 * pad + 1) for ox in range(2 * pad + 1)]
        assert any(np.array_equal(out[i], c) for c in candidates), i


# --- train_classifier -------------------------------------------------------------------


def separable_data(n_per_class: int = 8, size: int = 32, num_classes: int = 3, seed: int = 0):
    """Classes = distinct mean colours + noise (``tests/test_classifier_train.py``)."""
    rng = np.random.default_rng(seed)
    means = np.asarray([[3.0, -2.0, 0.0], [-3.0, 2.0, 1.0], [0.0, 3.0, -3.0]])
    xs = [rng.normal(size=(n_per_class, size, size, 3)) * 0.2 + means[c]
          for c in range(num_classes)]
    return (np.concatenate(xs).astype(np.float32),
            np.repeat(np.arange(num_classes), n_per_class).astype(np.int32))


def test_train_classifier_matches_jax_trajectory(monkeypatch):
    images, labels = separable_data()
    params = numpy_params(functools.partial(jresnet.init_classifier_params, num_classes=3), 0)
    kw = dict(num_classes=3, num_epochs=3, batch_size=8, lr=1e-5, freeze_body=True,
              val_fraction=0.25, seed=2, wordy=False)
    jbest, jhist = jclassifier.train_classifier(images, labels,
                                                params=jax.tree.map(jnp.asarray, params), **kw)
    # The JAX shuffle (jax.random) in place of the port's seeded torch one.
    monkeypatch.setattr(tclassifier, "epoch_permutation", lambda seed, epoch, n: torch.from_numpy(
        np.array(jepoch_permutation(seed, epoch, n))))
    model = port_classifier(params)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    best, hist = tclassifier.train_classifier(images, labels, model=model, device="cpu", **kw)
    np.testing.assert_allclose(hist["train_loss"], jhist["train_loss"], rtol=1e-3)
    assert hist["train_acc"] == jhist["train_acc"] and hist["val_acc"] == jhist["val_acc"]
    assert int(np.argmax(hist["val_acc"])) == int(np.argmax(jhist["val_acc"]))
    # The caller's module is untouched; the best one comes back frozen.
    assert all(torch.equal(v, start[k]) for k, v in model.state_dict().items())
    assert not any(p.requires_grad for p in best.parameters())
    ours = classifier_state_dict_to_jax(best.state_dict())
    ref = jax.tree.map(np.asarray, jbest)
    step, step_ref = (t["head"]["fc2"]["w"] - params["head"]["fc2"]["w"] for t in (ours, ref))
    assert np.abs(step - step_ref).max() <= 1e-2 * np.abs(step_ref).max()
    for got, want in ((ours["stem"]["bn"], ref["stem"]["bn"]),
                      (ours["head"]["bn1"], ref["head"]["bn1"]),
                      (ours["head"]["bn2"], ref["head"]["bn2"])):
        for stat in ("mean", "var"):
            assert np.abs(got[stat] - want[stat]).max() <= 1e-3 * np.abs(want[stat]).max()
    # freeze_body: the body's convs bit-unchanged, their BN affines trained.
    for k in ("0.0.weight", "0.5.0.conv2.weight", "0.7.0.downsample.0.weight"):
        assert torch.equal(best.state_dict()[k], start[k]), k
    assert not torch.equal(best.state_dict()["0.1.weight"], start["0.1.weight"])


def test_train_classifier_defaults_and_refusals(tmp_path):
    images, labels = separable_data(n_per_class=4)
    metrics = str(tmp_path / "m.jsonl")
    kw = dict(num_classes=3, num_epochs=1, batch_size=4, schedule="constant", augment=True,
              val_fraction=0.0, device="cpu", wordy=False)
    best, hist = tclassifier.train_classifier(images, labels, metrics_path=metrics, **kw)
    # No validation split: the final model, NaN validation accuracy, one metrics record.
    assert np.isnan(hist["val_acc"][0]) and np.isfinite(hist["train_loss"][0])
    with open(metrics) as f:
        assert [line.count('"classifier_epoch"') for line in f] == [1]
    acc = tclassifier.evaluate_classifier(best, images[:5], labels[:5], batch_size=4)
    assert 0.0 <= acc <= 1.0
    # A world of one over gloo: one step over the whole split, its loss within 1e-3 of
    # the single process's. The BN statistics come from another function (sums
    # all-reduced over one rank) than F.batch_norm's, and this net's train-mode BNs
    # amplify their f32 rounding to 1.1e-4 of the loss (measured); later steps part
    # further, by Adam's sign-like updates.
    from artist_style_transfer_tpu_torch.parallel import make_mesh

    one = dict(kw, batch_size=len(images), augment=False)
    _, hist = tclassifier.train_classifier(images, labels, **one)
    with world_of_one():
        _, hist_dp = tclassifier.train_classifier(images, labels, mesh=make_mesh(device="cpu"),
                                                  **one)
    np.testing.assert_allclose(hist_dp["train_loss"], hist["train_loss"], rtol=1e-3)
    assert hist_dp["train_acc"] == hist["train_acc"]
    with pytest.raises(NotImplementedError, match="item 12b"):
        tclassifier.train_classifier(images, labels, mesh=space_mesh(), device="cpu")
    with pytest.raises(ValueError, match="smaller than batch_size"):
        tclassifier.train_classifier(images, labels, batch_size=64, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tclassifier.train_classifier(images, labels)


# --- exports and the CLI -------------------------------------------------------------------


def test_classifier_exports_read_by_both_packages(tmp_path):
    from artist_style_transfer_tpu.train.checkpoint import (
        export_classifier_pth as jexport_classifier_pth,
        load_params_npz as jload_params_npz,
    )
    from artist_style_transfer_tpu.utils.torch_import import (
        classifier_params_from_torch,
        load_torch_state_dict,
    )

    model = port_classifier(numpy_params(jresnet.init_classifier_params, 1))
    with torch.no_grad():  # a running count, which JAX's pytree does not carry
        model.get_submodule("0.1").num_batches_tracked.fill_(3)
    pth = str(tmp_path / "best-2.pth")
    export_classifier_pth(pth, model)
    raw = torch.load(pth, map_location="cpu", weights_only=True)
    assert set(raw) == {"model"} and raw["model"].keys() == model.state_dict().keys()
    assert raw["model"]["0.1.num_batches_tracked"].dtype == torch.int64
    assert "0.4.0.downsample.0.weight" in raw["model"] and "1.8.bias" in raw["model"]
    ours = classifier_state_dict_to_jax(model.state_dict())
    theirs = classifier_params_from_torch(load_torch_state_dict(pth))
    jax.tree.map(np.testing.assert_array_equal, ours, jax.tree.map(np.asarray, theirs))
    loaded = load_classifier(pth, "cpu").state_dict()
    assert all(torch.equal(v, loaded[k]) for k, v in model.state_dict().items())

    # The classifier .npz in JAX's key layout, read by JAX's loader; JAX's .pth read here.
    npz = str(tmp_path / "classifier.npz")
    save_params_npz(npz, model)
    back = jload_params_npz(npz, theirs)
    jax.tree.map(np.testing.assert_array_equal, jax.tree.map(np.asarray, back), ours)
    jpth = str(tmp_path / "jax.pth")
    jexport_classifier_pth(jpth, theirs)
    from_jax = load_classifier(jpth, "cpu").state_dict()
    assert all(torch.equal(from_jax[k], v) for k, v in model.state_dict().items()
               if not k.endswith("num_batches_tracked"))


def test_classifier_cli_on_a_tiny_corpus(tmp_path, monkeypatch, capsys):
    from tests.test_torch_data import write_workspace

    write_workspace(tmp_path)  # 5 paintings of two artists under images/archive/
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "models"
    argv = ["--device", "cpu", "--num_epochs", "1", "--batch_size", "2", "--schedule",
            "constant", "--rescale_height", "32", "--rescale_width", "32",
            "--out_dir", str(out), "--metrics", str(tmp_path / "m.jsonl")]
    tclassifier.main(argv)
    assert "exported" in capsys.readouterr().out
    first = (out / "best-2.pth").read_bytes()
    model = load_classifier(str(out / "best-2.pth"), "cpu")
    assert model.get_submodule("1.8").weight.shape == (19, 512)
    with np.load(out / "classifier.npz") as z:
        assert "stages/3/2/bn3/var" in z.files and z["head/fc2/w"].shape == (512, 19)
    # An existing best-2.pth is never overwritten without --overwrite.
    tclassifier.main(argv)
    assert "use --overwrite" in capsys.readouterr().out
    assert (out / "best-2.pth").read_bytes() == first
    assert os.path.exists(out / "best-2-retrained.pth")
    tclassifier.main(argv + ["--overwrite", "--seed", "3"])
    assert (out / "best-2.pth").read_bytes() != first
    # --data_parallel in a world of one over gloo: one step over the 4 training images,
    # its loss within 1e-3 of the run without it (the bar and why: the test above)
    runs = {}
    for name, extra in (("one", []), ("dp", ["--data_parallel"])):
        d = tmp_path / name
        args = argv[:-4] + ["--batch_size", "4", "--out_dir", str(d), "--metrics",
                            str(d / "m.jsonl")] + extra
        with world_of_one() if extra else contextlib.nullcontext():
            tclassifier.main(args)
        with open(d / "m.jsonl") as f:
            runs[name] = json.loads(f.readline())["train_loss"]
        assert load_classifier(str(d / "best-2.pth"), "cpu").get_submodule("1.8").weight.shape == (19, 512)
    np.testing.assert_allclose(runs["dp"], runs["one"], rtol=1e-3)
