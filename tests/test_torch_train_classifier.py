"""The 'classifier' training mode of the PyTorch port, held against the JAX package's
``train/loop.py`` on the CPU at 32x32, B=2, N=5 content images (two full steps
and a ragged step of one image an epoch), with the same parameters (JAX
layouts drawn with numpy, moved across by ``utils/jax_params.py``) and the
JAX permutations fed in.

Tolerances, those of ``tests/test_torch_train_loop.py``:

- first step: losses within 1e-5 relative; gradients of the content term and
  of the classifier term, each on its own, within 1e-4 of each leaf's largest
  entry (of the net's largest for leaves whose exact gradient is 0). As in
  that file, a ReLU or max-pool decision within f32 rounding of its boundary
  moves a whole gradient entry in either framework (measured: 2 of 6 seeds
  of data and TransformerNet weights, 1.8e-1 and 8.8e-3; the other 4 at
  6e-6 to 1e-5); the seeds here have none, so the bound measures the
  arithmetic;
- trajectories: per-step losses at rtol 1e-3 in the first epoch and 3e-2
  after, parameters' RMS drift under 1.5 lr;
- bf16: first-step losses within 5e-3 relative.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from artist_style_transfer_tpu_torch.models.resnet import ARTISTS_19, ResNet50Classifier
from artist_style_transfer_tpu_torch.models.transformer import TransformerNet
from artist_style_transfer_tpu_torch.models.vgg import VGG16Features
from artist_style_transfer_tpu_torch.train import loop as tloop
from artist_style_transfer_tpu_torch.train import styles as tstyles
from artist_style_transfer_tpu_torch.train import train, train_from_config
from artist_style_transfer_tpu_torch.utils.config import TrainConfig
from artist_style_transfer_tpu_torch.utils.jax_params import (
    classifier_state_dict_from_jax,
    transformer_state_dict_from_jax,
    vgg16_state_dict_from_jax,
)
from tests.test_torch_classifier import numpy_params
from tests.test_torch_train_loop import zero_grad_leaf
from tests.test_torch_data import one_torch_thread  # noqa: F401
from tests.test_torch_distributed import space_mesh

SIZE, B, N = 32, 2, 5
LR, WD, CW, SW = 0.01, 1e-4, 17.0, 25.0
EPOCHS = 2
ARTIST = "Pablo_Picasso"


def corpus(n: int = N, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).uniform(0, 255, (n, SIZE, SIZE, 3)).astype(np.float32)


class JaxRun:
    """The JAX package's 'classifier' run: make_step_fns with use_pallas=False."""

    def __init__(self, epochs: int, compute_dtype: str = "float32",
                 reference_typo_stats: bool = False):
        from artist_style_transfer_tpu.models.resnet import init_classifier_params
        from artist_style_transfer_tpu.models.transformer import init_transformer_params
        from artist_style_transfer_tpu.models.vgg import init_vgg16_params
        from artist_style_transfer_tpu.train.loop import (
            epoch_permutation,
            make_optimizer,
            make_step_fns,
            precompute_content_relu2_2,
        )
        from artist_style_transfer_tpu.train.styles import build_style_targets

        self.content = corpus()
        self.params0 = numpy_params(init_transformer_params, 0)
        self.vgg0 = numpy_params(init_vgg16_params, 1)
        self.clf0 = numpy_params(init_classifier_params, 2)
        vgg = jax.tree.map(jnp.asarray, self.vgg0)
        self.targets = build_style_targets("classifier", vgg, ARTIST, batch_size=B,
                                           artist_index=ARTISTS_19.index(ARTIST))
        self.steps_per_epoch = -(-N // B)
        self.tx = make_optimizer(LR, WD, epochs, 2, self.steps_per_epoch)
        self.fns = make_step_fns("classifier", vgg, jax.tree.map(jnp.asarray, self.clf0),
                                 self.targets, content_weight=CW, style_weight=SW, batch_size=B,
                                 num_content=N, tx=self.tx, use_pallas=False,
                                 compute_dtype=compute_dtype,
                                 reference_typo_stats=reference_typo_stats)
        self.data = jnp.asarray(self.content)
        self.r22 = precompute_content_relu2_2(
            vgg, self.data, dtype=jnp.bfloat16 if compute_dtype == "bfloat16" else None)
        self.perms = [np.asarray(epoch_permutation(0, e, N)) for e in range(epochs)]
        self.epochs = epochs

    def _args(self):
        idx = self.perms[0][:B]
        return (self.data[idx], self.r22[idx], None, self.targets.labels, jnp.int32(0))

    def first_step_losses(self) -> np.ndarray:
        total, (c, s) = jax.jit(self.fns.loss_fn)(jax.tree.map(jnp.asarray, self.params0),
                                                  *self._args())
        return np.array([c, s, total], np.float64)

    def first_step_grads(self):
        """[content, style, total] and the gradients of the content and classifier terms."""

        def terms_and_jacobian(params, *args):
            terms, vjp = jax.vjp(lambda p: jnp.stack(self.fns.loss_fn(p, *args)[1]), params)
            return terms, jax.vmap(vjp)(jnp.eye(2, dtype=terms.dtype))[0]

        terms, jac = jax.jit(terms_and_jacobian)(jax.tree.map(jnp.asarray, self.params0),
                                                 *self._args())
        c, s = (float(v) for v in terms)
        grads = [transformer_state_dict_from_jax(jax.tree.map(lambda a, i=i: np.asarray(a)[i], jac))
                 for i in (0, 1)]
        return np.array([c, s, c + s]), grads

    def trajectory(self):
        params = jax.tree.map(jnp.asarray, self.params0)
        state = self.tx.init(params)
        losses = []
        for e in range(self.epochs):
            params, state, el = self.fns.epoch_fn(
                params, state, self.data, self.r22, None, self.targets.labels,
                jnp.asarray(self.perms[e]), jnp.int32(e * self.steps_per_epoch))
            losses.append(np.asarray(el, np.float64))
        return np.concatenate(losses), jax.tree.map(np.asarray, params)


class PortRun:
    """The port's counterpart of :class:`JaxRun` on the same parameters and data."""

    def __init__(self, ref: JaxRun, compute_dtype: str = "float32",
                 reference_typo_stats: bool = False):
        self.model = TransformerNet()
        self.model.load_state_dict(transformer_state_dict_from_jax(ref.params0))
        self.vgg = VGG16Features()
        self.vgg.load_state_dict(vgg16_state_dict_from_jax(ref.vgg0))
        self.classifier = ResNet50Classifier()
        self.classifier.load_state_dict(classifier_state_dict_from_jax(ref.clf0))
        self.targets = tstyles.build_style_targets("classifier", self.vgg, ARTIST, batch_size=B)
        self.opt, self.sched = tloop.make_optimizer(self.model.parameters(), LR, WD, ref.epochs, 2,
                                                    ref.steps_per_epoch)
        self.fns = tloop.make_step_fns(
            "classifier", self.model, self.vgg, self.targets, self.opt, self.sched,
            content_weight=CW, style_weight=SW, batch_size=B, num_content=N,
            compute_dtype=compute_dtype, classifier=self.classifier,
            reference_typo_stats=reference_typo_stats)
        self.data = torch.from_numpy(ref.content)
        self.r22 = tloop.precompute_content_relu2_2(
            self.vgg, self.data, dtype=torch.bfloat16 if compute_dtype == "bfloat16" else None)
        self.ref = ref

    def first_step(self):
        idx = torch.from_numpy(self.ref.perms[0][:B].copy())
        params = {k: v.detach().clone().requires_grad_(True)
                  for k, v in self.model.named_parameters()}
        total, (c, s) = self.fns.loss_fn(params, self.data[idx], self.r22[idx], None, 0)
        grads = [dict(zip(params, (g.numpy() for g in torch.autograd.grad(
                 term, list(params.values()), retain_graph=True)))) for term in (c, s)]
        return np.array([c.item(), s.item(), total.item()], np.float64), grads

    def trajectory(self):
        losses = [self.fns.epoch_fn(self.data, self.r22, self.ref.perms[e],
                                    e * self.ref.steps_per_epoch)
                  for e in range(self.ref.epochs)]
        return torch.cat(losses).numpy().astype(np.float64)


@pytest.fixture(scope="module")
def f32_runs():
    """JAX first step and 2-epoch trajectory (each jit compiles once), and the port's."""
    ref = JaxRun(EPOCHS)
    first, grads = ref.first_step_grads()
    traj, params = ref.trajectory()
    port = PortRun(ref)
    port_first, port_grads = port.first_step()
    port_traj = port.trajectory()
    return {"first": (first, port_first), "grads": (grads, port_grads),
            "traj": (traj, port_traj), "params": (params, port.model), "port": port}


def test_first_step_losses_and_gradients_match_jax(f32_runs):
    ref, got = f32_runs["first"]
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    for term, ref_g, got_g in zip(("content", "classifier"), *f32_runs["grads"]):
        assert sorted(got_g) == sorted(ref_g)
        top = max(np.abs(v.numpy()).max() for v in ref_g.values())
        assert top > 0, term
        for k, g in got_g.items():
            r = ref_g[k].numpy()
            scale = top if zero_grad_leaf(k) else np.abs(r).max()
            assert np.abs(g - r).max() <= 1e-4 * scale, (term, k)


def test_two_epoch_classifier_trajectory_matches_jax(f32_runs):
    ref, got = f32_runs["traj"]
    assert got.shape == ref.shape == (EPOCHS * 3, 3)
    np.testing.assert_allclose(got[:3], ref[:3], rtol=1e-3)
    np.testing.assert_allclose(got, ref, rtol=3e-2)
    ref_params, model = f32_runs["params"]
    ours = transformer_state_dict_from_jax(ref_params)
    for k, v in model.state_dict().items():
        d = v.numpy().astype(np.float64) - ours[k].numpy().astype(np.float64)
        assert np.sqrt((d * d).mean()) < 1.5 * LR, k


def test_ragged_final_batch_slices_the_labels(f32_runs):
    """N=5, B=2: the third step of an epoch runs one image against labels[:1]; its
    classifier term is the cross-entropy of one row, as in JAX."""
    port = f32_runs["port"]
    assert port.fns.steps_per_epoch == 3
    assert port.targets.labels.tolist() == [ARTISTS_19.index(ARTIST)] * B
    ref, got = f32_runs["traj"]
    np.testing.assert_allclose(got[2::3], ref[2::3], rtol=3e-2)
    idx = torch.from_numpy(port.ref.perms[0][-1:].copy())
    params = dict(port.model.named_parameters())
    with torch.no_grad():
        _, (c, s) = port.fns.loss_fn(params, port.data[idx], port.r22[idx], None, 0)
    assert np.isfinite(s.item()) and s.item() > 0


def test_frozen_nets_get_no_gradient(f32_runs):
    """Only the data gradient runs through the VGG and the classifier: after the port's
    2-epoch run neither holds a .grad, and every TransformerNet parameter does."""
    port = f32_runs["port"]
    for net in (port.vgg, port.classifier):
        assert all(not p.requires_grad and p.grad is None for p in net.parameters())
    assert all(p.grad is not None for p in port.model.parameters())


def test_reference_typo_stats_first_step_matches_jax(f32_runs):
    ref = JaxRun(1, reference_typo_stats=True)
    ref_losses = ref.first_step_losses()
    got, _ = PortRun(ref, reference_typo_stats=True).first_step()
    np.testing.assert_allclose(got, ref_losses, rtol=1e-5)
    # The 0.546 G mean moves the classifier term and nothing else.
    plain = f32_runs["first"][1]
    assert got[0] == pytest.approx(plain[0], rel=1e-6) and got[1] != pytest.approx(plain[1])


def test_bf16_first_step_losses_match_jax():
    ref = JaxRun(1, compute_dtype="bfloat16")
    ref_losses = ref.first_step_losses()
    port = PortRun(ref, compute_dtype="bfloat16")
    got, grads = port.first_step()
    np.testing.assert_allclose(got, ref_losses, rtol=5e-3)
    # The caller's classifier stays f32: the step runs on a bf16 copy.
    assert all(p.dtype == torch.float32 for p in port.classifier.parameters())
    assert all(np.isfinite(g).all() for term in grads for g in term.values())


# --- train() ----------------------------------------------------------------------------


@pytest.fixture(scope="module")
def hooks():
    from artist_style_transfer_tpu_torch.models.resnet import init_classifier
    from artist_style_transfer_tpu_torch.models.vgg import init_vgg16

    return dict(content_images=corpus(4), vgg=init_vgg16(torch.Generator().manual_seed(0)),
                classifier=init_classifier(torch.Generator().manual_seed(1)), device="cpu",
                wordy=False)


def test_train_classifier_mode_writes_the_artifacts(hooks, tmp_path):
    model, losses = train("classifier", ARTIST, num_epochs=2, batch_size=2, lr=0.01, seed=3,
                          model_dir=str(tmp_path), **hooks)
    assert isinstance(model, TransformerNet) and losses.shape == (2, 3)
    assert np.isfinite(losses).all() and (losses[:, 1] > 0).all()
    np.testing.assert_allclose(losses[:, 2], losses[:, 0] + losses[:, 1], rtol=1e-6)
    names = set(os.listdir(tmp_path / ARTIST / "classifier"))
    assert {"transfer_17-25_2.npz", "transfer_17-25_2.pth", "metrics.jsonl"} <= names
    assert "style.jpg" not in names  # no painting to preview
    assert all(p.grad is None for p in hooks["classifier"].parameters())


def test_train_classifier_hook_forms_agree(hooks, tmp_path):
    """The module, its state dict, and the ``{'model': sd}`` file at ``classifier_path``
    train the same model."""
    sd = hooks["classifier"].state_dict()
    path = str(tmp_path / "best-2.pth")
    torch.save({"model": sd}, path)
    kw = dict(hooks, num_epochs=1, batch_size=2, model_dir=None)
    runs = [train("classifier", ARTIST, **kw)[1],
            train("classifier", ARTIST, **dict(kw, classifier=sd))[1],
            train("classifier", ARTIST, **dict(kw, classifier=None), classifier_path=path)[1]]
    for losses in runs[1:]:
        np.testing.assert_array_equal(losses, runs[0])
    cfg = TrainConfig(style_method="classifier", artist=ARTIST, num_epochs=1, batch_size=2,
                      model_dir=None, device="cpu", classifier_path=path,
                      reference_typo_stats=True)
    _, typo = train_from_config(cfg, content_images=hooks["content_images"], vgg=hooks["vgg"],
                                wordy=False)
    np.testing.assert_array_equal(
        typo, train("classifier", ARTIST, **kw, reference_typo_stats=True)[1])
    assert typo[0, 1] != runs[0][0, 1]


REFUSED = [
    (dict(qat=True, fold_batch=True), NotImplementedError, "batch->H folded"),
    (dict(quantize_loss="all", fold_batch=True), NotImplementedError, "quantize_loss='deep'"),
    (dict(mesh=space_mesh()), NotImplementedError, "item 12b"),
    (dict(artist="Albrecht_Dürer"), ValueError, "not in tuple"),
]


@pytest.mark.parametrize("kw,exc,match", REFUSED, ids=[next(iter(kw)) for kw, _, _ in REFUSED])
def test_train_classifier_mode_refusals(hooks, tmp_path, kw, exc, match):
    args = dict(hooks, artist=ARTIST, num_epochs=1, batch_size=2, model_dir=str(tmp_path))
    args.update(kw)
    with pytest.raises(exc, match=match):
        train("classifier", **args)
    assert not os.listdir(tmp_path)  # refused before anything was written


def test_train_classifier_mode_loads_the_content_dir(hooks, tmp_path):
    """Without ``content_images`` the corpus comes from ``content_dir``; 'classifier' mode
    reads no painting."""
    pytest.importorskip("cv2")
    from tests.test_torch_data import write_workspace

    ws = write_workspace(tmp_path / "ws")
    args = dict(hooks, artist=ARTIST, num_epochs=1, batch_size=2, model_dir=str(tmp_path / "m"),
                content_images=None, content_dir=ws["content"], archive_dir="nowhere/",
                train_size=SIZE)
    _, losses = train("classifier", **args)
    assert np.isfinite(losses).all()
    events = [json.loads(line)
              for line in open(tmp_path / "m" / ARTIST / "classifier" / "metrics.jsonl")]
    data = next(e for e in events if e["event"] == "data")
    assert data["content"]["source"] == "files" and data["content"]["images"] == 6
    assert "paintings" not in data


def test_classifier_targets_and_step_fns_refusals(hooks):
    vgg = hooks["vgg"]
    t = tstyles.build_style_targets("classifier", vgg, "Vincent_van_Gogh", batch_size=3)
    assert t.grams is None and t.labels.dtype == torch.int64 and t.labels.tolist() == [18] * 3
    assert tstyles.build_style_targets("classifier", vgg, "Nobody", artist_index=4).labels[0] == 4
    with pytest.raises(ValueError):
        tstyles.build_style_targets("classifier", vgg, "Nobody")
    model = TransformerNet()
    opt, sched = tloop.make_optimizer(model.parameters(), LR, WD, 1, 2, 2)
    with pytest.raises(ValueError, match="needs a classifier"):
        tloop.make_step_fns("classifier", model, vgg, t, opt, sched, content_weight=CW,
                            style_weight=SW, batch_size=2, num_content=4)
