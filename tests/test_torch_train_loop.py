"""The 'cycle' training loop of the PyTorch port, held against the JAX package's
``train/loop.py`` on the CPU at 32x32, B=2, N=4 content images (N=5 for the
ragged tail), P=3 paintings, with the same parameters (moved across by
``utils/jax_params.py``) and the JAX permutations fed in.

Tolerances:

- first step: losses within 1e-5 relative; parameter gradients within 1e-4 of
  each leaf's largest entry (leaves whose exact gradient is 0 on the scale of
  the net's largest gradient). On white-noise 32x32 content some seeds put a
  ReLU or max-pool decision within f32 rounding of its boundary, in either
  framework, and one flipped decision moves a whole gradient entry (measured:
  the port against a float64 torch oracle, 3 clean seeds of 8); the data seed
  here has none, so the bound measures the arithmetic;
- trajectories: per-step losses at rtol 1e-3 in the first epoch and 3e-2
  after, parameters' RMS drift under 1.5 lr, the bounds of
  ``tests/test_train_trajectory_parity.py``;
- bf16: first-step losses within 5e-3 relative: the two frameworks round
  bf16 activations at other places (measured 2.1e-3), a smaller gap than the
  one between bf16 and f32 (6.5e-3 on the same step).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from artist_style_transfer_tpu_torch.models.transformer import TransformerNet
from artist_style_transfer_tpu_torch.models.vgg import VGG16Features
from artist_style_transfer_tpu_torch.train import loop as tloop
from artist_style_transfer_tpu_torch.train import styles as tstyles
from artist_style_transfer_tpu_torch.utils.jax_params import (
    transformer_state_dict_from_jax,
    vgg16_state_dict_from_jax,
)
from tests.test_torch_data import one_torch_thread  # noqa: F401

SIZE, B, P = 32, 2, 3
LR, WD, CW, SW = 0.01, 1e-4, 17.0, 25.0
EPOCHS = 2


def corpus(n: int, seed: int = 2) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    content = rng.uniform(0, 255, (n, SIZE, SIZE, 3)).astype(np.float32)
    paintings = rng.uniform(0, 255, (P, SIZE, SIZE, 3)).astype(np.float32)
    return content, paintings


def numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def zero_grad_leaf(name: str) -> bool:
    """Leaves whose exact gradient is 0: a conv bias feeding an instance norm, and a
    residual block's last norm bias, a per-channel constant the next norm removes."""
    return (name.endswith(("conv_transpose.bias", "conv_layer.bias"))
            and not name.startswith("DeconvBlock.6")) or name.endswith("conv2.norm_layer.bias")


class JaxRun:
    """The JAX package's 'cycle' run: make_step_fns with use_pallas=False, as its tests run."""

    def __init__(self, n: int, epochs: int, compute_dtype: str = "float32"):
        from artist_style_transfer_tpu.models.transformer import init_transformer_params
        from artist_style_transfer_tpu.models.vgg import init_vgg16_params
        from artist_style_transfer_tpu.train.loop import (
            epoch_permutation,
            make_optimizer,
            make_step_fns,
            precompute_content_relu2_2,
        )
        from artist_style_transfer_tpu.train.styles import build_style_targets

        self.n = n
        self.content, self.paintings = corpus(n)
        params = init_transformer_params(jax.random.key(0))
        self.vgg = init_vgg16_params(jax.random.key(1))
        self.params0 = numpy_tree(params)
        self.targets = build_style_targets("cycle", self.vgg, "X", paintings=self.paintings)
        self.steps_per_epoch = -(-n // B)
        self.tx = make_optimizer(LR, WD, epochs, 2, self.steps_per_epoch)
        self.fns = make_step_fns("cycle", self.vgg, None, self.targets, content_weight=CW,
                                 style_weight=SW, batch_size=B, num_content=n, tx=self.tx,
                                 use_pallas=False, compute_dtype=compute_dtype)
        self.data = jnp.asarray(self.content)
        self.r22 = precompute_content_relu2_2(
            self.vgg, self.data, dtype=jnp.bfloat16 if compute_dtype == "bfloat16" else None)
        self.perms = [np.asarray(epoch_permutation(0, e, n)) for e in range(epochs)]
        self.epochs = epochs
        self.params = params

    def first_step(self, with_grads: bool):
        idx = self.perms[0][:B]
        args = (self.data[idx], self.r22[idx], self.targets.grams, None, jnp.int32(0))
        if not with_grads:
            total, (c, s) = jax.jit(self.fns.loss_fn)(self.params, *args)
            return np.array([c, s, total], np.float64), None
        (total, (c, s)), g = jax.jit(jax.value_and_grad(self.fns.loss_fn, has_aux=True))(
            self.params, *args)
        return np.array([c, s, total], np.float64), numpy_tree(g)

    def trajectory(self):
        """Per-step [content, style, total] losses over the epochs, and the final params."""
        params, state = self.params, self.tx.init(self.params)
        losses = []
        for e in range(self.epochs):
            params, state, el = self.fns.epoch_fn(
                params, state, self.data, self.r22, self.targets.grams, None,
                jnp.asarray(self.perms[e]), jnp.int32(e * self.steps_per_epoch))
            losses.append(np.asarray(el, np.float64))
        return np.concatenate(losses), numpy_tree(params)


class PortRun:
    """The port's counterpart of :class:`JaxRun` on the same parameters and data."""

    def __init__(self, ref: JaxRun, compute_dtype: str = "float32"):
        self.model = TransformerNet()
        self.model.load_state_dict(transformer_state_dict_from_jax(ref.params0))
        self.vgg = VGG16Features()
        self.vgg.load_state_dict(vgg16_state_dict_from_jax(numpy_tree(ref.vgg)))
        self.targets = tstyles.build_style_targets("cycle", self.vgg, "X", paintings=ref.paintings)
        self.opt, self.sched = tloop.make_optimizer(self.model.parameters(), LR, WD, ref.epochs, 2,
                                                    ref.steps_per_epoch)
        self.fns = tloop.make_step_fns("cycle", self.model, self.vgg, self.targets, self.opt,
                                       self.sched, content_weight=CW, style_weight=SW,
                                       batch_size=B, num_content=ref.n,
                                       compute_dtype=compute_dtype)
        self.data = torch.from_numpy(ref.content)
        self.r22 = tloop.precompute_content_relu2_2(
            self.vgg, self.data, dtype=torch.bfloat16 if compute_dtype == "bfloat16" else None)
        self.ref = ref

    def first_step(self):
        idx = torch.from_numpy(self.ref.perms[0][:B].copy())
        params = {k: v.detach().clone().requires_grad_(True)
                  for k, v in self.model.named_parameters()}
        total, (c, s) = self.fns.loss_fn(params, self.data[idx], self.r22[idx],
                                         self.targets.grams, 0)
        grads = torch.autograd.grad(total, list(params.values()))
        losses = np.array([c.item(), s.item(), total.item()], np.float64)
        return losses, {k: g.numpy() for k, g in zip(params, grads)}

    def trajectory(self):
        losses = [self.fns.epoch_fn(self.data, self.r22, self.ref.perms[e],
                                    e * self.ref.steps_per_epoch)
                  for e in range(self.ref.epochs)]
        return torch.cat(losses).numpy().astype(np.float64)


@pytest.fixture(scope="module")
def f32_runs():
    """JAX first step and 2-epoch trajectory (each jit compiles once), and the port's."""
    ref = JaxRun(4, EPOCHS)
    first, grads = ref.first_step(with_grads=True)
    traj, params = ref.trajectory()
    port = PortRun(ref)
    port_first, port_grads = port.first_step()
    port_traj = port.trajectory()
    return {"first": (first, port_first), "grads": (grads, port_grads), "traj": (traj, port_traj),
            "params": (params, port.model)}


def test_first_step_losses_and_gradients_match_jax(f32_runs):
    ref, got = f32_runs["first"]
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    ref_g = {k: v.numpy() for k, v in transformer_state_dict_from_jax(f32_runs["grads"][0]).items()}
    got_g = f32_runs["grads"][1]
    assert sorted(got_g) == sorted(ref_g)
    top = max(np.abs(v).max() for v in ref_g.values())
    for k, g in got_g.items():
        scale = top if zero_grad_leaf(k) else np.abs(ref_g[k]).max()
        assert np.abs(g - ref_g[k]).max() <= 1e-4 * scale, k


def test_two_epoch_cycle_trajectory_matches_jax(f32_runs):
    """4 steps over 2 epochs: the 'cycle' index runs on the global step (0,1 | 2,0)."""
    ref, got = f32_runs["traj"]
    assert got.shape == ref.shape == (4, 3)
    np.testing.assert_allclose(got[:2], ref[:2], rtol=1e-3)
    np.testing.assert_allclose(got, ref, rtol=3e-2)
    ref_params, model = f32_runs["params"]
    ours = transformer_state_dict_from_jax(ref_params)
    for k, v in model.state_dict().items():
        d = v.numpy().astype(np.float64) - ours[k].numpy().astype(np.float64)
        assert np.sqrt((d * d).mean()) < 1.5 * LR, k


def test_ragged_epoch_matches_jax():
    """N=5, B=2: two full steps and a ragged step of one image, at its own size."""
    ref = JaxRun(5, 1)
    ref_losses, _ = ref.trajectory()
    port = PortRun(ref)
    got = port.trajectory()
    assert port.fns.steps_per_epoch == 3 and got.shape == ref_losses.shape == (3, 3)
    np.testing.assert_allclose(got, ref_losses, rtol=1e-3)


def test_bf16_first_step_losses_match_jax():
    ref = JaxRun(4, 1, compute_dtype="bfloat16")
    ref_losses, _ = ref.first_step(with_grads=False)
    port = PortRun(ref, compute_dtype="bfloat16")
    assert port.r22.dtype == torch.bfloat16
    got, grads = port.first_step()
    np.testing.assert_allclose(got, ref_losses, rtol=5e-3)
    # Master weights and their gradients stay f32.
    assert all(p.dtype == torch.float32 for p in port.model.parameters())
    assert all(g.dtype == np.float32 and np.isfinite(g).all() for g in grads.values())


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_precompute_content_relu2_2_matches_jax(dtype):
    from artist_style_transfer_tpu.models.vgg import init_vgg16_params
    from artist_style_transfer_tpu.train.loop import precompute_content_relu2_2

    vgg_params = init_vgg16_params(jax.random.key(1))
    vgg = VGG16Features()
    vgg.load_state_dict(vgg16_state_dict_from_jax(numpy_tree(vgg_params)))
    content, _ = corpus(5)
    jdtype = None if dtype is None else jnp.bfloat16
    ref = np.asarray(precompute_content_relu2_2(vgg_params, jnp.asarray(content), chunk=2,
                                                dtype=jdtype).astype(jnp.float32))
    got = tloop.precompute_content_relu2_2(vgg, torch.from_numpy(content), chunk=2, dtype=dtype)
    assert got.dtype == (dtype or torch.float32) and tuple(got.shape) == ref.shape == (5, 16, 16, 128)
    tol = 1e-5 if dtype is None else 8e-3  # bf16 storage: one rounding of an f32 value
    assert np.abs(got.float().numpy() - ref).max() <= tol * np.abs(ref).max()


def test_epoch_permutation_is_a_seeded_permutation():
    a = tloop.epoch_permutation(2, 0, 9)
    assert sorted(a.tolist()) == list(range(9))
    assert torch.equal(a, tloop.epoch_permutation(2, 0, 9))
    assert not torch.equal(a, tloop.epoch_permutation(2, 1, 9))
    assert not torch.equal(a, tloop.epoch_permutation(3, 0, 9))


def test_loss_fn_indexes_cycle_targets_by_global_step():
    content, paintings = corpus(4)
    model, vgg = TransformerNet(), VGG16Features()
    targets = tstyles.build_style_targets("cycle", vgg, "X", paintings=paintings)
    opt, sched = tloop.make_optimizer(model.parameters(), LR, WD, 1, 2, 2)
    fns = tloop.make_step_fns("cycle", model, vgg, targets, opt, sched, content_weight=CW,
                              style_weight=SW, batch_size=B, num_content=4)
    params = dict(model.named_parameters())
    batch = torch.from_numpy(content[:B])
    r22 = tloop.precompute_content_relu2_2(vgg, batch)
    with torch.no_grad():
        s = [fns.loss_fn(params, batch, r22, targets.grams, step)[1][1].item()
             for step in (1, 1 + P, 2)]
    assert s[0] == s[1] != s[2]


def test_make_step_fns_refuses():
    model, vgg = TransformerNet(), VGG16Features()
    targets = tstyles.StyleTargets(mode="random", grams={})
    opt, sched = tloop.make_optimizer(model.parameters(), LR, WD, 1, 2, 1)
    kw = dict(content_weight=CW, style_weight=SW, batch_size=B)
    with pytest.raises(ValueError, match="needs a classifier"):
        tloop.make_step_fns("classifier", model, vgg, targets, opt, sched, num_content=4, **kw)
    with pytest.raises(ValueError, match="compute_dtype"):
        tloop.make_step_fns("random", model, vgg, targets, opt, sched, num_content=4,
                            compute_dtype="float16", **kw)
    with pytest.raises(ValueError, match="batch_size"):
        tloop.make_step_fns("random", model, vgg, targets, opt, sched, num_content=1, **kw)
