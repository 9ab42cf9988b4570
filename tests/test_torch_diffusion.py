"""Class-conditional diffusion in the PyTorch port (``diffusion/``) held against the JAX
package on the CPU, then the JAX package's behavioural cases rerun on the port.

Sizes as ``tests/test_diffusion.py``: 16x16 images, T = 16, base width 32. Shared
parameters are JAX pytrees drawn with numpy and carried to the port by
``diff_model_state_dict_from_jax``. Every weight is redrawn at O(1/sqrt(fan_in)) and
every bias, GroupNorm affine and class embedding at O(0.1-1): JAX initializes
``conv2``, ``attn.proj`` and ``conv_out`` at scale 1e-4 and the biases at 0, so on its
init every residual branch and the output are about 0 and a wrong res-block, attention
or upsample would still agree. JAX's random draws (x_T, the per-step noise, t, the
permutations) are made by running JAX's own key chain here and fed to the port through
its keyword-only seams (``x_T=``, ``noise=``, ``perms=``, ``draws=``). Bars:

- ``GaussianDiffusion.make``: the ten tables bit-equal (both compute in numpy f64 and
  cast to f32); ``q_sample``, ``predict_x0_from_eps``, ``q_posterior_mean``: rtol 1e-6;
- ``timestep_embedding``: atol 1e-5 (t up to 999: f32 arguments up to 999 rad);
  ``group_norm``: rtol 1e-5;
- ``diff_model_apply``: max abs difference within 1e-4 of JAX's max |output|;
- ``_classifier_logprob_grad`` through the ResNet-50 at 32x32: 2e-3 of max |grad| (the
  classifier bar of the North star);
- the samplers from JAX's x_T (and noise): PSNR > 45 dB on the [0, 255] outputs;
- ``train_diffusion``, 2 epochs on JAX's permutations and draws: per-epoch losses within
  rtol 1e-4, the returned EMA weights within 1e-6;
- ``frechet_distance`` rtol 1e-10; ``classifier_features`` 2e-3 of max; ``cfid`` rtol 1e-3;
- the ``.npz`` files: bit-exact both ways;
- DP ``train_diffusion(mesh=)`` over 2 gloo ranks against the port's one process on
  the same global batches and draws: losses within rtol 1e-5, the ranks' params
  bit-identical.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from artist_style_transfer_tpu.diffusion import evaluate as jevaluate
from artist_style_transfer_tpu.diffusion import gaussian as jgaussian
from artist_style_transfer_tpu.diffusion import sample as jsample
from artist_style_transfer_tpu.diffusion import unet as junet
from artist_style_transfer_tpu.diffusion.train import train_diffusion as jtrain_diffusion
from artist_style_transfer_tpu.train.checkpoint import load_params_npz as jload_params_npz
from artist_style_transfer_tpu.train.checkpoint import save_params_npz as jsave_params_npz
from artist_style_transfer_tpu.train.loop import epoch_permutation as jepoch_permutation
from artist_style_transfer_tpu_torch.diffusion import (
    GaussianDiffusion,
    diff_model_apply,
    diff_sample,
    diff_sample_ddim,
    diff_sample_dpmpp,
    init_diff_model,
    train_diffusion,
)
from artist_style_transfer_tpu_torch.diffusion import evaluate as tevaluate
from artist_style_transfer_tpu_torch.diffusion import sample as tsample
from artist_style_transfer_tpu_torch.diffusion import unet as tunet
from artist_style_transfer_tpu_torch.diffusion.unet import DiffModel
from artist_style_transfer_tpu_torch.models.resnet import init_classifier
from artist_style_transfer_tpu_torch.parallel import launch
from artist_style_transfer_tpu_torch.train.checkpoint import load_diff_model_npz, save_params_npz
from artist_style_transfer_tpu_torch.utils.jax_params import diff_model_state_dict_from_jax
from tests.test_torch_classifier import jax_classifier_params, port_classifier
from tests.test_torch_data import one_torch_thread  # noqa: F401

T = 16
HW = 16
BASE = 32
CLASSES = 3
GUIDANCE = 2.0


def numpy_diff_params(num_classes: int, seed: int, base: int = BASE) -> dict:
    """A JAX ``init_diff_model`` pytree redrawn with numpy: weights U(+-1/sqrt(fan_in)),
    biases and betas U(+-0.1), gammas U(0.8, 1.2), the class embedding N(0, 0.5^2)."""
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
        elif name == "class_emb":
            out = rng.standard_normal(shape) * 0.5
        else:
            raise KeyError(name)
        return out.astype(np.float32)

    shapes = jax.eval_shape(lambda k: junet.init_diff_model(k, num_classes, base),
                            jax.random.key(0))
    return jax.tree_util.tree_map_with_path(draw, shapes)


def port_model(tree: dict, num_classes: int = CLASSES, base: int = BASE) -> DiffModel:
    model = DiffModel(num_classes, base)
    model.load_state_dict(diff_model_state_dict_from_jax(tree))
    return model


def jax_sampler_draws(seed: int, n: int, steps: int):
    """x_T and the per-step noise stack JAX's samplers draw from ``jax.random.key(seed)``."""
    key, k0 = jax.random.split(jax.random.key(seed))
    x_T = jax.random.normal(k0, (n, HW, HW, 3), jnp.float32)
    noise = []
    for _ in range(steps):
        key, kn = jax.random.split(key)
        noise.append(jax.random.normal(kn, (n, HW, HW, 3), jnp.float32))
    return np.asarray(x_T), np.stack([np.asarray(z) for z in noise]) if noise else None


def psnr(a, b) -> float:
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return float(10.0 * np.log10(255.0**2 / mse)) if mse > 0 else float("inf")


@pytest.fixture(scope="module")
def shared():
    tree = numpy_diff_params(CLASSES, 11)
    clf_params = jax_classifier_params(5)
    return {"tree": tree, "model": port_model(tree), "clf_params": clf_params,
            "clf": port_classifier(clf_params),
            "jdiff": jgaussian.GaussianDiffusion.make(T), "tdiff": GaussianDiffusion.make(T)}


# --- parity with JAX ---------------------------------------------------------------------


@pytest.mark.parametrize("schedule", ["linear", "cosine"])
def test_schedule_tables_bit_equal(schedule):
    j = jgaussian.GaussianDiffusion.make(1000, schedule=schedule)
    t = GaussianDiffusion.make(1000, schedule=schedule)
    for f in dataclasses.fields(j):
        got, want = getattr(t, f.name), np.asarray(getattr(j, f.name))
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f.name)


def test_q_sample_posterior_and_x0_match_jax():
    rng = np.random.default_rng(0)
    x0, x_t, eps = (rng.standard_normal((3, HW, HW, 3)).astype(np.float32) for _ in range(3))
    t = np.array([0, 7, 999])
    j, d = jgaussian.GaussianDiffusion.make(1000), GaussianDiffusion.make(1000)
    tt = torch.as_tensor(t)
    pairs = [
        (d.q_sample(torch.as_tensor(x0), tt, torch.as_tensor(eps)), j.q_sample(x0, t, eps)),
        (d.predict_x0_from_eps(torch.as_tensor(x_t), tt, torch.as_tensor(eps)),
         j.predict_x0_from_eps(x_t, t, eps)),
        (d.q_posterior_mean(torch.as_tensor(x0), torch.as_tensor(x_t), tt),
         j.q_posterior_mean(x0, x_t, t)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


def test_timestep_embedding_matches_jax():
    t = np.array([0, 1, 17, 250, 999])
    got = tunet.timestep_embedding(torch.as_tensor(t), 64).numpy()
    np.testing.assert_allclose(got, np.asarray(junet.timestep_embedding(t, 64)), atol=1e-5)


@pytest.mark.parametrize("channels", [16, 64])
def test_group_norm_matches_jax(channels):
    rng = np.random.default_rng(channels)
    x = (rng.standard_normal((2, 6, 5, channels)) * 3 + 1).astype(np.float32)
    g = rng.uniform(0.5, 1.5, channels).astype(np.float32)
    b = rng.uniform(-0.5, 0.5, channels).astype(np.float32)
    got = tunet.group_norm(torch.as_tensor(x).permute(0, 3, 1, 2), torch.as_tensor(g),
                           torch.as_tensor(b)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, np.asarray(junet.group_norm(x, g, b)), rtol=1e-5, atol=1e-6)


def test_diff_model_apply_matches_jax():
    """Five classes, two images, every weight redrawn: within 1e-4 of max |JAX's output|."""
    tree = numpy_diff_params(5, 3)
    rng = np.random.default_rng(4)
    x = rng.uniform(-1, 1, (2, HW, HW, 3)).astype(np.float32)
    t, y = np.array([3, 11]), np.array([4, 1])
    want = np.asarray(junet.diff_model_apply(tree, x, t, y))  # un-jitted, as JAX's tests
    model = port_model(tree, 5)
    with torch.no_grad():
        got = diff_model_apply(model, torch.as_tensor(x), torch.as_tensor(t),
                               torch.as_tensor(y)).numpy()
    assert got.shape == want.shape == (2, HW, HW, 3)
    assert np.abs(want).max() > 0.1  # the redrawn net is far from JAX's near-zero init
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_classifier_logprob_grad_matches_jax(shared):
    rng = np.random.default_rng(6)
    x0 = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    y = np.array([3, 12])
    want = np.asarray(jax.jit(jsample._classifier_logprob_grad)(shared["clf_params"], x0, y))
    got = tsample._classifier_logprob_grad(shared["clf"], torch.as_tensor(x0),
                                           torch.as_tensor(y)).numpy()
    assert np.abs(got - want).max() <= 2e-3 * np.abs(want).max()


@pytest.mark.parametrize("sampler", ["ddim", "dpmpp"])
@pytest.mark.parametrize("guided", [False, True], ids=["unguided", "guided"])
def test_fast_samplers_match_jax(shared, sampler, guided):
    """DDIM (eta=0) and DPM++, 8 steps, from JAX's x_T; guided with a separate
    ``classifier_y`` in the 19-artist space."""
    y, cy = [0, 2], [3, 7]
    x_T, _ = jax_sampler_draws(1, 2, 0)
    guide = (dict(guidance_scale=GUIDANCE, classifier_y=jnp.asarray(cy, jnp.int32))
             if guided else {})
    jfn, tfn = ((jsample.diff_sample_ddim, diff_sample_ddim) if sampler == "ddim"
                else (jsample.diff_sample_dpmpp, diff_sample_dpmpp))
    want = np.asarray(jfn(shared["tree"], shared["jdiff"], jax.random.key(1),
                          jnp.asarray(y, jnp.int32), shape=(HW, HW), steps=8,
                          classifier_params=shared["clf_params"] if guided else None, **guide))
    got = tfn(shared["model"], shared["tdiff"], None, y, shape=(HW, HW), steps=8,
              classifier=shared["clf"] if guided else None,
              guidance_scale=GUIDANCE if guided else 0.0, classifier_y=cy if guided else None,
              x_T=x_T, device="cpu").numpy()
    assert psnr(got, want) > 45.0


def test_ddpm_guided_matches_jax(shared):
    """DDPM over all T = 16 steps from JAX's x_T and noise stack, guided."""
    y, cy = [1, 2], [11, 15]
    x_T, noise = jax_sampler_draws(4, 2, T)
    want = np.asarray(jsample.diff_sample(
        shared["tree"], shared["jdiff"], jax.random.key(4), jnp.asarray(y, jnp.int32),
        shape=(HW, HW), classifier_params=shared["clf_params"], guidance_scale=GUIDANCE,
        classifier_y=jnp.asarray(cy, jnp.int32)))
    got = diff_sample(shared["model"], shared["tdiff"], None, y, shape=(HW, HW),
                      classifier=shared["clf"], guidance_scale=GUIDANCE, classifier_y=cy,
                      x_T=x_T, noise=noise, device="cpu").numpy()
    assert psnr(got, want) > 45.0


def jax_train_draws(seed: int, epochs: int, n: int, batch: int):
    """JAX ``train_diffusion``'s permutations and per-step (t, noise), by its key chain."""
    perms, draws = [], []
    for epoch in range(epochs):
        perms.append(np.asarray(jepoch_permutation(seed, epoch, n)))
        key = jax.random.fold_in(jax.random.key(seed + 1), epoch)
        steps = []
        for _ in range(n // batch):
            key, kstep = jax.random.split(key)
            kt, kn = jax.random.split(kstep)
            steps.append((np.asarray(jax.random.randint(kt, (batch,), 0, T)),
                          np.asarray(jax.random.normal(kn, (batch, HW, HW, 3), jnp.float32))))
        draws.append(steps)
    return perms, draws


def test_train_diffusion_matches_jax():
    """2 epochs, 8 images, B=4 on JAX's permutations and draws, from shared redrawn
    weights: the epoch losses and the returned EMA weights."""
    rng = np.random.default_rng(8)
    imgs = (rng.random((8, HW, HW, 3)) * 255).astype(np.float32)
    labels = np.arange(8) % CLASSES
    tree = numpy_diff_params(CLASSES, 21)
    kw = dict(num_classes=CLASSES, num_timesteps=T, num_epochs=2, batch_size=4, lr=1e-4,
              seed=5, base_channels=BASE, wordy=False)
    j_params, _, j_losses = jtrain_diffusion(imgs, labels, params=tree, **kw)
    perms, draws = jax_train_draws(5, 2, 8, 4)
    model, _, losses = train_diffusion(imgs, labels, params=port_model(tree), device="cpu",
                                       perms=perms, draws=draws, **kw)
    np.testing.assert_allclose(losses, j_losses, rtol=1e-4)
    want = diff_model_state_dict_from_jax(jax.tree.map(np.asarray, j_params))
    got = model.state_dict()
    assert got.keys() == want.keys()
    worst = max(float((got[k] - want[k]).abs().max()) for k in want)
    assert worst <= 1e-6, worst
    # the EMA moved off the start
    start = diff_model_state_dict_from_jax(tree)
    assert max(float((got[k] - start[k]).abs().max()) for k in start) > 0.0


def test_frechet_distance_matches_jax():
    rng = np.random.default_rng(9)
    a, b = rng.standard_normal((40, 8)), rng.standard_normal((40, 8)) * 1.5 + 0.3
    (mu1, s1), (mu2, s2) = tevaluate._mean_cov(a), tevaluate._mean_cov(b)
    jm1, js1 = jevaluate._mean_cov(a)
    np.testing.assert_array_equal(mu1, jm1)
    np.testing.assert_array_equal(s1, js1)
    np.testing.assert_allclose(tevaluate.frechet_distance(mu1, s1, mu2, s2),
                               jevaluate.frechet_distance(mu1, s1, mu2, s2), rtol=1e-10)


def test_classifier_features_and_cfid_match_jax(shared):
    rng = np.random.default_rng(10)
    real = (rng.random((6, HW, HW, 3)) * 255).astype(np.float32)
    dark = (rng.random((6, HW, HW, 3)) * 64).astype(np.float32)
    want = jevaluate.classifier_features(shared["clf_params"], real, batch=4)
    got = tevaluate.classifier_features(shared["clf"], real, batch=4, device="cpu")
    assert got.shape == want.shape == (6, 512)
    assert np.abs(got - want).max() <= 2e-3 * np.abs(want).max()
    np.testing.assert_allclose(
        tevaluate.cfid(shared["clf"], real, dark, batch=4, device="cpu"),
        jevaluate.cfid(shared["clf_params"], real, dark, batch=4), rtol=1e-3)


def test_npz_interop_both_ways(shared, tmp_path):
    """A JAX-written ``.npz`` loads into the port bit-exactly, and the port's loads into
    JAX's ``load_params_npz`` bit-exactly."""
    tree = shared["tree"]
    jpath = str(tmp_path / "jax.npz")
    jsave_params_npz(jpath, tree)
    sd = load_diff_model_npz(jpath)
    want = diff_model_state_dict_from_jax(tree)
    assert sd.keys() == want.keys()
    assert all(torch.equal(sd[k], want[k]) for k in want)
    model = DiffModel(CLASSES, BASE)
    model.load_state_dict(sd)  # strict: every key of the module, no other

    tpath = str(tmp_path / "port.npz")
    save_params_npz(tpath, model)
    back = jload_params_npz(tpath, tree)
    for (path, leaf), (_, ref) in zip(jax.tree_util.tree_flatten_with_path(back)[0],
                                      jax.tree_util.tree_flatten_with_path(tree)[0]):
        np.testing.assert_array_equal(np.asarray(leaf), ref, err_msg=jax.tree_util.keystr(path))
    assert set(np.load(tpath).files) == set(np.load(jpath).files)


def _dp_rank(mesh, imgs, labels, kw):
    """``train_diffusion(mesh=)`` on this rank: its losses and the returned weights."""
    model, _, losses = train_diffusion(imgs, labels, mesh=mesh, device=mesh.device, **kw)
    return {"losses": losses, "params": {k: v.numpy() for k, v in model.state_dict().items()}}


def test_dp_train_diffusion_two_ranks():
    """Two gloo ranks on the CPU against the port's one process on the same global
    batches and draws (the port's own seeded permutation and CPU generator)."""
    rng = np.random.default_rng(12)
    imgs = (rng.random((8, HW, HW, 3)) * 255).astype(np.float32)
    labels = np.arange(8) % 2
    kw = dict(num_classes=2, num_timesteps=T, num_epochs=2, batch_size=4, lr=3e-4,
              base_channels=BASE, wordy=False, seed=3)
    _, _, single = train_diffusion(imgs, labels, device="cpu", **kw)
    ranks = launch(_dp_rank, 2, imgs, labels, kw, backend="gloo", device="cpu")
    np.testing.assert_allclose(ranks[0]["losses"], single, rtol=1e-5)
    np.testing.assert_array_equal(ranks[1]["losses"], ranks[0]["losses"])
    for k, v in ranks[0]["params"].items():
        np.testing.assert_array_equal(ranks[1]["params"][k], v, err_msg=k)


# --- the JAX package's behavioural cases (tests/test_diffusion.py), on the port ----------


def seeded_model(num_classes: int = CLASSES, seed: int = 0) -> DiffModel:
    return init_diff_model(num_classes, BASE, generator=torch.Generator().manual_seed(seed))


def gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def test_schedule_coefficients():
    d = GaussianDiffusion.make(num_timesteps=T)
    assert d.num_timesteps == T
    acp = d.alphas_cumprod.numpy()
    assert np.all(np.diff(acp) < 0) and acp[0] < 1.0 and acp[-1] > 0.0
    np.testing.assert_allclose(
        d.sqrt_alphas_cumprod.numpy() ** 2 + d.sqrt_one_minus_alphas_cumprod.numpy() ** 2,
        1.0, rtol=1e-5)


def test_q_sample_and_x0_roundtrip():
    d = GaussianDiffusion.make(num_timesteps=T)
    rng = np.random.default_rng(0)
    x0 = torch.as_tensor(rng.standard_normal((2, HW, HW, 3)).astype(np.float32))
    noise = torch.as_tensor(rng.standard_normal((2, HW, HW, 3)).astype(np.float32))
    t = torch.tensor([3, 9])
    x0_rec = d.predict_x0_from_eps(d.q_sample(x0, t, noise), t, noise)
    np.testing.assert_allclose(x0_rec.numpy(), x0.numpy(), rtol=1e-4, atol=1e-5)


def test_unet_shapes_and_conditioning():
    model = init_diff_model(5, BASE, generator=gen(0))
    x = torch.as_tensor(np.random.default_rng(1).standard_normal((2, HW, HW, 3)),
                        dtype=torch.float32)
    t = torch.tensor([1, 5])
    with torch.no_grad():
        out_a = diff_model_apply(model, x, t, torch.tensor([0, 1]))
        out_b = diff_model_apply(model, x, t, torch.tensor([2, 3]))
        out_c = diff_model_apply(model, x, torch.tensor([9, 12]), torch.tensor([0, 1]))
    assert out_a.shape == x.shape
    # the output conv starts near zero: compare against exact equality
    assert (out_a - out_b).abs().max() > 0.0
    assert (out_a - out_c).abs().max() > 0.0


def test_train_diffusion_reduces_loss():
    rng = np.random.default_rng(2)
    imgs = (rng.random((8, HW, HW, 3)) * 255).astype(np.float32)
    _, _, losses = train_diffusion(imgs, np.arange(8) % 3, num_classes=3, num_timesteps=T,
                                   num_epochs=4, batch_size=4, base_channels=BASE, lr=3e-4,
                                   wordy=False, device="cpu")
    assert np.all(np.isfinite(losses))
    assert losses[-1] < losses[0]


def test_cosine_schedule_properties():
    d = GaussianDiffusion.make(num_timesteps=100, schedule="cosine")
    acp, betas = d.alphas_cumprod.numpy(), d.betas.numpy()
    assert acp[0] > 0.99
    assert np.all(np.diff(acp) < 0)
    assert betas.min() > 0 and betas.max() <= 0.999
    assert np.allclose(d.sqrt_alphas_cumprod.numpy() ** 2
                       + d.sqrt_one_minus_alphas_cumprod.numpy() ** 2, 1.0, atol=1e-5)
    with pytest.raises(ValueError):
        GaussianDiffusion.make(num_timesteps=10, schedule="bogus")


def test_train_diffusion_ema_weights():
    """The EMA weights differ from the raw ones over the same trajectory."""
    rng = np.random.default_rng(4)
    imgs = (rng.random((4, HW, HW, 3)) * 255).astype(np.float32)
    kw = dict(num_classes=2, num_timesteps=T, num_epochs=2, batch_size=2, base_channels=BASE,
              lr=3e-4, wordy=False, seed=7, device="cpu")
    raw, _, l_raw = train_diffusion(imgs, np.arange(4) % 2, ema_decay=None, **kw)
    ema, _, l_ema = train_diffusion(imgs, np.arange(4) % 2, ema_decay=0.9, **kw)
    np.testing.assert_allclose(l_raw, l_ema, rtol=1e-6)  # same trajectory
    assert max(float((a - b).abs().max()) for a, b in
               zip(raw.state_dict().values(), ema.state_dict().values())) > 0.0


def test_diff_sample_shapes_and_guidance():
    model, d = seeded_model(), GaussianDiffusion.make(num_timesteps=T)
    out = diff_sample(model, d, gen(1), [0, 2], shape=(HW, HW), device="cpu")
    assert out.shape == (2, HW, HW, 3)
    o = out.numpy()
    assert o.min() >= 0.0 and o.max() <= 255.0 and np.all(np.isfinite(o))
    clf = init_classifier(gen(2), num_classes=3)
    guided = diff_sample(model, d, gen(1), [0, 2], shape=(HW, HW), classifier=clf,
                         guidance_scale=2.0, device="cpu")
    assert guided.shape == (2, HW, HW, 3)
    assert not np.allclose(guided.numpy(), o)


def test_diff_sample_ddim_deterministic_and_guided():
    model, d = seeded_model(), GaussianDiffusion.make(num_timesteps=T)
    kw = dict(shape=(HW, HW), steps=6, device="cpu")
    a = diff_sample_ddim(model, d, gen(1), [0, 2], **kw).numpy()
    b = diff_sample_ddim(model, d, gen(1), [0, 2], **kw).numpy()
    assert a.shape == (2, HW, HW, 3)
    np.testing.assert_array_equal(a, b)  # eta=0: deterministic
    assert a.min() >= 0.0 and a.max() <= 255.0 and np.all(np.isfinite(a))
    assert not np.allclose(diff_sample_ddim(model, d, gen(9), [0, 2], **kw).numpy(), a)
    assert not np.allclose(diff_sample_ddim(model, d, gen(1), [0, 2], eta=1.0, **kw).numpy(), a)
    clf = init_classifier(gen(2), num_classes=3)
    g = diff_sample_ddim(model, d, gen(1), [0, 2], classifier=clf, guidance_scale=2.0,
                         **kw).numpy()
    assert np.all(np.isfinite(g)) and not np.allclose(g, a)


def test_diff_sample_dpmpp_deterministic_and_converges():
    model, d = seeded_model(), GaussianDiffusion.make(num_timesteps=T)
    kw = dict(shape=(HW, HW), device="cpu")
    a = diff_sample_dpmpp(model, d, gen(1), [0, 2], steps=8, **kw).numpy()
    b = diff_sample_dpmpp(model, d, gen(1), [0, 2], steps=8, **kw).numpy()
    assert a.shape == (2, HW, HW, 3)
    np.testing.assert_array_equal(a, b)
    assert a.min() >= 0.0 and a.max() <= 255.0 and np.all(np.isfinite(a))
    assert not np.allclose(diff_sample_dpmpp(model, d, gen(9), [0, 2], steps=8, **kw).numpy(), a)
    g = diff_sample_dpmpp(model, d, gen(1), [0, 2], steps=8,
                          classifier=init_classifier(gen(2), num_classes=3), guidance_scale=2.0,
                          **kw).numpy()
    assert np.all(np.isfinite(g)) and not np.allclose(g, a)
    # against a fine DDIM(eta=0) reference from the same initial noise
    ref = diff_sample_ddim(model, d, gen(1), [0, 2], steps=T, **kw).numpy()
    assert float(np.mean((a - ref) ** 2) ** 0.5) < 2.0
    with pytest.raises(ValueError, match="steps >= 2"):
        diff_sample_dpmpp(model, d, gen(1), [0], steps=1, **kw)


def test_dpmpp_second_order_on_linear_model(monkeypatch):
    """With a linear eps model (eps = 0.25 x, no clipping) the second-order solver at 8
    steps beats first-order DDIM at 8 steps against a 200-step reference."""
    monkeypatch.setattr(tsample, "diff_model_apply", lambda m, x, t, y: 0.25 * x)
    T2, hw = 200, 8
    model, d = seeded_model(), GaussianDiffusion.make(num_timesteps=T2)
    kw = dict(shape=(hw, hw), clip_x0=False, device="cpu")

    def rms(a, b):
        return float(torch.sqrt(torch.mean((a - b) ** 2)))

    ref = diff_sample_ddim(model, d, gen(3), [0], steps=T2, **kw)
    err_dpm = rms(diff_sample_dpmpp(model, d, gen(3), [0], steps=8, **kw), ref)
    err_ddim = rms(diff_sample_ddim(model, d, gen(3), [0], steps=8, **kw), ref)
    assert err_dpm < err_ddim, (err_dpm, err_ddim)


def test_unet_rejects_indivisible_extent():
    model = init_diff_model(2, BASE, generator=gen(0))
    with pytest.raises(ValueError, match="divisible by 4"):
        diff_model_apply(model, torch.zeros((1, 50, 48, 3)), torch.zeros(1, dtype=torch.int64),
                         torch.zeros(1, dtype=torch.int64))


def test_diff_sample_separate_classifier_labels():
    model, d = seeded_model(2), GaussianDiffusion.make(num_timesteps=T)
    clf = init_classifier(gen(2), num_classes=19)
    kw = dict(shape=(HW, HW), classifier=clf, guidance_scale=2.0, device="cpu")
    a = diff_sample(model, d, gen(1), [0, 1], classifier_y=[3, 7], **kw)
    b = diff_sample(model, d, gen(1), [0, 1], classifier_y=[11, 15], **kw)
    assert a.shape == (2, HW, HW, 3)
    assert not np.allclose(a.numpy(), b.numpy())


def test_frechet_distance_analytic():
    rng = np.random.default_rng(0)
    dim = 6
    mu1, mu2 = rng.standard_normal(dim), rng.standard_normal(dim)
    a, b = rng.random(dim) + 0.5, rng.random(dim) + 0.5
    want = float(np.sum((mu1 - mu2) ** 2) + np.sum((np.sqrt(a) - np.sqrt(b)) ** 2))
    np.testing.assert_allclose(tevaluate.frechet_distance(mu1, np.diag(a), mu2, np.diag(b)),
                               want, rtol=1e-10)
    q, _ = np.linalg.qr(rng.standard_normal((dim, dim)))
    s = q @ np.diag(rng.random(dim) + 0.1) @ q.T
    assert abs(tevaluate.frechet_distance(mu1, s, mu1, s)) < 1e-9
    s2 = q @ np.diag(rng.random(dim) + 0.1) @ q.T
    np.testing.assert_allclose(tevaluate.frechet_distance(mu1, s, mu2, s2),
                               tevaluate.frechet_distance(mu2, s2, mu1, s), rtol=1e-9)


def test_cfid_discriminates():
    rng = np.random.default_rng(1)
    clf = init_classifier(gen(0), num_classes=3)
    real = (rng.random((12, HW, HW, 3)) * 255).astype(np.float32)
    same = tevaluate.cfid(clf, real, real.copy(), batch=6, device="cpu")
    far = tevaluate.cfid(clf, real, (rng.random((12, HW, HW, 3)) * 64).astype(np.float32),
                         batch=6, device="cpu")
    assert abs(same) < 1e-6
    assert far > same + 1e-3


def test_cfid_curve_orderings_checker():
    """The orderings ``chip_smoke.py`` holds on the card's CFID curve (those of
    ``tests/test_diffusion.py``'s artifact test, read at 3 decimals) pass on the
    committed JAX curve and fail on curves that break each of them."""
    import chip_smoke

    path = os.path.join(os.path.dirname(__file__), "goldens", "diffusion_cfid_curve.json")
    with open(path) as f:
        curve = {k: v["cfid"] for k, v in json.load(f)["curve"].items()}
    assert chip_smoke.cfid_curve_orderings(curve) == []
    for name, value in (("ddpm-1000", 0.05), ("dpmpp-12", 0.05), ("dpmpp-4", 0.05),
                        ("ddim-3", 0.038), ("ddim-2", 0.04), ("dpmpp-2", 0.038)):
        assert chip_smoke.cfid_curve_orderings(dict(curve, **{name: value})), name
