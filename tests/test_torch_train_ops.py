"""The training slice's ops of the PyTorch port, held against the JAX package on the CPU:
the instance-norm backward, the TransformerNet's init and gradients,
the style targets of the four Gram modes, the 'cycle' step selection, the
optimizer, and the state-dict -> JAX pytree converter.

Tolerances: f32 gradients and Grams within 1e-5 of the largest entry (f32
reductions in another order); the optimizer's O(1) parameters within 1e-6
after 6 steps, a few f32 ulps (the same Adam arithmetic up to rounding); the
TransformerNet's parameter gradients under a random cotangent within 1e-4 of
each leaf's largest entry, the bound of the train-step test.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from artist_style_transfer_tpu_torch.models import transformer as ttransformer
from artist_style_transfer_tpu_torch.models import vgg as tvgg
from artist_style_transfer_tpu_torch.ops import norm as tnorm
from artist_style_transfer_tpu_torch.ops import precision as tprecision
from artist_style_transfer_tpu_torch.train import loop as tloop
from artist_style_transfer_tpu_torch.train import styles as tstyles
from artist_style_transfer_tpu_torch.utils.jax_params import (
    transformer_state_dict_from_jax,
    transformer_state_dict_to_jax,
    vgg16_state_dict_from_jax,
)
from tests.test_torch_data import one_torch_thread  # noqa: F401

SIZE = 32


def nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def rel_err(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def zero_grad_leaf(name: str) -> bool:
    """Leaves whose exact gradient is 0: a conv bias feeding an instance norm, and a
    residual block's last norm bias, a per-channel constant the next norm removes.
    What both frameworks give there is rounding noise."""
    return (name.endswith(("conv_transpose.bias", "conv_layer.bias"))
            and not name.startswith("DeconvBlock.6")) or name.endswith("conv2.norm_layer.bias")


def assert_grads_close(got: dict, ref: dict, tol: float) -> None:
    """Each leaf within ``tol`` of its largest entry; exactly-zero leaves within
    ``tol`` of the largest gradient of the whole net."""
    top = max(float(np.abs(np.asarray(v)).max()) for v in ref.values())
    for k, g in got.items():
        g, r = np.asarray(g, np.float64), np.asarray(ref[k], np.float64)
        scale = top if zero_grad_leaf(k) else np.abs(r).max()
        assert np.abs(g - r).max() <= tol * scale, k


@pytest.fixture(scope="module")
def jax_params():
    from artist_style_transfer_tpu.models.transformer import init_transformer_params
    from artist_style_transfer_tpu.models.vgg import init_vgg16_params

    return (jax.tree.map(np.asarray, init_transformer_params(jax.random.key(0))),
            jax.tree.map(np.asarray, init_vgg16_params(jax.random.key(1))))


@pytest.fixture(scope="module")
def port_vgg(jax_params):
    model = tvgg.VGG16Features()
    model.load_state_dict(vgg16_state_dict_from_jax(jax_params[1]))
    return model


# --- instance norm ------------------------------------------------------------------


@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("form", ["instance_norm", "instance_norm_act", "act_no_relu", "composed_relu"])
def test_instance_norm_grads_match_jax_vjp(form, precision):
    """dx, dgamma, dbeta of each IN form against ``jax.vjp`` of the JAX function,
    under both variance forms of the precision policy."""
    from artist_style_transfer_tpu.ops import norm as jnorm
    from artist_style_transfer_tpu.ops.precision import precision as jprecision

    rng = np.random.default_rng(3)
    x = (rng.standard_normal((2, 7, 9, 6)) * 3 + 1).astype(np.float32)
    gamma = rng.standard_normal(6).astype(np.float32)
    beta = rng.standard_normal(6).astype(np.float32)
    dy = rng.standard_normal(x.shape).astype(np.float32)
    jfn = {
        "instance_norm": jnorm.instance_norm,
        "instance_norm_act": lambda a, g, b: jnorm.instance_norm_act(a, g, b, True),
        "act_no_relu": lambda a, g, b: jnorm.instance_norm_act(a, g, b, False),
        "composed_relu": lambda a, g, b: jax.nn.relu(jnorm.instance_norm(a, g, b)),
    }[form]
    tfn = {
        "instance_norm": tnorm.instance_norm,
        "instance_norm_act": lambda a, g, b: tnorm.instance_norm_act(a, g, b, True),
        "act_no_relu": lambda a, g, b: tnorm.instance_norm_act(a, g, b, False),
        "composed_relu": lambda a, g, b: torch.relu(tnorm.instance_norm(a, g, b)),
    }[form]
    with jprecision(precision):
        y_ref, vjp = jax.vjp(jfn, jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta))
        refs = [np.asarray(r) for r in vjp(jnp.asarray(dy))]
    with tprecision.precision(precision):
        xt = nchw(x).requires_grad_(True)
        gt = torch.from_numpy(gamma).requires_grad_(True)
        bt = torch.from_numpy(beta).requires_grad_(True)
        y = tfn(xt, gt, bt)
        y.backward(nchw(dy))
    assert rel_err(y.detach().permute(0, 2, 3, 1).numpy(), y_ref) <= 1e-5
    assert rel_err(xt.grad.permute(0, 2, 3, 1).numpy(), refs[0]) <= 1e-5
    assert rel_err(gt.grad.numpy(), refs[1]) <= 1e-5
    assert rel_err(bt.grad.numpy(), refs[2]) <= 1e-5


@pytest.mark.parametrize("relu", [False, True])
def test_instance_norm_gradcheck_f64(relu):
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2, 3, 4, 5)) * 2 + 0.5).requires_grad_(True)
    gamma = torch.from_numpy(rng.standard_normal(3)).requires_grad_(True)
    beta = torch.from_numpy(rng.standard_normal(3)).requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda a, g, b: tnorm.instance_norm_act(a, g, b, relu), (x, gamma, beta))


def test_instance_norm_backward_keeps_channels_last_and_dtype():
    x = torch.randn(2, 8, 6, 6).to(memory_format=torch.channels_last).requires_grad_(True)
    gamma = torch.ones(8, requires_grad=True)
    beta = torch.zeros(8, requires_grad=True)
    dy = torch.randn(2, 8, 6, 6)  # a contiguous NCHW cotangent
    tnorm.instance_norm_act(x, gamma, beta).backward(dy)
    assert x.grad.is_contiguous(memory_format=torch.channels_last)
    xb = x.detach().bfloat16().requires_grad_(True)
    gb, bb = gamma.detach().bfloat16().requires_grad_(True), beta.detach().bfloat16().requires_grad_(True)
    yb = tnorm.instance_norm(xb, gb, bb)
    yb.backward(torch.ones_like(yb))
    assert yb.dtype == xb.grad.dtype == gb.grad.dtype == torch.bfloat16


# --- TransformerNet -------------------------------------------------------------------


def test_init_transformer_is_seeded_torch_default(jax_params):
    a = ttransformer.init_transformer(torch.Generator().manual_seed(5))
    b = ttransformer.init_transformer(torch.Generator().manual_seed(5))
    c = ttransformer.init_transformer(torch.Generator().manual_seed(6))
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["ConvBlock.0.conv_layer.weight"], sc["ConvBlock.0.conv_layer.weight"])
    assert sum(p.numel() for p in a.parameters()) == ttransformer.TRANSFORMER_PARAM_COUNT
    # JAX's draw has the same bounds: U(+-1/sqrt(fan_in)), fan_in = cout*k*k for a
    # transpose conv (weight dim 1 in torch's layout), norms at gamma 1, beta 0.
    ref = transformer_state_dict_from_jax(jax_params[0])
    for k, v in sa.items():
        if ".norm_layer." in k:
            fill = 1.0 if k.endswith("weight") else 0.0
            assert torch.equal(v, torch.full_like(v, fill)) and torch.equal(ref[k], v)
            continue
        w = sa[k.rsplit(".", 1)[0] + ".weight"]
        lim = 1.0 / (w.shape[1] * w.shape[2] * w.shape[3]) ** 0.5
        floor = 0.5 * lim if v.numel() >= 32 else 0.0  # spread over the range, not a constant
        assert floor < float(v.abs().max()) <= lim, k
        assert floor < float(ref[k].abs().max()) <= lim * (1 + 1e-6), k


@pytest.mark.parametrize("precision", ["highest", "default"])
def test_transformer_grads_match_jax(jax_params, precision):
    """Forward and parameter gradients under a random cotangent, in parity mode
    (two-pass variance; JAX composes IN and ReLU there) and fast mode (one-pass
    variance; JAX's ``instance_norm_act``)."""
    from artist_style_transfer_tpu.models.transformer import transformer_apply
    from artist_style_transfer_tpu.ops.precision import precision as jprecision

    params = jax_params[0]
    rng = np.random.default_rng(2)
    x = rng.uniform(0, 255, (2, SIZE, SIZE, 3)).astype(np.float32)
    ct = rng.standard_normal(x.shape).astype(np.float32)
    def fwd_vjp(p, xx, cc):
        y_, vjp = jax.vjp(lambda q: transformer_apply(q, xx), p)
        return y_, vjp(cc)[0]

    with jprecision(precision):  # traced inside: the precision is read at trace time
        y_ref, g = jax.jit(fwd_vjp)(jax.tree.map(jnp.asarray, params), jnp.asarray(x),
                                    jnp.asarray(ct))
        grads = transformer_state_dict_from_jax(jax.tree.map(np.asarray, g))
    model = ttransformer.TransformerNet()
    model.load_state_dict(transformer_state_dict_from_jax(params))
    with tprecision.precision(precision):
        y = model(torch.from_numpy(x))
        got = dict(zip([k for k, _ in model.named_parameters()],
                       torch.autograd.grad(y, list(model.parameters()), torch.from_numpy(ct))))
    assert rel_err(y.detach().numpy(), y_ref) <= 1e-5
    assert_grads_close({k: g.numpy() for k, g in got.items()},
                       {k: g.numpy() for k, g in grads.items()}, 1e-4)


def test_transformer_state_dict_to_jax_inverts_and_matches_jax_importer(jax_params):
    from artist_style_transfer_tpu.utils.torch_import import transformer_params_from_torch

    params = jax_params[0]
    model = ttransformer.TransformerNet()
    model.load_state_dict(transformer_state_dict_from_jax(params))
    back = transformer_state_dict_to_jax(model.state_dict())
    theirs = transformer_params_from_torch({k: v.numpy() for k, v in model.state_dict().items()})
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b, c in zip(jax.tree.leaves(back), jax.tree.leaves(params), jax.tree.leaves(theirs)):
        assert a.dtype == np.float32 and a.flags.c_contiguous
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, np.asarray(c))


def test_precision_sets_bf16_reduction_flag():
    assert tprecision.get_precision() == "highest"
    assert torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction is False
    with tprecision.precision("default"):
        assert torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction is True
    assert torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction is False


# --- style targets ----------------------------------------------------------------------


def paintings(n: int = 3, seed: int = 7) -> np.ndarray:
    return np.random.default_rng(seed).uniform(0, 255, (n, SIZE, SIZE, 3)).astype(np.float32)


@pytest.mark.parametrize("mode", ["random", "average", "smartaverage", "cycle"])
def test_build_style_targets_match_jax(jax_params, port_vgg, mode):
    from artist_style_transfer_tpu.train.styles import build_style_targets

    imgs = paintings()
    ref = build_style_targets(mode, jax.tree.map(jnp.asarray, jax_params[1]), "X",
                              paintings=imgs, avg_image=imgs.mean(0),
                              rng=np.random.default_rng(11), chunk=2)
    got = tstyles.build_style_targets(mode, port_vgg, "X", paintings=imgs,
                                      avg_image=imgs.mean(0), rng=np.random.default_rng(11),
                                      chunk=2)
    assert got.mode == mode and got.num_cycle == ref.num_cycle == (3 if mode == "cycle" else 0)
    assert sorted(got.grams) == sorted(ref.grams)
    for k, v in got.grams.items():
        assert v.dtype == torch.float32 and tuple(v.shape) == ref.grams[k].shape
        assert rel_err(v.numpy(), ref.grams[k]) <= 1e-5, k
    if ref.style_preview_bgr is not None:
        np.testing.assert_array_equal(got.style_preview_bgr, ref.style_preview_bgr)
    else:
        assert got.style_preview_bgr is None


def test_build_style_targets_refuses(port_vgg):
    with pytest.raises(ValueError, match="not in tuple"):  # not one of the 19 artists
        tstyles.build_style_targets("classifier", port_vgg, "X")
    with pytest.raises(ValueError, match="valid style method"):
        tstyles.build_style_targets("nope", port_vgg, "X", paintings=paintings())
    with pytest.raises(ValueError, match="at least one painting"):
        tstyles.build_style_targets("cycle", port_vgg, "X", paintings=paintings()[:0])
    with pytest.raises(ValueError, match="avg_image"):
        tstyles.build_style_targets("average", port_vgg, "X", paintings=paintings())


def test_select_step_grams_across_epoch_boundary():
    """The global step indexes the paintings: steps 0..7 over P=3 with 2 steps an
    epoch give 0,1 | 2,0 | 1,2 | 0,1, as JAX's ``select_step_grams``."""
    from artist_style_transfer_tpu.train.styles import select_step_grams

    stack = np.random.default_rng(1).standard_normal((3, 4, 4)).astype(np.float32)
    grams = {"relu1_2": torch.from_numpy(stack)}
    targets = tstyles.StyleTargets(mode="cycle", grams=grams, num_cycle=3)
    for epoch in range(4):
        for i in range(2):
            step = epoch * 2 + i
            got = targets.gram_for_step(step)["relu1_2"]
            ref = select_step_grams({"relu1_2": jnp.asarray(stack)}, jnp.int32(step), 3)
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref["relu1_2"]))
            np.testing.assert_array_equal(got.numpy(), stack[step % 3])
    assert tstyles.select_step_grams(grams, 5, 0) is grams


# --- optimizer -------------------------------------------------------------------------


@pytest.mark.parametrize(
    "num_epochs,num_steps,steps_per_epoch",
    [(4, 2, 2), (6, 2, 1), (1, 3, 3)],  # the last: num_epochs < num_steps halves every step
)
def test_make_optimizer_matches_optax(num_epochs, num_steps, steps_per_epoch):
    import optax

    from artist_style_transfer_tpu.train.loop import make_optimizer

    rng = np.random.default_rng(num_epochs)
    p0 = {"w": rng.standard_normal((3, 4)).astype(np.float32),
          "b": rng.standard_normal(4).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) for k, v in p0.items()}
             for _ in range(6)]
    lr, wd = 0.01, 1e-2
    tx = make_optimizer(lr, wd, num_epochs, num_steps, steps_per_epoch)
    jp = jax.tree.map(jnp.asarray, p0)
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    opt, sched = tloop.make_optimizer(list(tp.values()), lr, wd, num_epochs, num_steps,
                                      steps_per_epoch)
    decay_every = max(1, (num_epochs // max(1, num_steps)) * steps_per_epoch)
    for i, g in enumerate(grads):
        assert opt.param_groups[0]["lr"] == pytest.approx(lr * 0.5 ** (i // decay_every))
        updates, state = tx.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, v in tp.items():
            v.grad = torch.from_numpy(g[k])
        opt.step()
        sched.step()
        for k, v in tp.items():
            np.testing.assert_allclose(v.detach().numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-6)
