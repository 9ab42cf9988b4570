"""Quantization-aware training of the TransformerNet in the PyTorch port, held against the
JAX package on the CPU: ``conv2d_qat_int8`` over JAX's own configurations
(``tests/test_qat.py:53-104``), ``transformer_apply_qat`` under ``"trunk"`` and
``"all"``, and 'cycle' training with ``qat`` through the int8 loss extractor.

Inputs come from numpy seeds; the nets are JAX layouts drawn with numpy and carried
across by ``utils/jax_params.py``. Tolerances:

- ``conv2d_qat_int8`` on shared inputs: forward rtol 1e-5, ``dw`` and ``db`` 2e-5, ``dx``
  rtol 1e-3, atol 1e-4 (JAX's own bars); measured 0 for the forward and ``dx``, and
  about 1e-6 relative for ``dw`` and ``db`` (real-dtype sums in other orders);
- ``transformer_apply_qat`` on shared parameters: within 0.1 px of JAX's output, and
  nearer to it on average than JAX's QAT output is to the real one. An int8 layer's
  input code lands on the other side of a .5 where its f32 value differs in the
  last bit between the frameworks (the real convs and norms before it sum in other
  orders); every later layer then rounds that neighbourhood otherwise, so a flip
  costs up to the quantization's own noise there (measured in the test);
- the QAT trajectory against JAX's ``make_step_fns`` on the same parameters, data and
  permutations: per-epoch total losses within rtol 1e-2, the bar JAX's own QAT test
  reads the total by (measured gaps in the test);
- the port's own bar, QAT against the run without it: < 0.05 (JAX
  ``tests/test_qat.py:214``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from artist_style_transfer_tpu.ops import qconv as jqconv
from artist_style_transfer_tpu.ops.precision import precision as jprecision
from artist_style_transfer_tpu_torch.models import transformer_qat as tqat
from artist_style_transfer_tpu_torch.models.transformer import TransformerNet
from artist_style_transfer_tpu_torch.ops import qconv as tqconv
from artist_style_transfer_tpu_torch.train import train
from artist_style_transfer_tpu_torch.utils.jax_params import transformer_state_dict_from_jax
from tests.test_torch_classifier import numpy_params, rel_err
from tests.test_torch_data import one_torch_thread  # noqa: F401
from tests.test_torch_int8_train import (  # noqa: F401  (hooks: a fixture)
    hooks,
    jax_trajectory,
    nchw,
    nhwc,
    port_trajectory,
)

CONFIGS = [  # (k, stride, padding, lhs_dilation): JAX tests/test_qat.py:53-60
    (3, 1, (0, 0), 1),  # residual conv (reflect-padded by the caller)
    (3, 2, (0, 0), 1),  # encoder downsample conv
    (1, 1, (0, 0), 1),  # 1x1 trunk conv
    (3, 1, (1, 2), 2),  # ConvTranspose2d k3 s2 p1 op1
    (3, 1, (1, 1), 1),  # zero pads inside the op
    (3, 1, (0, 1), 1),  # asymmetric zero pads
    (3, 1, (2, 2), 2),  # an lhs-dilated conv without output padding
]


@pytest.mark.parametrize("k,stride,padding,lhs_d", CONFIGS,
                         ids=["k{}s{}p{}{}d{}".format(k, s, *p, d) for k, s, p, d in CONFIGS])
def test_qat_conv_matches_jax(k, stride, padding, lhs_d):
    """Forward, dw, db and dx against JAX ``conv2d_qat_int8``, weight OIHW in the port
    and HWIO in JAX; ``dw`` is a real-dtype gradient of the dequantized forward."""
    rng = np.random.default_rng(k + stride + lhs_d + sum(padding))
    x = rng.normal(size=(2, 10, 12, 8)).astype(np.float32)
    w = rng.normal(size=(k, k, 8, 6)).astype(np.float32)
    b = rng.normal(size=(6,)).astype(np.float32)
    y, vjp = jax.vjp(lambda xx, ww, bb: jqconv.conv2d_qat_int8(xx, ww, bb, stride,
                                                               (padding, padding), lhs_d),
                     jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    dy = rng.normal(size=y.shape).astype(np.float32)
    dx, dw, db = vjp(jnp.asarray(dy))

    xt = nchw(x).requires_grad_(True)
    wt = torch.from_numpy(np.transpose(w, (3, 2, 0, 1)).copy()).requires_grad_(True)
    bt = torch.from_numpy(b).requires_grad_(True)
    yt = tqconv.conv2d_qat_int8(xt, wt, bt, stride, padding, lhs_d)
    yt.backward(nchw(dy))
    np.testing.assert_allclose(nhwc(yt), np.asarray(y), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(wt.grad.permute(2, 3, 1, 0).numpy(), np.asarray(dw),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(db), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(nhwc(xt.grad), np.asarray(dx), rtol=1e-3, atol=1e-4)


def test_qat_conv_keeps_the_primal_dtypes_in_bf16():
    rng = np.random.default_rng(1)
    x = nchw(rng.normal(size=(1, 6, 6, 32))).to(torch.bfloat16).requires_grad_(True)
    w = torch.from_numpy(rng.normal(size=(64, 32, 3, 3)).astype(np.float32)).to(
        torch.bfloat16).requires_grad_(True)
    b = torch.zeros(64, dtype=torch.bfloat16, requires_grad=True)
    y = tqconv.conv2d_qat_int8(x, w, b, 2, (1, 1))
    y.float().square().sum().backward()
    assert y.dtype == x.grad.dtype == w.grad.dtype == b.grad.dtype == torch.bfloat16
    assert all(torch.isfinite(g.float()).all() for g in (x.grad, w.grad, b.grad))


def test_qat_conv_refuses_an_lhs_dilated_weight_gradient_it_cannot_form():
    x = torch.randn(1, 8, 5, 5, requires_grad=True)
    w = torch.randn(6, 8, 3, 3, requires_grad=True)
    y = tqconv.conv2d_qat_int8(x, w, torch.zeros(6, requires_grad=True), 1, (0, 3), 2)
    with pytest.raises(ValueError, match="lhs-dilated"):
        y.sum().backward()


# --- the QAT TransformerNet ------------------------------------------------------------


@pytest.fixture(scope="module")
def nets():
    from artist_style_transfer_tpu.models.transformer import init_transformer_params

    params = numpy_params(init_transformer_params, 0)
    model = TransformerNet()
    model.load_state_dict(transformer_state_dict_from_jax(params))
    return params, model


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("layers", ["trunk", "all"])
def test_transformer_apply_qat_matches_jax(nets, layers, seed):
    """The QAT forward within 0.1 px of JAX's, its mean gap under the mean gap between
    JAX's QAT and real outputs, and within 1.0 px of the real forward (JAX's bar).
    Measured, max / mean px against JAX, and JAX's QAT against its real forward:
    trunk 0.059 / 0.013 (seed 0, a flip), 2e-6 / 3e-7 (seeds 1, 2) against 0.09-0.10 /
    0.018-0.019; all 0.072 / 0.016, 0.0059 / 0.00014, 0.037 / 0.0065 against
    0.11 / 0.022-0.025. Every trained leaf gets a finite gradient, nonzero for every
    conv weight, every instance norm's gamma and the output conv (interior conv
    biases are 0 through the norm after them)."""
    from artist_style_transfer_tpu.models.transformer import transformer_apply
    from artist_style_transfer_tpu.models.transformer_qat import transformer_apply_qat as jqat

    params, model = nets
    x = (np.random.default_rng(seed).random((2, 32, 32, 3)) * 255).astype(np.float32)
    jparams = jax.tree.map(jnp.asarray, params)
    with jprecision("highest"):
        ref = np.asarray(jqat(jparams, jnp.asarray(x), layers))
        ref_real = np.asarray(transformer_apply(jparams, jnp.asarray(x)))
    got = tqat.transformer_apply_qat(model, torch.from_numpy(x), layers)
    assert got.shape == (2, 32, 32, 3)
    gap = np.abs(got.detach().numpy() - ref)
    assert gap.max() < 0.1 and gap.mean() < np.abs(ref - ref_real).mean(), gap.max()
    real = model(torch.from_numpy(x)).detach()
    assert (got.detach() - real).abs().max() < 1.0

    model.zero_grad(set_to_none=True)
    got.square().sum().backward()
    for name, p in model.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
        if name.endswith("weight"):
            assert p.grad.abs().max() > 0, name
    model.zero_grad(set_to_none=True)


def test_qat_forward_quantizes_the_convs_jax_picks(nets, monkeypatch):
    """``"trunk"`` sends the 13 convs with 128 output channels through the int8 conv
    (JAX's gate ``cout < 128``), ``"all"`` the 16 interior ones; the stem and output
    conv stay real. ``QATForward`` keeps the model's parameter names."""
    _, model = nets
    seen = []
    real = tqat.conv2d_qat_int8
    monkeypatch.setattr(tqat, "conv2d_qat_int8",
                        lambda x, w, *a: seen.append(tuple(w.shape)) or real(x, w, *a))
    x = torch.rand(1, 16, 16, 3) * 255
    with torch.no_grad():
        tqat.transformer_apply_qat(model, x, "trunk")
        assert len(seen) == 13 and all(s[0] == 128 for s in seen)
        seen.clear()
        tqat.transformer_apply_qat(model, x, "all")
        assert len(seen) == 16 and {s[0] for s in seen} == {32, 64, 128}
    fwd = tqat.QATForward(model, "all")
    assert [k for k, _ in fwd.named_parameters()] == [k for k, _ in model.named_parameters()]
    with pytest.raises(ValueError, match="layers"):
        tqat.transformer_apply_qat(model, x, "half")


# --- QAT training ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def qat_runs():
    ref = jax_trajectory("cycle", quantize_loss=True, qat="trunk")
    return ref, port_trajectory(ref)


def test_qat_trajectory_matches_jax(qat_runs):
    """'cycle' with ``qat="trunk"`` and the int8 loss extractor: per-epoch totals within
    rtol 1e-2 of JAX's, finite and falling. Measured over 3 epochs: total 7.6e-3,
    content 2.7e-3, style 1.6e-2 at most (the style term alone is past 1e-2); JAX's
    own trajectory moves by 4.8e-3 when the content images move by one f32 ulp."""
    ref, got = qat_runs
    assert np.isfinite(got).all() and got[-1, 2] < got[0, 2]
    np.testing.assert_allclose(got[:, 2], ref["losses"][:, 2], rtol=1e-2)


@pytest.mark.parametrize("qat", [True, "all"])
def test_train_qat_tracks_the_run_without_it(hooks, qat):
    """``train(qat=...)``: finite, falling, and within JAX's 0.05 of the same run
    without QAT (measured 2.4e-3 for "trunk" and 1.5e-3 for "all")."""
    _, plain = train("cycle", "A", **hooks)
    _, losses = train("cycle", "A", **hooks, qat=qat)
    assert np.isfinite(losses).all() and losses[-1, 2] < losses[0, 2]
    rel = np.abs(losses[:, 2] - plain[:, 2]) / plain[:, 2]
    assert rel.max() < 0.05, rel


def test_train_qat_with_remat_and_bf16(hooks):
    """``remat`` recomputes the QAT forward in the backward: the same losses; one bf16
    epoch with ``quantize_loss`` runs finite."""
    kw = dict(hooks, num_epochs=1)
    np.testing.assert_array_equal(train("cycle", "A", **kw, qat=True, remat=True)[1],
                                  train("cycle", "A", **kw, qat=True)[1])
    _, bf16 = train("cycle", "A", **kw, qat="all", quantize_loss=True, compute_dtype="bfloat16")
    assert np.isfinite(bf16).all()
