"""The int8 training slice of the PyTorch port held against the JAX package on the CPU:
the STE data gradient of ``conv2d_frozen_int8``, ``_dgrad_pad``, the int8 Gram and
the loss gate that picks it, the quantized VGG16 loss extractor, and 'cycle' and
'classifier' training through the int8 loss nets; the options ``train()`` and the
CLI now accept, and the refusals that stay.

Inputs come from numpy seeds; training runs at 32x32, 8 content images, 3
paintings, B=4, as JAX ``tests/test_quant_loss.py:112-133``, in f32 with precision
"highest" on both sides. Tolerances:

- codes and the int32 dgrad accumulator: exactly JAX's (round half to even, an
  exact integer sum, on shared inputs); dx within rtol 1e-5, atol 1e-4 (JAX
  ``tests/test_quant_loss.py:80``); measured 0 on every case here;
- the int8 Gram: forward rtol 1e-5, atol 1e-6 and dF rtol 1e-5, atol 1e-4 (JAX
  ``:208``, ``:233``); measured 0;
- the quantized extractor on shared codes: taps within 2e-2 of each tap's largest
  value of JAX's. Where real f32 convs come before the first int8 one, their sums
  run in other orders in the two frameworks and an input code of that int8 conv
  may land on the other side of a .5: one quantum, about 1/127 of the largest
  value (measured 0 to 7.2e-3 over 3 input seeds for "deep" and 6; 0 for "all",
  whose first int8 conv reads the exact conv1_1 output). Against the f32
  extractor, JAX's bar: relative norm < 0.06 (``:103``);
- trajectories against JAX's ``make_step_fns`` on the same parameters, data and
  permutations (the two ``train()``s draw their inits and permutations from
  their own RNGs): per-epoch losses within rtol 1e-2 (measured gaps in each
  test's docstring). An input code of an int8 layer lands on the other side of a
  .5 where its f32 value differs in the last bit between the frameworks (their
  real-dtype sums run in other orders); every later layer then rounds that
  neighbourhood otherwise, so the trajectories part by about the quantization's
  own noise, as JAX's own does when its input moves by one ulp;
- the port's own bar against its unquantized run: < 0.15 (``:133``).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from artist_style_transfer_tpu.ops import qconv as jqconv
from artist_style_transfer_tpu.ops.precision import precision as jprecision
from artist_style_transfer_tpu_torch import train_style_transfer
from artist_style_transfer_tpu_torch.models import vgg as tvgg
from artist_style_transfer_tpu_torch.models.resnet import ARTISTS_19, init_classifier
from artist_style_transfer_tpu_torch.models.resnet_q import quantize_classifier
from artist_style_transfer_tpu_torch.models.transformer import TransformerNet
from artist_style_transfer_tpu_torch.ops import gram as tgram
from artist_style_transfer_tpu_torch.ops import losses as tlosses
from artist_style_transfer_tpu_torch.ops import qconv as tqconv
from artist_style_transfer_tpu_torch.train import loop as tloop
from artist_style_transfer_tpu_torch.train import styles as tstyles
from artist_style_transfer_tpu_torch.train import train
from artist_style_transfer_tpu_torch.utils.jax_params import (
    quantized_classifier_from_jax,
    quantized_vgg16_from_jax,
    transformer_state_dict_from_jax,
    vgg16_state_dict_from_jax,
)
from tests.test_torch_classifier import numpy_params, rel_err
from tests.test_torch_data import one_torch_thread  # noqa: F401
from tests.test_torch_distributed import space_mesh

SIZE, N, P, B = 32, 8, 3, 4
LR, WD, CW, SW = 0.01, 1e-4, 17.0, 25.0
EPOCHS = 3
ARTIST = "Pablo_Picasso"


def nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32)).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


def oihw_codes(wq_hwio) -> torch.Tensor:
    return torch.from_numpy(np.array(wq_hwio, np.int8)).permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


# --- conv2d_frozen_int8: the STE data gradient ---------------------------------------

FROZEN = [  # (k, stride, padding, h, w): the VGG, the ResNet's 1x1 and 3x3, odd sizes
    (3, 1, 1, 10, 10), (1, 1, 0, 9, 9), (1, 2, 0, 8, 8), (1, 2, 0, 9, 7), (3, 2, 1, 10, 10),
    (3, 2, 1, 9, 11)]


@pytest.mark.parametrize("k,stride,padding,h,w", FROZEN,
                         ids=["k{}s{}p{}-{}x{}".format(*c) for c in FROZEN])
def test_frozen_int8_conv_and_its_dgrad_match_jax(k, stride, padding, h, w):
    """Forward and dx against JAX's custom VJP; the codes of x and of dy*sw and the
    int32 dgrad sum identical; no gradient for wq, sw or b (a frozen layer)."""
    rng = np.random.default_rng(10 * k + stride + h)
    x = rng.normal(size=(2, h, w, 32)).astype(np.float32) * 3
    wq, sw = jqconv.quant_weight(jnp.asarray(rng.normal(size=(k, k, 32, 64)) * 0.2,
                                             jnp.float32))
    b = rng.normal(size=(64,)).astype(np.float32)
    y, vjp = jax.vjp(lambda xx: jqconv.conv2d_frozen_int8(xx, wq, sw, jnp.asarray(b), padding,
                                                          stride), jnp.asarray(x))
    dy = rng.normal(size=y.shape).astype(np.float32)
    (dx,) = vjp(jnp.asarray(dy))

    xt = nchw(x).requires_grad_(True)
    swt = torch.from_numpy(np.array(sw)).requires_grad_(True)
    bt = torch.from_numpy(b).requires_grad_(True)
    wqt = oihw_codes(wq)
    yt = tqconv.conv2d_frozen_int8(xt, wqt, swt, bt, padding, stride)
    yt.backward(nchw(dy))
    np.testing.assert_allclose(nhwc(yt), np.asarray(y), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(nhwc(xt.grad), np.asarray(dx), rtol=1e-5, atol=1e-4)
    assert swt.grad is None and bt.grad is None and not wqt.requires_grad

    # The dgrad's codes and int32 sum, each side's own arithmetic on the shared dy.
    dyp = jnp.asarray(dy) * sw
    jcodes = jqconv.quant_i8(dyp, jqconv.absmax_scale(dyp))
    dypt = nchw(dy) * swt.detach().view(1, -1, 1, 1)
    tcodes = tqconv.quant_i8(dypt, tqconv.absmax_scale(dypt))
    np.testing.assert_array_equal(nhwc(tcodes), np.asarray(jcodes))
    w_t = jnp.transpose(wq[::-1, ::-1], (0, 1, 3, 2))
    pads = [tqconv._dgrad_pad(i, o, k, stride, 1, padding) for i, o in zip((h, w), y.shape[1:3])]
    jacc = jax.lax.conv_general_dilated(jcodes, w_t, (1, 1), pads, lhs_dilation=(stride, stride),
                                        dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                        preferred_element_type=jnp.int32)
    hi = max(p[1] for p in pads)
    tacc = tqconv.conv_i8(tcodes.contiguous(memory_format=torch.channels_last),
                          wqt.flip(2, 3).transpose(0, 1).contiguous(
                              memory_format=torch.channels_last),
                          1, (pads[0][0], hi), stride)[:, :, :h, :w]
    np.testing.assert_array_equal(nhwc(tacc), np.asarray(jacc))


def test_frozen_int8_conv_takes_bf16_and_returns_its_dtype():
    rng = np.random.default_rng(3)
    wq, sw = tqconv.quant_weight(torch.from_numpy(rng.normal(size=(64, 32, 3, 3)).astype(
        np.float32)))
    x = nchw(rng.normal(size=(1, 6, 6, 32))).to(torch.bfloat16).requires_grad_(True)
    y = tqconv.conv2d_frozen_int8(x, wq, sw, None, 1)
    y.float().square().sum().backward()
    assert y.dtype == x.grad.dtype == torch.bfloat16
    assert torch.isfinite(x.grad.float()).all() and x.grad.abs().max() > 0


DGRAD_GRID = sorted({(i, k, s, d, lo) for i in (7, 8, 9, 16, 17) for k in (1, 3) for s in (1, 2)
                     for d in (1, 2) for lo in (0, k // 2, k - 1) if s == 1 or d == 1})


@pytest.mark.parametrize("i,k,stride,lhs_d,lo", DGRAD_GRID,
                         ids=["i{}k{}s{}d{}lo{}".format(*c) for c in DGRAD_GRID])
def test_dgrad_pad_matches_jax(i, k, stride, lhs_d, lo):
    hi = lo + (lhs_d - 1 if lhs_d > 1 else 0)
    o = tqconv.conv_out_size(i, k, stride, lo, hi, lhs_d)
    assert tqconv._dgrad_pad(i, o, k, stride, lhs_d, lo) == jqconv._dgrad_pad(
        i, o, k, stride, lhs_d, lo)


# --- the int8 Gram ---------------------------------------------------------------------


@pytest.mark.parametrize("n,h,w,c", [(3, 4, 5, 16), (2, 5, 5, 256), (1, 3, 1, 512)])
def test_gram_int8_matches_jax(n, h, w, c):
    """Forward and dF against JAX ``gram_matrix_int8`` (the plain version: the codes in
    f64, exact), with the rows zero-padded as the ``_int_mm`` route pads them."""
    from artist_style_transfer_tpu.ops.gram import gram_matrix_int8 as jgram_int8

    rng = np.random.default_rng(c + h)
    f = (rng.normal(size=(n, h, w, c)) * 7).astype(np.float32)
    g, vjp = jax.vjp(jgram_int8, jnp.asarray(f))
    dg = rng.normal(size=g.shape).astype(np.float32)
    (df,) = vjp(jnp.asarray(dg))
    ft = torch.from_numpy(f).requires_grad_(True)
    calls = tgram.INT_MM_CALLS
    gt = tgram.gram_matrix_int8(ft)
    gt.backward(torch.from_numpy(dg))
    assert tgram.INT_MM_CALLS == calls  # the CPU runs the plain version
    assert gt.dtype == torch.float32 and ft.grad.dtype == torch.float32
    np.testing.assert_allclose(gt.detach().numpy(), np.asarray(g), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ft.grad.numpy(), np.asarray(df), rtol=1e-5, atol=1e-4)


def test_int8_products_pads_past_int_mm_limits_and_is_exact():
    """Rows padded to a multiple of 8 and above 16; the f64 plain version equals the
    int64 product exactly at sums past 2^24."""
    assert [tgram._int_mm_rows(hw) for hw in (1, 16, 17, 25, 2500, 3136)] == \
        [24, 24, 24, 32, 2504, 3136]
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.integers(-127, 128, (2, 40, 3136), dtype=np.int8))
    b = torch.from_numpy(rng.integers(-127, 128, (2, 24, 3136), dtype=np.int8))
    want = torch.bmm(a.long(), b.long().transpose(1, 2))
    got = tgram.int8_products(a, b)
    assert got.dtype == torch.int32 and torch.equal(got.long(), want)


def test_style_loss_gram_quantize_gate_matches_jax():
    """``quantize`` sends only relu3_3 and relu4_3 (C >= 256) to the int8 Gram, as JAX's
    gate does; the loss is JAX's and within rounding of the exact one."""
    from artist_style_transfer_tpu.ops.losses import style_loss_gram as jstyle_loss

    rng = np.random.default_rng(8)
    sizes = {"relu1_2": (16, 64), "relu2_2": (8, 128), "relu3_3": (4, 256), "relu4_3": (2, 512)}
    feats = {k: rng.normal(size=(2, s, s, c)).astype(np.float32) for k, (s, c) in sizes.items()}
    targets = {k: (rng.normal(size=(c, c)) * 1e-3).astype(np.float32)
               for k, (_, c) in sizes.items()}
    tf = {k: torch.from_numpy(v) for k, v in feats.items()}
    tt = {k: torch.from_numpy(v) for k, v in targets.items()}
    with jprecision("highest"):
        ref = float(jstyle_loss({k: jnp.asarray(v) for k, v in feats.items()},
                                {k: jnp.asarray(v) for k, v in targets.items()},
                                use_pallas=False, quantize=True))
    exact = float(tlosses.style_loss_gram(tf, tt))
    quant = float(tlosses.style_loss_gram(tf, tt, quantize=True))
    np.testing.assert_allclose(quant, ref, rtol=1e-5)
    assert quant != exact and abs(quant - exact) / exact < 2e-2
    # Only the deep taps changed: the shallow taps' terms are the exact Gram's.
    mixed = sum(float(tlosses.mse(tgram.gram_matrix_int8(tf[k]) if c >= 256
                                  else tgram.gram_matrix(tf[k]), tt[k]))
                for k, (_, c) in sizes.items())
    np.testing.assert_allclose(quant, mixed, rtol=1e-6)


# --- the quantized VGG16 loss extractor ----------------------------------------------


def jax_vgg(seed: int = 1) -> list:
    from artist_style_transfer_tpu.models.vgg import init_vgg16_params

    return numpy_params(init_vgg16_params, seed)


@pytest.mark.parametrize("layers", ["deep", "all", 6])
def test_quantize_vgg16_loss_matches_jax(layers):
    """Codes and scales identical to JAX's, the taps within 2e-2 of JAX's on the same
    codes and within JAX's 0.06 of the f32 extractor; gradients finite."""
    from artist_style_transfer_tpu.models.vgg import quantize_vgg16_loss as jquantize
    from artist_style_transfer_tpu.models.vgg import vgg16_features

    params = jax_vgg()
    vgg = tvgg.VGG16Features()
    vgg.load_state_dict(vgg16_state_dict_from_jax(params))
    qj = jquantize(jax.tree.map(jnp.asarray, params), layers=layers, dtype=jnp.float32)
    qt = tvgg.quantize_vgg16_loss(vgg, layers, dtype=torch.float32)
    first_q = {"deep": 4, "all": 1}.get(layers, layers)
    assert qt.first_q == first_q and tvgg.vgg_is_quantized(qt)
    assert not tvgg.vgg_is_quantized(vgg) and not list(qt.parameters())
    for i, p in enumerate(qj):
        if i < first_q:
            assert "wq" not in p
            continue
        np.testing.assert_array_equal(getattr(qt, f"wq{i}").numpy(),
                                      np.transpose(np.asarray(p["wq"]), (3, 2, 0, 1)))
        np.testing.assert_array_equal(getattr(qt, f"sw{i}").numpy(), np.asarray(p["sw"]))
    # The converter gives the same module from JAX's list.
    qc = quantized_vgg16_from_jax(jax.tree.map(np.asarray, qj))
    for k, v in qt.state_dict().items():
        assert torch.equal(qc.state_dict()[k], v), k

    x = (np.random.default_rng(2).normal(size=(2, 32, 32, 3)) * 40).astype(np.float32)
    with jprecision("highest"):
        ref = vgg16_features(qj, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = qt(xt)
    real = vgg(torch.from_numpy(x))
    for k in tvgg.VGG_LAYER_NAMES:
        assert got[k].is_contiguous()  # an NHWC view, as VGG16Features gives
        assert rel_err(got[k].detach().numpy(), np.asarray(ref[k])) < 2e-2, k
        rel = float(torch.linalg.norm(got[k].detach() - real[k]) / torch.linalg.norm(real[k]))
        assert rel < 0.06, (k, rel)
    sum(v.square().sum() for v in got.values()).backward()
    assert torch.isfinite(xt.grad).all() and xt.grad.abs().max() > 0
    assert torch.equal(qt(torch.from_numpy(x), just_content=True), got["relu2_2"].detach())


def test_quantized_vgg_keeps_its_real_dtype_and_refuses_a_quantized_input():
    vgg = tvgg.init_vgg16(torch.Generator().manual_seed(0))
    q = tvgg.quantize_vgg16_loss(vgg, "deep", dtype=torch.bfloat16)
    assert q.w0.dtype == q.b0.dtype == torch.bfloat16 and q.b4.dtype == q.sw4.dtype == torch.float32
    out = q(torch.zeros(1, 16, 16, 3))  # f32 in, the real dtype inside and out
    assert all(v.dtype == torch.bfloat16 for v in out.values())
    with pytest.raises(TypeError, match="VGG16Features"):
        tvgg.quantize_vgg16_loss(q)
    with pytest.raises(ValueError, match="layers"):
        tvgg.quantize_vgg16_loss(vgg, "shallow")


# --- training through the int8 loss nets, against JAX ---------------------------------


def corpus(seed: int = 3) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    return ((rng.random((N, SIZE, SIZE, 3)) * 255).astype(np.float32),
            (rng.random((P, SIZE, SIZE, 3)) * 255).astype(np.float32))


def jax_trajectory(mode: str, quantize_loss=False, qat=False, epochs: int = EPOCHS):
    """Per-epoch [content, style, total] sums of JAX ``make_step_fns`` at f32, precision
    'highest', and what the port needs to run the same: params, nets, data, perms."""
    from artist_style_transfer_tpu.models import resnet_q as jresnet_q
    from artist_style_transfer_tpu.models.resnet import init_classifier_params
    from artist_style_transfer_tpu.models.transformer import init_transformer_params
    from artist_style_transfer_tpu.models.vgg import quantize_vgg16_loss as jquantize
    from artist_style_transfer_tpu.train.loop import (
        epoch_permutation,
        make_optimizer,
        make_step_fns,
        precompute_content_relu2_2,
    )
    from artist_style_transfer_tpu.train.styles import build_style_targets

    content, paintings = corpus()
    params0 = numpy_params(init_transformer_params, 0)
    vgg0 = jax_vgg()
    vgg = jax.tree.map(jnp.asarray, vgg0)
    if quantize_loss:
        vgg = jquantize(vgg, "deep" if quantize_loss is True else quantize_loss,
                        dtype=jnp.float32)
    clf = None
    if mode == "classifier":
        clf = jresnet_q.quantize_classifier(
            jax.tree.map(jnp.asarray, numpy_params(init_classifier_params, 2)))
    steps = N // B
    perms = [np.asarray(epoch_permutation(0, e, N)) for e in range(epochs)]
    with jprecision("highest"):
        targets = build_style_targets(mode, vgg, ARTIST, paintings=paintings, batch_size=B,
                                      artist_index=ARTISTS_19.index(ARTIST))
        tx = make_optimizer(LR, WD, epochs, 2, steps)
        fns = make_step_fns(mode, vgg, clf, targets, content_weight=CW, style_weight=SW,
                            batch_size=B, num_content=N, tx=tx, use_pallas=False, qat=qat)
        data = jnp.asarray(content)
        r22 = precompute_content_relu2_2(vgg, data)
        params = jax.tree.map(jnp.asarray, params0)
        state = tx.init(params)
        losses = []
        for e in range(epochs):
            params, state, el = fns.epoch_fn(params, state, data, r22, targets.grams,
                                             targets.labels, jnp.asarray(perms[e]),
                                             jnp.int32(e * steps))
            losses.append(np.asarray(el, np.float64).sum(axis=0))
    return {"losses": np.stack(losses), "params0": params0, "vgg0": vgg0,
            "vgg": jax.tree.map(np.asarray, vgg), "content": content, "paintings": paintings,
            "perms": perms, "mode": mode, "qat": qat,
            "clf": None if clf is None else jax.tree.map(np.asarray, clf)}


def port_trajectory(ref: dict, epochs: int = EPOCHS) -> np.ndarray:
    """The port's per-epoch sums on ``ref``'s parameters, nets, data and permutations."""
    model = TransformerNet()
    model.load_state_dict(transformer_state_dict_from_jax(ref["params0"]))
    if any("wq" in p for p in ref["vgg"]):
        vgg = quantized_vgg16_from_jax(ref["vgg"])
    else:
        vgg = tvgg.VGG16Features()
        vgg.load_state_dict(vgg16_state_dict_from_jax(ref["vgg0"]))
    clf = None if ref["clf"] is None else quantized_classifier_from_jax(ref["clf"])
    targets = tstyles.build_style_targets(ref["mode"], vgg, ARTIST, paintings=ref["paintings"],
                                          batch_size=B, artist_index=ARTISTS_19.index(ARTIST))
    steps = N // B
    opt, sched = tloop.make_optimizer(model.parameters(), LR, WD, epochs, 2, steps)
    fns = tloop.make_step_fns(ref["mode"], model, vgg, targets, opt, sched, content_weight=CW,
                              style_weight=SW, batch_size=B, num_content=N, classifier=clf,
                              qat=ref["qat"])
    data = torch.from_numpy(ref["content"])
    r22 = tloop.precompute_content_relu2_2(vgg, data)
    return np.stack([fns.epoch_fn(data, r22, ref["perms"][e], e * steps).numpy()
                     .astype(np.float64).sum(axis=0) for e in range(epochs)])


@pytest.fixture(scope="module")
def quantize_loss_runs():
    ref = jax_trajectory("cycle", quantize_loss=True)
    return ref, port_trajectory(ref)


def test_quantize_loss_trajectory_matches_jax(quantize_loss_runs):
    """'cycle' through the int8 VGG (conv3_1..conv4_3) and the int8 Gram (relu3_3,
    relu4_3): per-epoch losses within rtol 1e-2 of JAX's. Measured over 3 epochs:
    content 8.4e-4, style 2.0e-3, total 5.0e-4 at most; JAX's own trajectory moves
    by 2.9e-3 when the content images move by one f32 ulp."""
    ref, got = quantize_loss_runs
    assert got.shape == ref["losses"].shape == (EPOCHS, 3)
    assert np.isfinite(got).all() and got[-1, 2] < got[0, 2]
    np.testing.assert_allclose(got, ref["losses"], rtol=1e-2)


@pytest.fixture(scope="module")
def classifier_runs():
    ref = jax_trajectory("classifier")
    return ref, port_trajectory(ref)


def test_int8_classifier_trajectory_matches_jax(classifier_runs):
    """'classifier' through the quantized ResNet-50 (JAX ``quantize_classifier`` codes in
    both): its 52 int8 convs' STE data gradients reach the TransformerNet. Per-epoch
    losses within rtol 1e-2 of JAX's. Measured: content 9.5e-4, style 1.1e-4, total
    4.0e-4 at most; JAX's own trajectory moves by 4.9e-4 when the content images
    move by one f32 ulp."""
    ref, got = classifier_runs
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref["losses"], rtol=1e-2)


# --- train() and the CLI with the int8 options ----------------------------------------


@pytest.fixture(scope="module")
def hooks():
    content, paintings = corpus()
    return dict(content_images=content, paintings=paintings, batch_size=B, num_epochs=EPOCHS,
                lr=LR, seed=3, model_dir=None, device="cpu", wordy=False,
                vgg=tvgg.init_vgg16(torch.Generator().manual_seed(0)))


@pytest.fixture(scope="module")
def plain_losses(hooks):
    return train("cycle", "A", **hooks)[1]


def test_train_quantize_loss_tracks_the_unquantized_run(hooks, plain_losses):
    """``train(quantize_loss=True)``: finite, falling, and within JAX's 0.15 of the
    unquantized trajectory (measured 3.0e-4); the caller's VGG is left as it was."""
    before = {k: v.clone() for k, v in hooks["vgg"].state_dict().items()}
    _, losses = train("cycle", "A", **hooks, quantize_loss=True)
    assert np.isfinite(losses).all() and losses[-1, 2] < losses[0, 2]
    rel = np.abs(losses[:, 2] - plain_losses[:, 2]) / plain_losses[:, 2]
    assert rel.max() < 0.15, rel
    for k, v in hooks["vgg"].state_dict().items():
        assert torch.equal(v, before[k])


@pytest.mark.parametrize("opts,first_q,grams", [
    (dict(quantize_loss="all"), 1, 2), (dict(quantize_loss=5), 5, 2),
    (dict(quantize_gram=True), 10, 2), (dict(quantize_loss="deep", quantize_gram=False), 4, 0)],
    ids=["all", "int5", "gram-only", "deep-no-gram"])
def test_train_accepts_every_quantize_option(hooks, monkeypatch, opts, first_q, grams):
    """Each option runs one epoch of one step with finite losses near the unquantized
    run's, through the int8 convs from ``first_q`` on and the int8 Grams it asks for:
    each int8 conv once for the targets (one chunk of paintings), forward and dgrad
    in the step, and, where it lies before relu2_2, once for the content features."""
    counts = {"conv": 0, "gram": 0}
    conv_i8, gram_int8 = tqconv.conv_i8, tlosses.gram_matrix_int8

    def counting(real, key):
        def run(*args, **kwargs):
            counts[key] += 1
            return real(*args, **kwargs)
        return run

    kw = dict(hooks, num_epochs=1, content_images=hooks["content_images"][:B])
    _, plain = train("cycle", "A", **kw)
    monkeypatch.setattr(tqconv, "conv_i8", counting(conv_i8, "conv"))
    monkeypatch.setattr(tlosses, "gram_matrix_int8", counting(gram_int8, "gram"))
    _, losses = train("cycle", "A", **kw, **opts)
    assert np.isfinite(losses).all()
    rel = abs(losses[0, 2] - plain[0, 2]) / plain[0, 2]
    assert rel < 0.15, rel
    n_q = 10 - first_q
    assert counts == {"conv": 3 * n_q + max(0, 4 - first_q), "gram": grams}


def test_quantize_gram_follows_the_extractor(hooks, monkeypatch):
    """``"auto"`` turns the int8 Gram on with a quantized VGG and off without one."""
    calls = []
    real = tlosses.gram_matrix_int8
    monkeypatch.setattr(tlosses, "gram_matrix_int8",
                        lambda f, mesh=None: calls.append(f.shape) or real(f, mesh))
    kw = dict(hooks, num_epochs=1, content_images=hooks["content_images"][:B])
    train("cycle", "A", **kw)
    assert not calls
    train("cycle", "A", **kw, quantize_loss=True)
    assert [c[-1] for c in calls] == [256, 512]  # one step: relu3_3 and relu4_3
    calls.clear()
    train("cycle", "A", **kw, quantize_loss=True, quantize_gram=False)
    assert not calls


def test_train_classifier_through_the_quantized_classifier(hooks, tmp_path):
    """'classifier' training takes a ``quantize_classifier`` module (buffers only): the
    losses are finite, the classifier's buffers unchanged, and no buffer has a grad."""
    clf = quantize_classifier(init_classifier(torch.Generator().manual_seed(0)))
    before = {k: v.clone() for k, v in clf.state_dict().items()}
    model, losses = train("classifier", ARTIST, **dict(hooks, num_epochs=2, model_dir=str(
        tmp_path)), classifier=clf)
    assert np.isfinite(losses).all() and losses.shape == (2, 3)
    for k, v in clf.state_dict().items():
        assert torch.equal(v, before[k]) and v.grad is None, k
    assert os.path.exists(tmp_path / ARTIST / "classifier" / "transfer_17-25_2.pth")
    _, bf16 = train("classifier", ARTIST, **dict(hooks, num_epochs=1), classifier=clf,
                    compute_dtype="bfloat16")
    assert np.isfinite(bf16).all()
    for k, v in clf.state_dict().items():  # not cast to the compute dtype
        assert v.dtype == before[k].dtype, k


def test_make_step_fns_leaves_quantized_nets_uncast(hooks):
    """bf16 compute casts a real VGG's copy, never a quantized one's f32 scales."""
    q = tvgg.quantize_vgg16_loss(hooks["vgg"], dtype=torch.bfloat16)
    targets = tstyles.build_style_targets("cycle", q, "A", paintings=hooks["paintings"])
    model = TransformerNet()
    opt, sched = tloop.make_optimizer(model.parameters(), LR, WD, 1, 2, 2)
    fns = tloop.make_step_fns("cycle", model, q, targets, opt, sched, content_weight=CW,
                              style_weight=SW, batch_size=B, num_content=N,
                              compute_dtype="bfloat16")
    data = torch.from_numpy(hooks["content_images"])
    r22 = tloop.precompute_content_relu2_2(q, data, dtype=torch.bfloat16)
    assert torch.isfinite(fns.step_fn(data[:B], r22[:B], 0)).all()
    assert q.sw4.dtype == q.b9.dtype == torch.float32 and q.w0.dtype == torch.bfloat16
    for bad, match in ((dict(qat="some"), "qat"), (dict(quantize_gram="on"), "quantize_gram")):
        with pytest.raises(ValueError, match=match):
            tloop.make_step_fns("cycle", model, q, targets, opt, sched, content_weight=CW,
                                style_weight=SW, batch_size=B, num_content=N, **bad)


# --- the refusals that stay ------------------------------------------------------------

REFUSED = [
    (dict(qat=True, fold_batch=True), NotImplementedError, "batch->H folded"),
    (dict(quantize_loss="all", fold_batch=True), NotImplementedError, "use quantize_loss='deep'"),
    (dict(quantize_loss="all", fold_batch="vgg"), NotImplementedError, "use quantize_loss='deep'"),
    (dict(quantize_loss=2, fold_batch=True), NotImplementedError, "use quantize_loss='deep'"),
    (dict(mesh=space_mesh()), NotImplementedError, "item 12b"),
    (dict(qat="half"), ValueError, "qat must be"),
    (dict(quantize_gram="on"), ValueError, "quantize_gram must be"),
]


@pytest.mark.parametrize("kw,exc,match", REFUSED,
                         ids=["-".join(f"{k}={v!r}"[:16] for k, v in kw.items())
                              for kw, _, _ in REFUSED])
def test_train_refuses_before_writing(hooks, tmp_path, kw, exc, match):
    with pytest.raises(exc, match=match):
        train("cycle", "A", **dict(hooks, model_dir=str(tmp_path)), **kw)
    assert not os.listdir(tmp_path)


def test_fold_batch_with_deep_quantization_or_vgg_fold_qat_runs(hooks):
    """What JAX lets through runs: 'deep' with either fold, QAT with the VGG fold."""
    kw = dict(hooks, num_epochs=1, content_images=hooks["content_images"][:B])
    for opts in (dict(quantize_loss=True, fold_batch=True), dict(qat=True, fold_batch="vgg")):
        assert np.isfinite(train("cycle", "A", **kw, **opts)[1]).all()


def test_cli_int8_flags_reach_train(monkeypatch):
    seen = {}
    monkeypatch.setattr("artist_style_transfer_tpu_torch.train.train",
                        lambda **kw: seen.update(kw))
    train_style_transfer.main(["--quantize_loss", "--qat", "all", "--quantize_gram", "off",
                               "--device", "cpu"])
    assert (seen["quantize_loss"], seen["qat"], seen["quantize_gram"]) == ("deep", "all", False)
    train_style_transfer.main(["--quantize_loss", "all", "--qat", "--device", "cpu"])
    assert (seen["quantize_loss"], seen["qat"], seen["quantize_gram"]) == ("all", "trunk", "auto")
