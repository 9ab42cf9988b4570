"""The serving path of the PyTorch port (``infer/serve.py``: ``StylizeServer``, the
micro-batcher, and ``ModelRegistry``) on the CPU: each behaviour ``tests/test_serve.py``
checks of the JAX package, and the served outputs against JAX's server.

Weights: a full-width TransformerNet drawn with numpy (``numpy_params``), carried to the
port by ``transformer_state_dict_from_jax``; images are seeded uint8. Tolerances:

- f32 serving: each image > 45 dB PSNR against JAX's server (ROADMAP's TransformerNet
  bar); against the port's own direct ``stylize`` on the same batch, equal;
- the int8 registry: its activation scales within 1e-5 relative of JAX's registry's
  (f32 absmaxes of two forwards that sum in other orders), its outputs > 55 dB against
  JAX's int8 server and > 45 dB against the port's f32 (``tests/test_torch_int8.py``'s
  bars).
"""

import os
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from artist_style_transfer_tpu.infer import serve as jserve
from artist_style_transfer_tpu.models.transformer import init_transformer_params
from artist_style_transfer_tpu_torch.infer.serve import ModelRegistry, StylizeServer, _is_quantized
from artist_style_transfer_tpu_torch.infer.stylize import stylize, stylize_int8
from artist_style_transfer_tpu_torch.models.transformer import TransformerNet, init_transformer
from artist_style_transfer_tpu_torch.models.transformer_q import quantize_transformer
from artist_style_transfer_tpu_torch.train.checkpoint import export_pth, save_params_npz
from artist_style_transfer_tpu_torch.utils.jax_params import (
    quantized_transformer_from_jax,
    transformer_state_dict_from_jax,
)
from tests.test_torch_classifier import numpy_params
from tests.test_torch_data import one_torch_thread  # noqa: F401
from tests.test_torch_int8 import psnr

CPU = {"device": "cpu"}


def net(seed: int) -> TransformerNet:
    return init_transformer(torch.Generator().manual_seed(seed)).eval()


@pytest.fixture(scope="module")
def model():
    return net(0)


def img(rng, h, w):
    return (rng.random((h, w, 3)) * 255).astype(np.uint8)


def direct(model, images) -> np.ndarray:
    return stylize(model, np.stack(images), device="cpu").numpy()


def serve_all(srv, images, **kw) -> list[np.ndarray]:
    futs = [srv.submit(im, **kw) for im in images]
    return [f.result(timeout=240) for f in futs]


# --- against JAX's server --------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_pair():
    params = numpy_params(init_transformer_params, 3)
    port = TransformerNet()
    port.load_state_dict(transformer_state_dict_from_jax(params))
    rng = np.random.default_rng(0)
    images = [img(rng, 64, 64) for _ in range(3)] + [img(rng, 48, 80) for _ in range(2)]
    return jax.tree.map(jnp.asarray, params), port.eval(), images


def test_server_matches_jax_server(jax_pair):
    jparams, port, images = jax_pair
    jsrv = jserve.StylizeServer(jparams, max_batch=4, max_wait_ms=20.0)
    srv = StylizeServer(port, max_batch=4, max_wait_ms=20.0, **CPU)
    try:
        want = serve_all(jsrv, images)
        got = serve_all(srv, images)
    finally:
        jsrv.close()
        srv.close()
    for g, w, im in zip(got, want, images):
        assert g.dtype == np.uint8 and g.shape == im.shape
        assert psnr(g, w) > 45.0
    assert srv.stats == {"batches": 2, "images": 5}  # (64, 64) x 3, (48, 80) x 2


def test_quantized_registry_matches_jax_registry(jax_pair):
    jparams, port, images = jax_pair
    jreg = jserve.ModelRegistry(quantize=True)
    jreg.register("a", params=jparams)
    reg = ModelRegistry(quantize=True, **CPU)
    reg.register("a", params=port)
    qmodel = reg.get("a")
    assert _is_quantized(qmodel) and not _is_quantized(port)
    # The default calibration is JAX's: its scales up to the forwards' f32 rounding.
    from_jax = quantized_transformer_from_jax(jax.tree.map(np.asarray, jreg.get("a")))
    scales = {k: v for k, v in qmodel.state_dict().items() if k.endswith("sin")}
    assert len(scales) == 16
    for k, v in scales.items():
        torch.testing.assert_close(v, from_jax.state_dict()[k], rtol=1e-5, atol=0)
    jsrv = jserve.StylizeServer(registry=jreg, max_batch=4, max_wait_ms=20.0)
    srv = StylizeServer(registry=reg, max_batch=4, max_wait_ms=20.0, **CPU)
    try:
        want = serve_all(jsrv, images, model="a")
        got = serve_all(srv, images, model="a")
    finally:
        jsrv.close()
        srv.close()
    real = [direct(port, [im])[0] for im in images]
    for g, w, r in zip(got, want, real):
        assert g.dtype == np.uint8
        assert psnr(g, w) > 55.0 and psnr(g, r) > 45.0


# --- the micro-batcher ------------------------------------------------------------------


def test_server_matches_direct_stylize(model):
    rng = np.random.default_rng(0)
    imgs = [img(rng, 32, 32) for _ in range(5)]
    srv = StylizeServer(model, max_batch=4, max_wait_ms=20.0, **CPU)
    try:
        outs = serve_all(srv, imgs)
    finally:
        srv.close()
    want = direct(model, imgs)
    for got, w in zip(outs, want):
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, w)


def test_server_batches_concurrent_requests(model):
    rng = np.random.default_rng(1)
    srv = StylizeServer(model, max_batch=8, max_wait_ms=250.0, **CPU)
    try:
        srv.submit(img(rng, 16, 16)).result(timeout=120)
        n0 = srv.stats["batches"]
        serve_all(srv, [img(rng, 16, 16) for _ in range(8)])
        # 8 requests of one shape queued together coalesce into one batch
        assert srv.stats["batches"] == n0 + 1
    finally:
        srv.close()


def test_custom_apply_fn_coalesces():
    """``apply_fn`` replaces the model call (what ``/v1/classify`` rides): it gets the
    batch as a uint8 tensor on the server's device, outputs route per image, and
    same-shape traffic coalesces as on the stylize path."""
    calls = []

    def apply_fn(p, images):
        assert isinstance(images, torch.Tensor) and images.dtype == torch.uint8
        calls.append(images.shape[0])
        return images.float().sum(dim=(1, 2, 3)).numpy()

    srv = StylizeServer(params=object(), max_batch=8, max_wait_ms=250.0, apply_fn=apply_fn,
                        **CPU)
    try:
        rng = np.random.default_rng(7)
        imgs = [img(rng, 16, 16) for _ in range(9)]
        first = srv.submit(imgs[0]).result(timeout=60)
        np.testing.assert_allclose(first, imgs[0].astype(np.float32).sum(), rtol=1e-6)
        for im, out in zip(imgs[1:], serve_all(srv, imgs[1:])):
            np.testing.assert_allclose(out, im.astype(np.float32).sum(), rtol=1e-6)
        assert calls[0] == 1 and sum(calls) == 9
        assert len(calls) == 2  # the 8 queued inside the window coalesced
    finally:
        srv.close()


def test_server_mixed_shapes(model):
    rng = np.random.default_rng(2)
    srv = StylizeServer(model, max_batch=4, max_wait_ms=10.0, **CPU)
    try:
        a = [srv.submit(img(rng, 16, 16)) for _ in range(3)]
        b = [srv.submit(img(rng, 24, 16)) for _ in range(3)]
        outs_a = [f.result(timeout=240) for f in a]
        outs_b = [f.result(timeout=240) for f in b]
    finally:
        srv.close()
    assert all(o.shape == (16, 16, 3) for o in outs_a)
    assert all(o.shape == (24, 16, 3) for o in outs_b)


def test_server_submit_after_close_raises(model):
    srv = StylizeServer(model, **CPU)
    srv.close()
    with pytest.raises(RuntimeError, match="closed"):
        srv.submit(np.zeros((16, 16, 3), np.uint8))


def test_server_rejects_bad_shape(model):
    srv = StylizeServer(model, **CPU)
    try:
        with pytest.raises(ValueError, match="HWC"):
            srv.submit(np.zeros((16, 16), np.uint8))
    finally:
        srv.close()


def test_server_threaded_submitters(model):
    srv = StylizeServer(model, max_batch=4, max_wait_ms=5.0, **CPU)
    results = []
    lock = threading.Lock()

    def client(seed):
        out = srv.submit(img(np.random.default_rng(seed), 16, 16)).result(timeout=240)
        with lock:
            results.append(out)

    try:
        threads = [threading.Thread(target=client, args=(s,)) for s in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=240)
        assert not any(t.is_alive() for t in threads)
    finally:
        srv.close()
    assert len(results) == 6 and all(o.shape == (16, 16, 3) for o in results)


def test_cancelled_future_does_not_kill_worker(model):
    """A caller cancelling its queued future must not wedge the batcher."""
    rng = np.random.default_rng(9)
    srv = StylizeServer(model, max_batch=4, max_wait_ms=50.0, **CPU)
    try:
        srv.submit(img(rng, 16, 16)).result(timeout=240)
        fut = srv.submit(img(rng, 16, 16))
        assert fut.cancel()  # still queued: cancellable
        out = srv.submit(img(rng, 16, 16)).result(timeout=240)
        assert out.shape == (16, 16, 3) and fut.cancelled()
    finally:
        srv.close()


def test_server_apply_failure_fails_its_requests_only(model):
    """A device or model failure resolves that batch's futures with the exception; the
    worker keeps serving."""
    def apply_fn(p, images):
        if images.shape[1] == 8:
            raise RuntimeError("boom")
        return images.numpy()

    srv = StylizeServer(params=object(), max_batch=4, max_wait_ms=1.0, apply_fn=apply_fn, **CPU)
    try:
        with pytest.raises(RuntimeError, match="boom"):
            srv.submit(np.zeros((8, 8, 3), np.uint8)).result(timeout=60)
        ok = srv.submit(np.full((4, 4, 3), 7, np.uint8)).result(timeout=60)
        assert (ok == 7).all() and srv.stats == {"batches": 1, "images": 1}
    finally:
        srv.close()


def test_server_ctor_validation(model):
    with pytest.raises(ValueError, match="exactly one"):
        StylizeServer(**CPU)  # neither params nor registry
    with pytest.raises(ValueError, match="exactly one"):
        StylizeServer(model, registry=ModelRegistry(**CPU), **CPU)  # both
    srv = StylizeServer(model, **CPU)
    try:
        with pytest.raises(ValueError, match="single-tenant"):
            srv.submit(np.zeros((8, 8, 3), np.uint8), model="a")
    finally:
        srv.close()
    if not torch.cuda.is_available():  # CUDA by default, and no silent CPU fallback
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            StylizeServer(model)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ModelRegistry()


# --- the registry ------------------------------------------------------------------------


def bump_mtime(path) -> None:
    st = os.stat(path)
    os.utime(path, (st.st_atime, st.st_mtime + 2))


def first_weight(m) -> torch.Tensor:
    return m.state_dict()["ConvBlock.0.conv_layer.weight"]


def test_registry_register_get_reload(tmp_path, model):
    reg = ModelRegistry(**CPU)
    reg.register("a", params=model)
    assert "a" in reg and reg.names() == ["a"]
    assert reg.get("a") is model

    path = str(tmp_path / "m.npz")
    save_params_npz(path, net(1))
    reg.register("b", path=path)
    torch.testing.assert_close(first_weight(reg.get("b")), first_weight(net(1)), rtol=0, atol=0)
    assert reg.reload("b") is False  # unchanged file: no swap
    save_params_npz(path, net(2))
    bump_mtime(path)
    assert reg.reload("b") is True
    torch.testing.assert_close(first_weight(reg.get("b")), first_weight(net(2)), rtol=0, atol=0)
    reg.unregister("b")
    with pytest.raises(KeyError):
        reg.get("b")
    with pytest.raises(ValueError, match="exactly one"):
        reg.register("c")


def test_registry_pth_roundtrip(tmp_path, model):
    """The registry reads the reference .pth layout (train_cnn.py:383-390)."""
    path = str(tmp_path / "transfer_17-25_2.pth")
    export_pth(path, model)
    reg = ModelRegistry(**CPU)
    reg.register("renoir/random", path=path)
    torch.testing.assert_close(first_weight(reg.get("renoir/random")), first_weight(model),
                               rtol=1e-6, atol=0)


def test_multitenant_server_routes_and_hot_reloads(tmp_path, model):
    rng = np.random.default_rng(3)
    im = img(rng, 16, 16)
    path = str(tmp_path / "b.npz")
    save_params_npz(path, net(7))
    reg = ModelRegistry(auto_reload=True, **CPU)
    reg.register("a", params=model)
    reg.register("b", path=path)
    srv = StylizeServer(registry=reg, max_batch=4, max_wait_ms=10.0, **CPU)
    try:
        np.testing.assert_array_equal(srv.submit(im, model="a").result(timeout=240),
                                      direct(model, [im])[0])
        np.testing.assert_array_equal(srv.submit(im, model="b").result(timeout=240),
                                      direct(net(7), [im])[0])
        # Swap model b's weights on disk; auto_reload takes them up.
        save_params_npz(path, net(8))
        bump_mtime(path)
        np.testing.assert_array_equal(srv.submit(im, model="b").result(timeout=240),
                                      direct(net(8), [im])[0])
        with pytest.raises(KeyError):
            srv.submit(im, model="missing")
        with pytest.raises(ValueError, match="model="):
            srv.submit(im)  # model= required multi-tenant
    finally:
        srv.close()


def test_registry_reload_keeps_weights_on_transient_error(tmp_path):
    """A half-written or missing checkpoint must not take down live serving."""
    path = str(tmp_path / "m.npz")
    save_params_npz(path, net(11))
    reg = ModelRegistry(auto_reload=True, **CPU)
    reg.register("a", path=path)
    os.remove(path)  # the gap in a non-atomic rewrite
    torch.testing.assert_close(first_weight(reg.get("a")), first_weight(net(11)), rtol=0, atol=0)
    with open(path, "wb") as f:
        f.write(b"not a real npz")  # a half-written file
    assert reg.reload("a", force=True) is False
    torch.testing.assert_close(first_weight(reg.get("a")), first_weight(net(11)), rtol=0, atol=0)
    save_params_npz(path, net(12))  # a valid rewrite is taken up again
    assert reg.reload("a", force=True) is True
    torch.testing.assert_close(first_weight(reg.get("a")), first_weight(net(12)), rtol=0, atol=0)


def test_quantized_registry_serving(model):
    """quantize=True registries serve through the int8 path (stylize_int8)."""
    reg = ModelRegistry(quantize=True, **CPU)
    reg.register("a", params=model)
    qmodel = reg.get("a")
    assert _is_quantized(qmodel) and not _is_quantized(model)
    rng = np.random.default_rng(3)
    imgs = [img(rng, 32, 32) for _ in range(3)]
    srv = StylizeServer(registry=reg, max_batch=4, max_wait_ms=20.0, **CPU)
    try:
        outs = serve_all(srv, imgs, model="a")
    finally:
        srv.close()
    want = stylize_int8(qmodel, np.stack(imgs), device="cpu").numpy()
    for got, w in zip(outs, want):
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, w)


def test_quantized_single_tenant_server(model):
    """A pre-quantized model serves directly in a single-tenant server."""
    qmodel = quantize_transformer(model, np.random.default_rng(1).random((2, 64, 64, 3)) * 255)
    im = img(np.random.default_rng(4), 32, 32)
    srv = StylizeServer(qmodel, max_batch=2, max_wait_ms=5.0, **CPU)
    try:
        out = srv.submit(im).result(timeout=120)
    finally:
        srv.close()
    assert out.shape == im.shape and out.dtype == np.uint8
    np.testing.assert_array_equal(out, stylize_int8(qmodel, im[None], device="cpu")[0].numpy())
