"""The HTTP front end of the PyTorch port (``infer/http_server.py``) over a live socket on
the CPU: each behaviour ``tests/test_http_server.py`` checks of the JAX package.

ThreadingHTTPServer -> StylizeServer -> ``stylize``, with seeded full-width
TransformerNets. PNG is lossless both ways, so a served image equals the port's direct
``stylize`` of the same image bit for bit. ``/v1/classify`` runs once for real on the
CPU (the int8 ResNet-50 through the plain int8 conv) with a decisive classifier (one
logit raised by 100, far above the int8 rounding); its cold-start locking is checked
with a fake batcher in place of the build.
"""

import http.client
import json
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from artist_style_transfer_tpu_torch.infer import http_server as hs  # noqa: E402
from artist_style_transfer_tpu_torch.infer.http_server import (  # noqa: E402
    close_classify_server,
    discover_models,
    make_http_server,
)
from artist_style_transfer_tpu_torch.infer.serve import (  # noqa: E402
    ModelRegistry,
    StylizeServer,
)
from artist_style_transfer_tpu_torch.infer.stylize import (  # noqa: E402
    gaussian_blur,
    sharpen,
    stylize,
)
from artist_style_transfer_tpu_torch.models.resnet import ARTISTS_19, init_classifier  # noqa: E402
from artist_style_transfer_tpu_torch.models.transformer import init_transformer  # noqa: E402
from artist_style_transfer_tpu_torch.train.checkpoint import export_pth, save_params_npz  # noqa: E402
from tests.test_torch_data import one_torch_thread  # noqa: E402,F401

CPU = {"device": "cpu"}


def net(seed: int):
    return init_transformer(torch.Generator().manual_seed(seed)).eval()


def direct(model, im: np.ndarray) -> np.ndarray:
    return stylize(model, im[None], device="cpu")[0].numpy()


def png(im: np.ndarray) -> bytes:
    return cv2.imencode(".png", im)[1].tobytes()


def decode(body: bytes) -> np.ndarray:
    return cv2.imdecode(np.frombuffer(body, np.uint8), cv2.IMREAD_COLOR)


def live(registry, server, **kw):
    httpd = make_http_server(registry, server, host="127.0.0.1", port=0, **kw)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_port}"


def stop(httpd, server) -> None:
    httpd.shutdown()
    httpd.server_close()
    server.close()
    close_classify_server(httpd)


@pytest.fixture(scope="module")
def served():
    """(base_url, model_a, model_b) of a live two-model server."""
    a, b = net(0), net(1)
    registry = ModelRegistry(**CPU)
    registry.register("renoir/random", params=a)
    registry.register("monet/cycle", params=b)
    server = StylizeServer(registry=registry, max_batch=4, max_wait_ms=5.0, **CPU)
    httpd, base = live(registry, server)
    try:
        yield base, a, b
    finally:
        stop(httpd, server)


def _get(url):
    with urllib.request.urlopen(url, timeout=120) as r:
        return r.status, r.read()


def _post(url, data=b"", headers=None):
    req = urllib.request.Request(url, data=data, headers=headers or {}, method="POST")
    with urllib.request.urlopen(req, timeout=240) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


def status_of(method: str, url: str, data=None) -> int:
    try:
        return (_get(url) if method == "GET" else _post(url, data=data))[0]
    except urllib.error.HTTPError as e:
        return e.code


def test_healthz_statsz_models(served):
    base, _, _ = served
    status, body = _get(base + "/healthz")
    assert status == 200 and json.loads(body) == {"status": "ok"}
    status, body = _get(base + "/statsz")
    assert status == 200 and set(json.loads(body)) == {"batches", "images"}
    status, body = _get(base + "/v1/models")
    assert status == 200 and json.loads(body)["models"] == ["monet/cycle", "renoir/random"]


def test_stylize_roundtrip_matches_direct(served):
    base, a, _ = served
    im = (np.random.default_rng(0).random((16, 16, 3)) * 255).astype(np.uint8)
    status, ctype, body = _post(base + "/v1/stylize?model=renoir/random&format=png", png(im))
    assert status == 200 and ctype == "image/png"
    np.testing.assert_array_equal(decode(body), direct(a, im))


def test_stylize_routes_by_model(served):
    base, _, b = served
    im = (np.random.default_rng(1).random((16, 16, 3)) * 255).astype(np.uint8)
    _, _, body = _post(base + "/v1/stylize?model=monet/cycle&format=png", png(im))
    np.testing.assert_array_equal(decode(body), direct(b, im))


def test_stylize_jpeg_default_format(served):
    base, _, _ = served
    im = np.full((16, 16, 3), 128, np.uint8)
    status, ctype, body = _post(base + "/v1/stylize?model=renoir/random", png(im))
    assert status == 200 and ctype == "image/jpeg" and decode(body).shape == im.shape


def test_stylize_post_filters(served):
    base, a, _ = served
    im = (np.random.default_rng(2).random((16, 16, 3)) * 255).astype(np.uint8)
    status, _, body = _post(
        base + "/v1/stylize?model=renoir/random&format=png&blur=1.0&sharpen=50", png(im))
    assert status == 200
    want = sharpen(gaussian_blur(direct(a, im), sigma=1.0), sharpen_val=50.0)
    np.testing.assert_array_equal(decode(body), want)


def test_errors(served):
    base, _, _ = served
    im = png(np.zeros((8, 8, 3), np.uint8))
    cases = [
        ("POST", "/v1/stylize?model=missing/model", im, 404),
        ("POST", "/v1/stylize", im, 400),  # two models: model= required
        ("POST", "/v1/stylize?model=renoir/random", b"", 400),  # empty body
        ("POST", "/v1/stylize?model=renoir/random", b"not an image", 400),
        ("POST", "/v1/stylize?model=renoir/random&format=gif", im, 400),
        ("POST", "/v1/stylize?model=renoir/random&blur=nan3x", im, 400),
        ("POST", "/v1/models/missing/reload", b"", 404),
        ("GET", "/nope", None, 404),
        ("POST", "/nope", b"", 404),
    ]
    for method, path, data, want in cases:
        assert status_of(method, base + path, data) == want, path


def test_malformed_knobs_take_no_batch_slot(served):
    """format, blur and sharpen are validated before the decode: a bad request never
    reaches the batcher."""
    base, _, _ = served
    before = json.loads(_get(base + "/statsz")[1])
    for query in ("format=gif", "blur=x", "sharpen=1e"):
        assert status_of("POST", base + f"/v1/stylize?model=renoir/random&{query}",
                         b"not even an image") == 400
    assert json.loads(_get(base + "/statsz")[1]) == before


def test_oversized_body_rejected_before_read(served):
    """Content-Length above the cap: 413 without reading the body."""
    base, _, _ = served
    for path in ("/v1/stylize?model=renoir/random", "/v1/classify"):
        conn = http.client.HTTPConnection(base.split("//")[1], timeout=60)
        try:
            conn.putrequest("POST", path)
            conn.putheader("Content-Length", str(65 << 20))  # claims 65 MiB
            conn.endheaders()
            conn.send(b"tiny")  # never sends the rest
            # /v1/classify has no classifier here: 503 comes first
            assert conn.getresponse().status == (413 if "stylize" in path else 503)
        finally:
            conn.close()


def test_reload_endpoint_and_hot_swap(tmp_path):
    path = str(tmp_path / "m.npz")
    save_params_npz(path, net(5))
    registry = ModelRegistry(**CPU)
    registry.register("a", path=path)
    server = StylizeServer(registry=registry, max_batch=2, max_wait_ms=2.0, **CPU)
    httpd, base = live(registry, server)
    try:
        im = np.full((8, 8, 3), 64, np.uint8)
        # one registered model: model= may be left out
        _, _, body = _post(base + "/v1/stylize?format=png", png(im))
        np.testing.assert_array_equal(decode(body), direct(net(5), im))
        save_params_npz(path, net(6))
        status, _, body = _post(base + "/v1/models/a/reload")
        assert status == 200 and json.loads(body) == {"model": "a", "reloaded": True}
        _, _, body = _post(base + "/v1/stylize?format=png", png(im))
        np.testing.assert_array_equal(decode(body), direct(net(6), im))
    finally:
        stop(httpd, server)


def test_discover_models(tmp_path):
    """The reference model tree (train_cnn.py:173-178 naming)."""
    d = tmp_path / "models"
    (d / "Renoir" / "random").mkdir(parents=True)
    (d / "Renoir" / "cycle").mkdir(parents=True)
    (d / "Monet").mkdir()  # an artist without method directories: ignored
    for name in ("transfer_17-25_10.pth", "transfer_17-25_200.pth", "transfer2_17-25_50.pth",
                 "style.jpg"):
        (d / "Renoir" / "random" / name).write_bytes(b"")
    # a same-epoch tie (the training CLI exports both): the .npz
    (d / "Renoir" / "cycle" / "transfer_17-25_30.npz").write_bytes(b"")
    (d / "Renoir" / "cycle" / "transfer_17-25_30.pth").write_bytes(b"")
    assert discover_models(str(d)) == {
        "Renoir/random": str(d / "Renoir" / "random" / "transfer_17-25_200.pth"),
        "Renoir/cycle": str(d / "Renoir" / "cycle" / "transfer_17-25_30.npz"),
    }
    assert discover_models(str(tmp_path / "missing")) == {}


@pytest.mark.parametrize("hw", [(300, 280), (64, 64), (256, 400)])
def test_classify_crop(hw):
    """Shorter side to 256 (never below it), centre crop 256."""
    im = (np.random.default_rng(0).random((*hw, 3)) * 255).astype(np.uint8)
    crop = hs.classify_crop(cv2, im)
    assert crop.shape == (256, 256, 3) and crop.dtype == np.uint8
    if min(hw) == 256:
        y0, x0 = (hw[0] - 256) // 2, (hw[1] - 256) // 2
        np.testing.assert_array_equal(crop, im[y0:y0 + 256, x0:x0 + 256])


# --- /v1/classify -------------------------------------------------------------------------


def test_classify_endpoint():
    """The int8 ResNet-50 on the CPU: a decisive classifier's boosted class comes back,
    for a 300x280 image and one smaller than the crop; concurrent requests ride the
    classify batcher, whose counters show on /statsz."""
    clf = init_classifier(torch.Generator().manual_seed(3))
    with torch.no_grad():
        clf.get_submodule("1.8").bias[5] += 100.0
    registry = ModelRegistry(**CPU)
    registry.register("renoir/random", params=net(0))
    server = StylizeServer(registry=registry, max_batch=2, max_wait_ms=2.0, **CPU)
    httpd, base = live(registry, server, classifier_params=clf)
    try:
        im = (np.random.default_rng(0).random((300, 280, 3)) * 255).astype(np.uint8)
        status, ctype, resp = _post(base + "/v1/classify", png(im))
        out = json.loads(resp)
        assert status == 200 and "json" in ctype
        assert out["index"] == 5 and out["artist"] == ARTISTS_19[5]
        assert len(out["top3"]) == 3 and out["top3"][0][0] == ARTISTS_19[5]
        assert abs(sum(p for _, p in out["top3"]) - 1.0) < 1e-3
        status, _, resp = _post(base + "/v1/classify", png(im[:64, :64]))  # upscaled
        assert status == 200 and json.loads(resp)["index"] == 5
        assert status_of("POST", base + "/v1/classify", b"not an image") == 400
        assert status_of("POST", base + "/v1/classify", b"") == 400
        n = 4
        results = [None] * n

        def fire(i):
            results[i] = _post(base + "/v1/classify", png(im))

        threads = [threading.Thread(target=fire, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=240)
        assert all(r[0] == 200 and json.loads(r[2])["index"] == 5 for r in results)
        clf_server = httpd.RequestHandlerClass.server_ctx["clf_state"]["server"]
        assert clf_server.stats["images"] == 2 + n
        assert json.loads(_get(base + "/statsz")[1])["classify"]["images"] == 2 + n
    finally:
        stop(httpd, server)


def _fake_probs(p, x):
    out = np.zeros((x.shape[0], 19), np.float32)
    out[:, 5] = 1.0
    return out


@pytest.fixture
def classify_httpd(monkeypatch):
    """A live server whose classify build is a fake (slowed through the returned dict),
    which isolates the cold-start locking from the real quantize."""
    cfg = {"delay_s": 0.0, "builds": 0, "fail": False}

    def fake_build(ctx):
        if cfg["delay_s"]:
            time.sleep(cfg["delay_s"])
        cfg["builds"] += 1
        if cfg["fail"]:
            raise RuntimeError("no card")
        return StylizeServer(params={"fake": True}, max_batch=4, max_wait_ms=2.0,
                             apply_fn=_fake_probs, **CPU)

    monkeypatch.setattr(hs._Handler, "_build_classify_server", staticmethod(fake_build))
    registry = ModelRegistry(**CPU)
    registry.register("a", params=net(0))
    server = StylizeServer(registry=registry, max_batch=2, max_wait_ms=2.0, **CPU)
    httpd, base = live(registry, server, classifier_params={"dummy": True})
    try:
        yield base, httpd, cfg
    finally:
        stop(httpd, server)


def test_classify_cold_start_not_serialized(classify_httpd):
    """Concurrent first requests neither serialize behind the cold-start build nor each
    run their own: one request builds outside the lock, the others wait on its event."""
    base, httpd, cfg = classify_httpd
    delay = cfg["delay_s"] = 1.0
    body = png(np.zeros((256, 256, 3), np.uint8))
    n = 3
    results = [None] * n

    def fire(i):
        results[i] = _post(base + "/v1/classify", body)

    t0 = time.monotonic()
    threads = [threading.Thread(target=fire, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    elapsed = time.monotonic() - t0
    assert all(r[0] == 200 and json.loads(r[2])["index"] == 5 for r in results)
    state = httpd.RequestHandlerClass.server_ctx["clf_state"]
    assert state["server"] is not None and cfg["builds"] == 1
    assert elapsed < 2 * delay, f"cold starts serialized: {elapsed:.2f}s"


def test_classify_failed_build_is_500_then_retried(classify_httpd):
    base, httpd, cfg = classify_httpd
    body = png(np.zeros((256, 256, 3), np.uint8))
    cfg["fail"] = True
    assert status_of("POST", base + "/v1/classify", body) == 500
    cfg["fail"] = False  # the next request builds again
    assert status_of("POST", base + "/v1/classify", body) == 200 and cfg["builds"] == 2


def test_classify_closed_batcher_maps_503(classify_httpd):
    """A request racing close_classify_server() past the closed gate calls submit() on a
    closed batcher: a 503 (shutdown), not a 500."""
    base, httpd, _ = classify_httpd
    body = png(np.zeros((256, 256, 3), np.uint8))
    assert status_of("POST", base + "/v1/classify", body) == 200
    httpd.RequestHandlerClass.server_ctx["clf_state"]["server"].close()
    assert status_of("POST", base + "/v1/classify", body) == 503
    close_classify_server(httpd)  # closed: no fresh batcher is built
    assert status_of("POST", base + "/v1/classify", body) == 503


def test_classify_oversized_body_rejected_before_read(classify_httpd):
    base, _, cfg = classify_httpd
    conn = http.client.HTTPConnection(base.split("//")[1], timeout=60)
    try:
        conn.putrequest("POST", "/v1/classify")
        conn.putheader("Content-Length", str(65 << 20))
        conn.endheaders()
        conn.send(b"tiny")
        assert conn.getresponse().status == 413
    finally:
        conn.close()
    assert cfg["builds"] == 0  # refused before the decode and the cold start


def test_classify_unconfigured_503(served):
    base, _, _ = served
    assert status_of("POST", base + "/v1/classify", png(np.zeros((256, 256, 3), np.uint8))) == 503


# --- the CLI ------------------------------------------------------------------------------


def test_main_serves_and_stops_on_sigint(tmp_path):
    """``python -m ...infer.http_server`` on a reference model tree (the .npz chosen over
    the .pth of the same epoch) with ``--port 0``: it prints the real port, serves, and
    exits 0 on SIGINT."""
    import signal

    d = tmp_path / "models" / "A" / "random"
    d.mkdir(parents=True)
    export_pth(str(d / "transfer_17-25_2.pth"), net(1))
    save_params_npz(str(d / "transfer_17-25_2.npz"), net(0))
    proc = subprocess.Popen(
        [sys.executable, "-m", "artist_style_transfer_tpu_torch.infer.http_server",
         "--models-dir", str(tmp_path / "models"), "--host", "127.0.0.1", "--port", "0",
         "--device", "cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        lines = []
        while not lines or not lines[-1].startswith("serving"):
            line = proc.stdout.readline()
            assert line, "".join(lines)
            lines.append(line)
        assert f"registered A/random <- {d / 'transfer_17-25_2.npz'}" in lines[0]
        port = int(lines[-1].rsplit(":", 1)[1])
        assert lines[-1].startswith("serving 1 model(s) on 127.0.0.1:")
        im = np.full((8, 8, 3), 90, np.uint8)
        _, _, body = _post(f"http://127.0.0.1:{port}/v1/stylize?format=png", png(im))
        np.testing.assert_array_equal(decode(body), direct(net(0), im))
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stdout.close()
    with pytest.raises(SystemExit):  # nothing to serve
        hs.main(["--models-dir", str(tmp_path / "empty"), "--device", "cpu"])
