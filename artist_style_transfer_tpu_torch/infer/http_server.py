"""HTTP front end of the stylization serving stack (counterpart of the JAX
``infer/http_server.py``).

The reference has no serving component (``inference.py`` is an
edit-the-constants script, inference.py:24-52). This module puts a network face
on :class:`~artist_style_transfer_tpu_torch.infer.serve.StylizeServer` and
:class:`~artist_style_transfer_tpu_torch.infer.serve.ModelRegistry`:

- ``GET  /healthz``                  liveness probe
- ``GET  /statsz``                   batcher counters (batches, images; plus a
  ``classify`` sub-object once that batcher has started)
- ``GET  /v1/models``                registered model names (JSON)
- ``POST /v1/models/<name>/reload``  force a checkpoint re-read
- ``POST /v1/stylize?model=<name>``  body = JPEG/PNG bytes; response = the
  stylized image. Query knobs: ``format=jpg|png`` (default jpg),
  ``blur=<sigma>`` / ``sharpen=<amount>``, the reference's post-filters
  (inference.py:38-44, 119-125).
- ``POST /v1/classify``              body = image bytes; response = JSON artist
  prediction of the 19-class ResNet-50 (the reference's eval classifier,
  inference.py:153-166) in int8 (``models/resnet_q.py``, kernel K2 on the card).
  The input takes the eval transform generalized to any size: shorter side to
  256, centre crop 256 (inference.py:56-59). Needs ``--classifier-path``.
  Concurrent requests coalesce into batches through the same micro-batcher as
  stylize: every crop is 256x256, so all classify traffic shares one key.

Design: the stdlib ``ThreadingHTTPServer``; each connection is a thread that
blocks on its request's ``Future``, while the device work is coalesced by the
batchers' worker threads. Image decode and encode stay on the host (cv2) in the
handler threads; uint8 crosses to the device. Model files use the reference
tree ``models/<artist>/<method>/transfer[2]_<cw>-<sw>_<epoch>.pth``
(train_cnn.py:173-178): :func:`discover_models` registers the newest
checkpoint of each ``<artist>/<method>`` under that name.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from artist_style_transfer_tpu_torch.infer.serve import ModelRegistry, StylizeServer

_CKPT_RE = re.compile(r"^transfer2?_.*_(\d+)\.(pth|npz)$")
CLASSIFY_SIZE = 256  # the reference eval transform's crop (inference.py:56-59)


def _cv2():
    try:
        import cv2
    except Exception as e:  # environment-dependent
        raise RuntimeError("OpenCV is required for HTTP image decode/encode") from e
    return cv2


def discover_models(models_dir: str) -> dict[str, str]:
    """Map ``<artist>/<method>`` -> newest checkpoint path under ``models_dir``.

    The reference's model tree (train_cnn.py:173-178, inference.py:27-31): in each
    ``<artist>/<method>`` directory the ``transfer[2]_<cw>-<sw>_<epoch>.pth`` (or
    ``.npz``) of highest epoch wins.
    """
    found: dict[str, str] = {}
    if not os.path.isdir(models_dir):
        return found
    for artist in sorted(os.listdir(models_dir)):
        adir = os.path.join(models_dir, artist)
        if not os.path.isdir(adir):
            continue
        for method in sorted(os.listdir(adir)):
            mdir = os.path.join(adir, method)
            if not os.path.isdir(mdir):
                continue
            # Highest epoch wins; on a tie (the training CLI exports both .pth and
            # .npz at the final epoch) the .npz. The sorted scan keeps it deterministic.
            best: tuple[int, int, str] | None = None
            for fname in sorted(os.listdir(mdir)):
                m = _CKPT_RE.match(fname)
                if m:
                    key = (int(m.group(1)), 1 if m.group(2) == "npz" else 0)
                    if best is None or key > best[:2]:
                        best = (*key, os.path.join(mdir, fname))
            if best is not None:
                found[f"{artist}/{method}"] = best[2]
    return found


def classify_crop(cv2, img: np.ndarray) -> np.ndarray:
    """The eval transform generalized to any size: shorter side scaled to 256 (never
    below it), centre crop 256 (reference ``CenterCrop(256)``, inference.py:56-59)."""
    h, w = img.shape[:2]
    if min(h, w) != CLASSIFY_SIZE:
        s = CLASSIFY_SIZE / min(h, w)
        img = cv2.resize(img, (max(CLASSIFY_SIZE, round(w * s)), max(CLASSIFY_SIZE, round(h * s))))
        h, w = img.shape[:2]
    y0, x0 = (h - CLASSIFY_SIZE) // 2, (w - CLASSIFY_SIZE) // 2
    return np.ascontiguousarray(img[y0: y0 + CLASSIFY_SIZE, x0: x0 + CLASSIFY_SIZE], np.uint8)


class _Handler(BaseHTTPRequestHandler):
    # set by make_http_server():
    server_ctx: dict = {}

    def log_message(self, fmt, *args):  # noqa: D102  (quiet per-request logging)
        pass

    # ------------------------------------------------------------------
    def _json(self, code: int, obj) -> None:
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _error(self, code: int, message: str) -> None:
        self._json(code, {"error": message})

    # ------------------------------------------------------------------
    def do_GET(self):  # noqa: N802 (stdlib API)
        ctx = self.server_ctx
        path = urlparse(self.path).path
        if path == "/healthz":
            self._json(200, {"status": "ok"})
        elif path == "/statsz":
            stats = dict(ctx["server"].stats)
            # Lock-free read: the reference assignment is atomic, and taking
            # clf_state['lock'] would block monitoring for the whole classifier cold
            # start, which runs under it.
            clf_srv = ctx["clf_state"]["server"]
            if clf_srv is not None:
                stats["classify"] = dict(clf_srv.stats)
            self._json(200, stats)
        elif path == "/v1/models":
            self._json(200, {"models": ctx["registry"].names()})
        else:
            self._error(404, f"unknown path {path}")

    @staticmethod
    def _build_classify_server(ctx) -> StylizeServer:
        """Quantize the classifier and wrap it in its micro-batcher, on the classifier's
        device.

        Called outside ``clf_state['lock']`` (double-checked init): a cold build
        (quantizing, K2's first launches, a cold checkout's nvcc) takes seconds, and
        holding the lock through it would serialize every concurrent classify request
        behind it. Losing racers discard their spare batcher."""
        from artist_style_transfer_tpu_torch.models.resnet_q import (
            classifier_apply_int8,
            quantize_classifier,
        )
        from artist_style_transfer_tpu_torch.ops.image import bgr_to_rgb, torchvision_normalize
        from artist_style_transfer_tpu_torch.utils.device import module_device

        qmodel = quantize_classifier(ctx["classifier_params"])

        def probs(qm, x_bgr_u8: torch.Tensor) -> np.ndarray:
            # Grad mode is per thread: the batcher's worker sets its own.
            with torch.inference_mode():
                rgb01 = bgr_to_rgb(x_bgr_u8.float()) / 255.0
                logits = classifier_apply_int8(qm, torchvision_normalize(rgb01))
                return torch.softmax(logits.float(), dim=-1).cpu().numpy()

        # Every request is a 256x256 uint8 crop, so all concurrent classify traffic
        # coalesces into single int8 batches instead of one launch set per request.
        return StylizeServer(params=qmodel, max_batch=ctx["clf_max_batch"],
                             max_wait_ms=ctx["clf_max_wait_ms"], apply_fn=probs,
                             device=module_device(qmodel))

    def _classify(self, parsed):
        """POST /v1/classify: artist prediction of the int8 classifier."""
        ctx = self.server_ctx
        if ctx.get("classifier_params") is None:
            return self._error(503, "no classifier configured (start with --classifier-path)")
        length = int(self.headers.get("Content-Length") or 0)
        if length <= 0:
            return self._error(400, "empty request body (expected image bytes)")
        if length > ctx["max_body_bytes"]:
            return self._error(
                413, f"request body too large ({length} > {ctx['max_body_bytes']} bytes)")
        data = self.rfile.read(length)
        cv2 = _cv2()
        img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        if img is None:
            return self._error(400, "could not decode image body")

        state = ctx["clf_state"]
        srv = state["server"]
        if srv is None:
            # Single-flight cold start: exactly one request runs the build (outside
            # the lock); the others wait on its event. Without it, N concurrent cold
            # requests would run N builds against the one card.
            do_build = False
            with state["lock"]:
                if state.get("closed"):
                    return self._error(503, "server is shutting down")
                evt = state.get("building")
                if state["server"] is None and evt is None:
                    evt = state["building"] = threading.Event()
                    do_build = True
            if do_build:
                built = err = None
                try:
                    built = self._build_classify_server(ctx)  # slow; lock not held
                except Exception as e:  # reported as a 500, not a dead socket
                    err = e
                finally:
                    with state["lock"]:
                        if built is not None and not state.get("closed") \
                                and state["server"] is None:
                            state["server"] = built  # publish
                            built = None
                        state["building"] = None
                        closed = state.get("closed", False)
                        srv = state["server"]
                    evt.set()  # wake the waiters whether it was published or failed
                if built is not None:  # closing: discard the spare batcher
                    built.close(timeout=0)
                if err is not None:
                    return self._error(
                        500, f"classifier init failed: {type(err).__name__}: {err}")
                if closed or srv is None:
                    return self._error(503, "server is shutting down")
            else:
                if evt is not None and not evt.wait(timeout=ctx["timeout_s"]):
                    return self._error(503, "classifier is still initializing")
                with state["lock"]:
                    closed = state.get("closed", False)
                    srv = state["server"]
                if closed or srv is None:
                    return self._error(
                        503, "server is shutting down" if closed
                        else "classifier initialization failed; retry")
        crop = classify_crop(cv2, img)
        try:
            fut = srv.submit(crop)
        except RuntimeError:
            # submit() raises RuntimeError iff the batcher is closed: a request racing
            # close_classify_server() past the gate above. A shutdown, not a fault.
            return self._error(503, "server is shutting down")
        try:
            p = fut.result(timeout=ctx["timeout_s"])
        except Exception as e:
            return self._error(500, f"classify failed: {type(e).__name__}: {e}")
        from artist_style_transfer_tpu_torch.models.resnet import ARTISTS_19

        order = np.argsort(p)[::-1][:3]
        names = (list(ARTISTS_19) if len(p) == len(ARTISTS_19)
                 else [str(i) for i in range(len(p))])
        return self._json(200, {
            "artist": names[int(order[0])],
            "index": int(order[0]),
            "top3": [[names[int(i)], float(p[i])] for i in order],
        })

    def do_POST(self):  # noqa: N802 (stdlib API)
        ctx = self.server_ctx
        parsed = urlparse(self.path)
        path = parsed.path
        reload_m = re.match(r"^/v1/models/(.+)/reload$", path)
        if reload_m:
            name = reload_m.group(1)
            registry: ModelRegistry = ctx["registry"]
            if name not in registry:
                return self._error(404, f"model {name!r} is not registered")
            try:
                swapped = registry.reload(name, force=True)
            except Exception as e:
                return self._error(500, f"reload failed: {e}")
            return self._json(200, {"model": name, "reloaded": bool(swapped)})
        if path == "/v1/classify":
            return self._classify(parsed)
        if path != "/v1/stylize":
            return self._error(404, f"unknown path {path}")

        q = parse_qs(parsed.query)
        name = q.get("model", [None])[0]
        registry = ctx["registry"]
        if name is None:
            names = registry.names()
            if len(names) != 1:
                return self._error(
                    400, "model= query parameter required (multiple models registered)")
            name = names[0]
        if name not in registry:
            return self._error(404, f"model {name!r} is not registered")

        # Every query knob is validated before the decode: a malformed request must
        # not take a slot in a device batch.
        try:
            blur = float(q.get("blur", [0.0])[0])
            sharpen_amt = float(q.get("sharpen", [0.0])[0])
        except ValueError:
            return self._error(400, "blur/sharpen must be numeric")
        fmt = q.get("format", ["jpg"])[0].lower()
        if fmt not in ("jpg", "jpeg", "png"):
            return self._error(400, f"unsupported format {fmt!r}")

        length = int(self.headers.get("Content-Length") or 0)
        if length <= 0:
            return self._error(400, "empty request body (expected image bytes)")
        if length > ctx["max_body_bytes"]:
            return self._error(
                413, f"request body too large ({length} > {ctx['max_body_bytes']} bytes)")
        data = self.rfile.read(length)
        cv2 = _cv2()
        img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        if img is None:
            return self._error(400, "could not decode image body")

        try:
            out = ctx["server"].submit(img.astype(np.uint8), model=name).result(
                timeout=ctx["timeout_s"])
        except Exception as e:
            # A TimeoutError stringifies empty: always name the type. A timeout usually
            # means a cold start (a cold checkout's nvcc build) outlived
            # --request-timeout-s; the batch still completes, so a retry is fast.
            return self._error(500, f"stylize failed: {type(e).__name__}: {e}")

        # The reference's BLUR/SHARPEN post-filters (inference.py:38-44, 119-125), on
        # the host.
        if blur > 0 or sharpen_amt > 0:
            from artist_style_transfer_tpu_torch.infer.stylize import gaussian_blur, sharpen

            if blur > 0:
                out = gaussian_blur(out, sigma=blur)
            if sharpen_amt > 0:
                out = sharpen(out, sharpen_val=sharpen_amt)

        ext = ".png" if fmt == "png" else ".jpg"
        ok, buf = cv2.imencode(ext, out)
        if not ok:
            return self._error(500, "image encode failed")
        body = buf.tobytes()
        self.send_response(200)
        self.send_header("Content-Type", "image/png" if fmt == "png" else "image/jpeg")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


def make_http_server(
    registry: ModelRegistry,
    server: StylizeServer,
    host: str = "127.0.0.1",
    port: int = 0,
    request_timeout_s: float = 120.0,
    max_body_bytes: int = 64 << 20,
    classifier_params=None,
    classify_max_batch: int = 8,
    classify_max_wait_ms: float = 3.0,
) -> ThreadingHTTPServer:
    """A ``ThreadingHTTPServer`` bound to ``host:port`` (0: an ephemeral port).

    The caller owns the lifecycle: ``serve_forever()`` (or a thread running it) and
    ``shutdown()``; the ``StylizeServer`` is closed separately. ``classifier_params``
    (a :class:`models.resnet.ResNet50Classifier` on the serving device) enables
    ``/v1/classify``: quantized to int8 and wrapped in its own micro-batcher
    (``classify_max_batch`` / ``classify_max_wait_ms``) at first use; close it with
    :func:`close_classify_server`.
    """
    handler = type("BoundHandler", (_Handler,), {"server_ctx": {
        "registry": registry,
        "server": server,
        "timeout_s": request_timeout_s,
        "max_body_bytes": int(max_body_bytes),
        "classifier_params": classifier_params,
        "clf_max_batch": int(classify_max_batch),
        "clf_max_wait_ms": float(classify_max_wait_ms),
        "clf_state": {
            "lock": threading.Lock(),
            "server": None,
            "building": None,  # an Event while one request runs the build
        },
    }})
    return ThreadingHTTPServer((host, port), handler)


def close_classify_server(httpd: ThreadingHTTPServer, timeout: float | None = 10.0) -> None:
    """Close the lazily created classify micro-batcher, if it ever started.

    Marks the state closed under the lock first, so a request thread racing past
    ``httpd.shutdown()`` cannot create a fresh batcher afterwards (it gets a 503):
    no worker thread leaks."""
    state = httpd.RequestHandlerClass.server_ctx["clf_state"]
    with state["lock"]:
        state["closed"] = True
        srv = state["server"]
    if srv is not None:
        srv.close(timeout)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Multi-tenant stylization HTTP server")
    parser.add_argument(
        "--models-dir", default=None,
        help="reference-layout model tree models/<artist>/<method>/*.pth "
        "(train_cnn.py:173-178); newest epoch per method is registered")
    parser.add_argument("--model", action="append", default=[], metavar="NAME=PATH",
                        help="register one checkpoint under NAME (repeatable)")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--max-batch", type=int, default=8)
    parser.add_argument("--max-wait-ms", type=float, default=3.0)
    parser.add_argument(
        "--request-timeout-s", type=float, default=600.0,
        help="per-request wait on the device batch; must cover a cold start (a cold "
        "checkout builds the kernels with nvcc at first use)")
    parser.add_argument("--auto-reload", action="store_true",
                        help="re-stat checkpoint files on every request and hot-swap on change")
    parser.add_argument("--quantize", action="store_true",
                        help="serve int8 quantized models (models/transformer_q.py, kernel K2)")
    parser.add_argument(
        "--classifier-path", default=None,
        help="ResNet-50 artist classifier checkpoint (models/best-2.pth); enables "
        "POST /v1/classify in int8")
    parser.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = parser.parse_args(argv)

    registry = ModelRegistry(auto_reload=args.auto_reload, quantize=args.quantize,
                             device=args.device)
    if args.models_dir:
        for name, path in discover_models(args.models_dir).items():
            registry.register(name, path=path)
            print(f"registered {name} <- {path}", flush=True)
    for spec in args.model:
        name, _, path = spec.partition("=")
        if not path:
            parser.error(f"--model expects NAME=PATH, got {spec!r}")
        registry.register(name, path=path)
        print(f"registered {name} <- {path}", flush=True)
    if not registry.names():
        parser.error("no models registered (use --models-dir or --model)")

    clf = None
    if args.classifier_path:
        from artist_style_transfer_tpu_torch.models.resnet import load_classifier

        clf = load_classifier(args.classifier_path, args.device)
        print(f"classifier loaded <- {args.classifier_path}", flush=True)

    server = StylizeServer(registry=registry, max_batch=args.max_batch,
                           max_wait_ms=args.max_wait_ms, device=args.device)
    httpd = make_http_server(registry, server, host=args.host, port=args.port,
                             request_timeout_s=args.request_timeout_s,
                             classifier_params=clf)
    print(f"serving {len(registry.names())} model(s) on {args.host}:{httpd.server_port}",
          flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.shutdown()
        server.close()
        close_classify_server(httpd)


if __name__ == "__main__":
    main()
