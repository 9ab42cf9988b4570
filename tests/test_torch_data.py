"""The data pipeline of the PyTorch port on the CPU, held against the JAX package's
``data/`` and ``ops/image.py`` on the same seeded workspace.

Tolerances:

- ``resize_bilinear`` and ``affine_rescale`` against JAX: 1e-3 absolute on the
  255 scale, borders included (the same f32 arithmetic; the resize is
  ``F.interpolate`` against ``jax.image.resize``). Against cv2: below 1.0, cv2's
  fixed-point interpolation, as the JAX package's own tests hold theirs.
- Loaders: ``np.array_equal`` where both packages take the same decoder route;
  below 1.0 across routes (the native pool resamples in float, cv2 in fixed
  point and rounds to uint8). The mean image truncates to uint8, so across
  routes two means within 1.0 may truncate one apart: at most 1.0 there.
"""

import os
import pickle
import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

cv2 = pytest.importorskip("cv2")

from artist_style_transfer_tpu.data import datasets as jdata
from artist_style_transfer_tpu.data import native_loader as jnative
from artist_style_transfer_tpu.ops import image as jimage
from artist_style_transfer_tpu_torch import inference
from artist_style_transfer_tpu_torch.data import datasets as tdata
from artist_style_transfer_tpu_torch.data import native_loader as tnative
from artist_style_transfer_tpu_torch.ops import image as timage

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTISTS = (("Artist One", 3), ("Artist Two", 2))
ROUTES = {"native": (True, True), "cv2": (False, False), "across": (True, False)}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while a module's tests run: their nets and images are tiny,
    and under pytest-xdist every worker would otherwise start a thread per core, so
    the workers' threads would contend for the cores (a 5x slower run, measured).
    Modules that import this fixture get it too."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_native_loader() -> bool:
    """Whether the JAX package's native loader is loaded, made reliable under xdist.

    JAX's loader builds ``native/libastloader.so`` with a plain ``make`` that writes
    the file in place, and caches a failed load for the life of the process
    (``data/native_loader.py:40-53``); with several workers, one can load a file that
    another is still writing, and fail from then on. Here, under an ``fcntl`` lock
    on a file in ``build/``, a JAX loader that has not loaded is pointed at the
    port's build of the same source with the same flags (``native/Makefile``'s, as
    ``test_native_build_uses_the_makefile_flags`` checks), which is written to a
    temporary file and renamed into place, and loaded again. False where the port's
    build does not load either (no compiler or no libjpeg)."""
    import fcntl

    if jnative._lib is not None:
        return True
    if tnative._load() is None:  # the module's loader, whatever a test patched available to
        return False
    tnative.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(tnative.BUILD_DIR / "jax-native-loader.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if jnative._lib is None:
            jnative._LIB_PATH = str(tnative.library_path())
            jnative._tried = False
            jnative._load()
    return jnative._lib is not None


def write_workspace(root, n_content: int = 6, seed: int = 0) -> dict:
    """The reference layout (dataset.py:10-13) under ``root``: ``images/content/`` with
    ``n_content`` JPEGs of 24-48 px and one file truncated inside its headers, which no
    decoder reads; ``images/archive/artists.csv`` and ``resized/resized/<name>_<i>.jpg``;
    an empty ``dicts/``. Returns the paths."""
    rng = np.random.default_rng(seed)
    ws = {k: os.path.join(str(root), v) for k, v in (
        ("content", "images/content"), ("archive", "images/archive/"), ("cache", "dicts/"))}
    for d in ws.values():
        os.makedirs(d, exist_ok=True)
    os.makedirs(os.path.join(ws["archive"], "resized", "resized"))
    for i in range(n_content):
        h, w = (int(v) for v in rng.integers(24, 49, 2))
        cv2.imwrite(os.path.join(ws["content"], f"c{i}.jpg"),
                    rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
    with open(os.path.join(ws["content"], "c0.jpg"), "rb") as f:
        head = f.read(200)
    ws["bad"] = os.path.join(ws["content"], "truncated.jpg")
    with open(ws["bad"], "wb") as f:
        f.write(head)
    with open(os.path.join(ws["archive"], "artists.csv"), "w") as f:
        f.write("id,name,paintings\n")
        for k, (name, n) in enumerate(ARTISTS):
            f.write(f"{k},{name},{n}\n")
            for i in range(1, n + 1):
                h, w = (int(v) for v in rng.integers(20, 41, 2))
                cv2.imwrite(os.path.join(ws["archive"], "resized", "resized",
                                         f"{name.replace(' ', '_')}_{i}.jpg"),
                            rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
    return ws


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    return write_workspace(tmp_path_factory.mktemp("ws"))


def set_routes(monkeypatch, route: str) -> None:
    """Make each package's native pool available or not: ``route`` names both."""
    jax_native, port_native = ROUTES[route]
    monkeypatch.setattr(jnative, "available", lambda: jax_native)
    monkeypatch.setattr(tnative, "available", lambda: port_native)


def assert_route(got, want, route: str, tol: float = 1.0) -> None:
    assert got.shape == want.shape and got.dtype == want.dtype
    if route == "across":
        assert np.abs(got - want).max() < tol
    else:
        np.testing.assert_array_equal(got, want)


# --- ops/image.py --------------------------------------------------------------------


@pytest.mark.parametrize("shape,out", [((37, 53, 3), (24, 31)), ((20, 17, 3), (45, 60)),
                                       ((2, 37, 53, 3), (24, 80)), ((3, 10, 10, 3), (10, 30))],
                         ids=["down-hwc", "up-hwc", "mixed-nhwc", "up-nhwc"])
def test_resize_bilinear_matches_jax_and_cv2(shape, out):
    img = np.random.default_rng(sum(shape)).uniform(0, 255, shape).astype(np.float32)
    got = timage.resize_bilinear(torch.from_numpy(img), *out).numpy()
    want = np.asarray(jimage.resize_bilinear(jnp.asarray(img), *out))
    assert got.shape == want.shape
    assert np.abs(got - want).max() < 1e-3
    for a, b in ((got[0], want[0]), (got[-1], want[-1]), (got[..., 0, :], want[..., 0, :]),
                 (got[..., -1, :], want[..., -1, :])):  # the border rows and columns
        assert np.abs(a - b).max() < 1e-3
    for i, im in enumerate(img if img.ndim == 4 else img[None]):
        ref = cv2.resize(im, (out[1], out[0]), interpolation=cv2.INTER_LINEAR)
        assert np.abs((got if img.ndim == 4 else got[None])[i] - ref).max() < 1.0


@pytest.mark.parametrize("shape,out", [((48, 80, 3), (32, 56)), ((10, 10, 3), (20, 40)),
                                       ((30, 20, 3), (24, 24))],
                         ids=["down", "up-zero-border", "square"])
def test_affine_rescale_matches_jax_and_cv2(shape, out):
    img = np.random.default_rng(sum(shape)).uniform(0, 255, shape).astype(np.float32)
    got = timage.affine_rescale(torch.from_numpy(img), *out).numpy()
    np.testing.assert_allclose(got, np.asarray(jimage.affine_rescale(jnp.asarray(img), *out)),
                               rtol=0, atol=1e-3)
    assert np.abs(got - tdata.rescale_image(img, *out)).max() < 1.0
    assert np.abs(got - jdata.rescale_image(img, *out)).max() < 1.0


def test_preprocess_constants_are_made_once_and_serve_autograd():
    """The mean/std constants are made once per device and dtype; made first inside
    ``inference_mode`` (evaluation) they still serve a training step's autograd."""
    timage._constant.cache_clear()
    x = torch.rand(1, 4, 4, 3)
    with torch.inference_mode():
        timage.vgg_caffe_preprocess(x)
        timage.torchvision_normalize(x)
    y = x.clone().requires_grad_(True)
    (timage.vgg_caffe_preprocess(y).sum() + timage.torchvision_normalize(y).sum()).backward()
    torch.testing.assert_close(y.grad, (1 + 1 / torch.tensor(timage.TORCHVISION_STD_RGB))
                               .expand_as(y))
    assert timage._constant.cache_info().currsize == 3
    np.testing.assert_allclose(timage.vgg_caffe_preprocess(y).detach().numpy(),
                               np.asarray(jimage.vgg_caffe_preprocess(jnp.asarray(x.numpy()))),
                               atol=1e-5)


def test_resize_bilinear_refuses_other_ranks():
    with pytest.raises(ValueError, match="HWC or NHWC"):
        timage.resize_bilinear(torch.zeros(4, 4), 2, 2)


# --- native_loader -------------------------------------------------------------------


def test_native_loader_builds_with_the_makefile_flags():
    flags = {}
    with open(os.path.join(ROOT, "native", "Makefile")) as f:
        for line in f:
            if "?=" in line:
                k, v = line.split("?=")
                flags[k.strip()] = tuple(v.split())
    assert (flags["CXX"][0], flags["CXXFLAGS"], flags["LDFLAGS"]) == (
        tnative.CXX, tnative.CXXFLAGS, tnative.LDFLAGS)
    path = tnative.library_path()
    assert path.parent == tnative.BUILD_DIR and path.parent.name == "build"
    if not tnative.available():
        pytest.skip(f"native loader does not build here: {tnative.load_error}")
    assert path.exists()


@pytest.mark.parametrize("mode", ["resize", "rescale"])
def test_native_resample_equals_the_jax_binding(mode):
    if not (tnative.available() and jax_native_loader()):
        pytest.skip("native loader unavailable")
    img = np.random.default_rng(1).integers(0, 256, (48, 80, 3), dtype=np.uint8)
    m = tnative.MODE_RESIZE if mode == "resize" else tnative.MODE_RESCALE
    np.testing.assert_array_equal(tnative.resample(img, 24, 31, m),
                                  jnative.resample(img, 24, 31, m))


def test_native_decode_batch_equals_the_jax_binding(ws):
    if not (tnative.available() and jax_native_loader()):
        pytest.skip("native loader unavailable")
    paths = [os.path.join(ws["content"], f) for f in sorted(os.listdir(ws["content"]))]
    got, ok = tnative.decode_batch(paths, 16, 20)
    want, want_ok = jnative.decode_batch(paths, 16, 20)
    np.testing.assert_array_equal(ok, want_ok)
    np.testing.assert_array_equal(got, want)
    assert not ok[paths.index(ws["bad"])] and ok.sum() == len(paths) - 1


# --- loaders against JAX -------------------------------------------------------------


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("size", [4, 6, 10])
def test_content_dataset_matches_jax(ws, monkeypatch, route, size):
    set_routes(monkeypatch, route)
    stats = {}
    got = tdata.get_content_dataset(size, 16, 24, content_dir=ws["content"], seed=1, stats=stats)
    want = jdata.get_content_dataset(size, 16, 24, content_dir=ws["content"], seed=1)
    assert_route(got, want, route)
    assert stats["decoder"] == ("native" if ROUTES[route][1] else "cv2")
    assert stats["images"] == len(got) == min(size, 6)
    assert stats["skipped"] == stats["files_read"] - len(got)
    if size > 6:  # every file was read, and the truncated one skipped
        assert stats["skipped"] == 1


def test_content_dataset_cv2_route_is_the_serial_loop(ws, monkeypatch):
    """The thread pool gives what the reference's serial imread/resize loop gives."""
    set_routes(monkeypatch, "cv2")
    files = sorted(os.listdir(ws["content"]))
    random.Random(5).shuffle(files)
    want = []
    for f in files:
        im = cv2.imread(os.path.join(ws["content"], f))
        if im is not None:
            want.append(cv2.resize(im, (12, 12)).astype(np.float32))
    got = tdata.get_content_dataset(5, 12, 12, content_dir=ws["content"], seed=5)
    np.testing.assert_array_equal(got, np.stack(want[:5]))


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("dims", [(16, 16), (-1, -1)], ids=["explicit", "half-average"])
def test_painting_dataset_matches_jax(ws, monkeypatch, route, dims):
    set_routes(monkeypatch, route)
    kw = dict(load_pickle=False, archive_dir=ws["archive"], cache_dir=ws["cache"])
    stats = {}
    got = tdata.get_painting_dataset(False, *dims, stats=stats, **kw)
    want = jdata.get_painting_dataset(False, *dims, **kw)
    assert list(got) == list(want) == ["Artist_One", "Artist_Two"]
    for name in want:
        # Without explicit dims both packages decode with cv2 whatever the pool.
        assert_route(got[name], want[name], route if dims[0] > 0 else "cv2")
    native = dims[0] > 0 and ROUTES[route][1]
    assert stats == dict(stats, source="decoded", images=5,
                         decoder="native" if native else "cv2")
    images, labels = tdata.get_painting_dataset(True, *dims, **kw)
    want_images, want_labels = jdata.get_painting_dataset(True, *dims, **kw)
    np.testing.assert_array_equal(labels, want_labels)
    assert_route(images, want_images, route if dims[0] > 0 else "cv2", tol=1.0 / (255 * 0.224))


@pytest.mark.parametrize("route", list(ROUTES))
def test_avg_dataset_matches_jax(ws, monkeypatch, route):
    set_routes(monkeypatch, route)
    kw = dict(archive_dir=ws["archive"], cache_dir=ws["cache"])
    got, want = tdata.get_avg_dataset(16, 16, **kw), jdata.get_avg_dataset(16, 16, **kw)
    assert list(got) == list(want)
    for name in want:
        assert got[name].dtype == np.float32 and np.all(got[name] == np.floor(got[name]))
        assert_route(got[name], want[name], route, tol=1.0 + 1e-6)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_npz_cache_is_read_by_the_other_package(ws, tmp_path, writer):
    kw = dict(archive_dir=ws["archive"], cache_dir=str(tmp_path) + "/")
    save, load = ((jdata, tdata) if writer == "jax" else (tdata, jdata))
    written = save.get_painting_dataset(False, 16, 16, load_pickle=False, save_pickle=True, **kw)
    stats = {}
    for package in (load, save):
        read = package.get_painting_dataset(False, -1, -1, **kw,
                                            **({"stats": stats} if package is tdata else {}))
        for name in written:
            np.testing.assert_array_equal(read[name], written[name].astype(np.uint8))
    assert stats["source"] == "npz"
    z = np.load(os.path.join(kw["cache_dir"], "paintings_cache.npz"))
    assert z["images"].dtype == np.uint8 and z["offsets"].tolist() == [0, 3, 5]
    # Explicit dims other than the cached shape rescale the cached images.
    small = tdata.get_painting_dataset(False, 8, 8, **kw)
    want = jdata.get_painting_dataset(False, 8, 8, **kw)
    for name in want:
        np.testing.assert_array_equal(small[name], want[name])


def test_reference_pickles_and_classifier_cache(ws, tmp_path):
    rng = np.random.default_rng(3)
    data = {"Artist_One": [rng.integers(0, 256, (20, 20, 3), dtype=np.uint8)],
            "Artist_Two": [rng.integers(0, 256, (24, 20, 3), dtype=np.uint8)]}
    with open(tmp_path / "full_int_0.pkl", "wb") as f:
        pickle.dump(data, f)
    kw = dict(archive_dir=ws["archive"], cache_dir=str(tmp_path) + "/")
    stats = {}
    got = tdata.get_painting_dataset(False, 12, 12, stats=stats, **kw)
    want = jdata.get_painting_dataset(False, 12, 12, **kw)
    assert stats["source"] == "pickle"
    for name in want:
        np.testing.assert_array_equal(got[name], want[name])
    ins = rng.standard_normal((5, 3, 16, 16)).astype(np.float32)
    np.savez(tmp_path / "in_tensors.npz", ins)
    np.savez(tmp_path / "out_tensors.npz", np.array([0, 0, 1, 1, 1], np.int64))
    images, labels = tdata.get_painting_dataset(True, stats=stats, **kw)
    want_images, want_labels = jdata.get_painting_dataset(True, **kw)
    np.testing.assert_array_equal(images, want_images)
    np.testing.assert_array_equal(labels, want_labels)
    assert labels.dtype == np.int32 and stats["source"] == "classifier_cache"


def test_load_artist_names_and_rescale_image_match_jax(ws):
    assert tdata.load_artist_names(ws["archive"]) == jdata.load_artist_names(ws["archive"])
    img = np.random.default_rng(2).integers(0, 256, (30, 44, 3), dtype=np.uint8)
    np.testing.assert_array_equal(tdata.rescale_image(img, 16, 24),
                                  jdata.rescale_image(img, 16, 24))
    by_artist = {"a": [img, img[:20]]}
    assert tdata.get_rescale_dims(by_artist, 2) == jdata.get_rescale_dims(by_artist, 2)


# --- inference.py --no-display's decode ------------------------------------------------


def jax_eval_images(content_dir, num_images, resize_size, seed, native: bool):
    """The JAX inference CLI's decode (its ``run_eval``, inference.py:116-157)."""
    files = [f for f in os.listdir(content_dir) if ".jpg" in f or ".JPEG" in f]
    random.Random(seed).shuffle(files)
    content = []
    if native:
        i = 0
        while len(content) < num_images and i < len(files):
            chunk = files[i : i + (num_images - len(content))]
            i += len(chunk)
            out, ok = jnative.decode_batch([os.path.join(content_dir, f) for f in chunk],
                                           resize_size, resize_size)
            content.extend(out[k] for k in range(len(chunk)) if ok[k])
    if not content:
        for fname in files:
            im = cv2.imread(os.path.join(content_dir, fname))
            if im is None:
                continue
            content.append(cv2.resize(im, (resize_size, resize_size)))
            if len(content) == num_images:
                break
    return content


@pytest.mark.parametrize("route", ["native", "cv2"])
@pytest.mark.parametrize("num_images", [3, 10])
def test_load_eval_images_matches_jax(ws, monkeypatch, route, num_images):
    set_routes(monkeypatch, route)
    if route == "native" and not jax_native_loader():
        pytest.skip("native loader unavailable")
    args = inference.build_parser().parse_args(
        ["--no-display", "--content_dir", ws["content"], "--num_images", str(num_images),
         "--resize_size", "20", "--seed", "4"])
    got = inference.load_eval_images(args)
    want = jax_eval_images(ws["content"], num_images, 20, 4, route == "native")
    assert len(got) == len(want) == min(num_images, 6)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
