"""Import hygiene of the PyTorch port, and its PNG reader against OpenCV.

The port, ``chip_smoke.py`` and the bench scripts (``bench_gram.py``, ``bench_qconv.py``,
``bench_launch.py``) must import neither JAX nor the JAX package, and name no path under
the JAX side's ``native/`` or ``artist_style_transfer_tpu/``.
The check is a static ``ast`` scan of the source, so a ``sitecustomize``
that pre-imports JAX cannot hide an import. ``artist_style_transfer_tpu_torch``
starts with the JAX package's name, so a module counts only when it *is*
``jax`` / ``artist_style_transfer_tpu`` or has one of them as a dotted prefix.

The PNG reader exists because the card's machine has neither OpenCV nor
PIL; it must give exactly what ``cv2.imread`` gives.
"""

import ast
import os
import pathlib
import re
import struct
import zlib

import numpy as np
import pytest

from artist_style_transfer_tpu_torch.utils.images import read_png
from tests.test_torch_data import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "artist_style_transfer_tpu_torch"
FORBIDDEN = ("jax", "artist_style_transfer_tpu")


def is_forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def imported_modules(path: pathlib.Path) -> list[str]:
    """Absolute module names imported anywhere in a file (top level or in a function)."""
    mods = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            mods += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            mods.append(node.module)
            mods += [f"{node.module}.{a.name}" for a in node.names]
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant) and isinstance(node.args[0].value, str)
              and ((isinstance(node.func, ast.Name) and node.func.id == "__import__")
                   or (isinstance(node.func, ast.Attribute) and node.func.attr == "import_module"))):
            mods.append(node.args[0].value)
    return mods


def port_files() -> list[pathlib.Path]:
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "bench_gram.py",
                                          ROOT / "bench_qconv.py", ROOT / "bench_launch.py"]


@pytest.mark.parametrize(
    "module,bad",
    [
        ("jax", True), ("jax.numpy", True), ("artist_style_transfer_tpu", True),
        ("artist_style_transfer_tpu.ops.gram", True), ("jaxlib", False),
        ("artist_style_transfer_tpu_torch", False), ("artist_style_transfer_tpu_torch.ops", False),
        ("torch", False),
    ],
)
def test_forbidden_matches_whole_names_only(module, bad):
    assert is_forbidden(module) is bad


def test_scanner_sees_every_import_form(tmp_path):
    src = tmp_path / "m.py"
    src.write_text(
        "import os, jax.numpy as jnp\n"
        "from artist_style_transfer_tpu.ops import gram\n"
        "def f():\n"
        "    from artist_style_transfer_tpu import ops\n"
        "    import importlib\n"
        "    importlib.import_module('jax')\n"
        "    __import__('artist_style_transfer_tpu.models')\n"
        "from . import sibling\n"
    )
    bad = sorted({m for m in imported_modules(src) if is_forbidden(m)})
    assert bad == [
        "artist_style_transfer_tpu", "artist_style_transfer_tpu.models",
        "artist_style_transfer_tpu.ops", "artist_style_transfer_tpu.ops.gram", "jax", "jax.numpy",
    ]


def test_port_and_chip_smoke_import_no_jax():
    files = port_files()
    assert len(files) > 20 and ROOT / "chip_smoke.py" in files and ROOT / "bench_gram.py" in files
    offenders = {
        str(p.relative_to(ROOT)): bad
        for p in files
        if (bad := [m for m in imported_modules(p) if is_forbidden(m)])
    }
    assert offenders == {}


JAX_DIRS = ("native", "artist_style_transfer_tpu")
PATH_CALLS = ("join", "joinpath", "Path", "PurePath", "open")
# "artist_style_transfer_tpu/models/transformer_q.py:62": a citation of a JAX line
# (what a port kernel replaces), not a path that is read.
JAX_LINE = re.compile(r"artist_style_transfer_tpu/[\w/]+\.py:\d+")
JAX_PATH = re.compile(r"(^|[^\w])(native|artist_style_transfer_tpu)/")


def jax_paths(path: pathlib.Path) -> list[tuple[int, str]]:
    """(line, text) of every path under ``native/`` or ``artist_style_transfer_tpu/``
    that a file names in code: a string holding such a path, or ``"native"`` /
    ``"artist_style_transfer_tpu"`` joined into a path (``/`` on a ``Path``,
    ``os.path.join``, ``Path(...)``, ``open``). Docstrings, comments and citations of
    a JAX line (``file.py:N``) are not paths."""
    tree = ast.parse(path.read_text(), filename=str(path))
    docs = {id(n.value) for n in ast.walk(tree)
            if isinstance(n, ast.Expr) and isinstance(n.value, ast.Constant)}
    found = []
    for node in ast.walk(tree):
        if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                and id(node) not in docs and JAX_PATH.search(JAX_LINE.sub("", node.value))):
            found.append((node.lineno, node.value))
        parts = []
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Div):
            parts = [node.left, node.right]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", None)) in PATH_CALLS:
            parts = node.args
        found += [(p.lineno, p.value) for p in parts
                  if isinstance(p, ast.Constant) and p.value in JAX_DIRS]
    return found


@pytest.mark.parametrize(
    "code,bad",
    [
        ('SOURCE = REPO_ROOT / "native" / "dataloader.cpp"\n', True),
        ('p = os.path.join(ROOT, "native", "dataloader.cpp")\n', True),
        ('p = pathlib.Path("artist_style_transfer_tpu", "ops")\n', True),
        ('p = ROOT.joinpath("artist_style_transfer_tpu")\n', True),
        ('p = "native/Makefile"\n', True),
        ('p = f"{ROOT}/artist_style_transfer_tpu/ops/gram.py"\n', True),
        ('"""Builds native/dataloader.cpp (artist_style_transfer_tpu/data/x.py)."""\n', False),
        ('x = 1  # native/Makefile\n', False),
        ('R = "artist_style_transfer_tpu/ops/pallas/gram_kernel.py:60"\n', False),
        ('route = "native" if ok else "cv2"\n', False),
        ('SOURCE = PACKAGE_DIR / "csrc" / "dataloader.cpp"\n', False),
    ],
)
def test_path_scanner(tmp_path, code, bad):
    src = tmp_path / "m.py"
    src.write_text(code)
    assert bool(jax_paths(src)) is bad


def test_port_names_no_path_of_the_jax_side():
    """The port, ``chip_smoke.py`` and the bench scripts read no file under ``native/``
    or ``artist_style_transfer_tpu/``: the port keeps its own copy of what it needs."""
    offenders = {str(p.relative_to(ROOT)): found for p in port_files() if (found := jax_paths(p))}
    assert offenders == {}


def test_decode_pool_source_is_the_ports_own():
    """The native decode pool builds the port's copy of the C++ source, which is the JAX
    package's ``native/dataloader.cpp`` byte for byte (both pools decode alike)."""
    from artist_style_transfer_tpu_torch.data import native_loader

    source = native_loader.SOURCE.resolve()
    assert source == PORT / "csrc" / "dataloader.cpp" and source.is_relative_to(PORT)
    assert source.read_bytes() == (ROOT / "native" / "dataloader.cpp").read_bytes()


PARALLEL = ("__init__", "distributed", "launch", "mesh", "spatial", "workers")


@pytest.mark.parametrize("name", PARALLEL)
def test_parallel_modules_are_scanned_and_import_no_jax(name):
    """``parallel/`` (the process group, the launcher, the rank functions a spawned child
    imports, the row bands) is part of the scan, and imports neither JAX nor the JAX
    package."""
    path = PORT / "parallel" / f"{name}.py"
    assert path in port_files()
    assert [m for m in imported_modules(path) if is_forbidden(m)] == []


# --- the PNG reader -----------------------------------------------------------------


@pytest.mark.parametrize("name", ["content_landscape_256.png", "golden_stylized.png"])
def test_read_png_matches_cv2_on_goldens(name):
    cv2 = pytest.importorskip("cv2")
    path = os.path.join(ROOT, "tests", "goldens", name)
    ref = cv2.imread(path)
    got = read_png(path)
    assert got.dtype == np.uint8 and got.shape == ref.shape == (172, 256, 3)
    np.testing.assert_array_equal(got, ref)


def _filter_row(ftype: int, row: np.ndarray, prev: np.ndarray, bpp: int) -> bytes:
    """Encode one scanline with PNG filter ``ftype`` (spec section 9.2)."""
    x = row.astype(np.int64)
    up = prev.astype(np.int64)
    left = np.concatenate([np.zeros(bpp, np.int64), x[:-bpp]])
    upleft = np.concatenate([np.zeros(bpp, np.int64), up[:-bpp]])
    if ftype == 0:
        pred = np.zeros_like(x)
    elif ftype == 1:
        pred = left
    elif ftype == 2:
        pred = up
    elif ftype == 3:
        pred = (left + up) >> 1
    else:
        p = left + up - upleft
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
        pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    return bytes([ftype]) + ((x - pred) % 256).astype(np.uint8).tobytes()


def _write_png(path, rgb_or_rgba: np.ndarray, filters: list[int]) -> None:
    h, w, ch = rgb_or_rgba.shape
    rows = rgb_or_rgba.reshape(h, w * ch)
    raw = b"".join(
        _filter_row(filters[y % len(filters)], rows[y],
                    rows[y - 1] if y else np.zeros(w * ch, np.uint8), ch)
        for y in range(h)
    )

    def chunk(kind: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body) & 0xFFFFFFFF)

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2 if ch == 3 else 6, 0, 0, 0)
    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
                 + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [3, 4])
@pytest.mark.parametrize("filters", [[0], [1], [2], [3], [4], [0, 1, 2, 3, 4]])
def test_read_png_every_filter_matches_cv2(tmp_path, channels, filters):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(channels * 10 + len(filters) + filters[0])
    img = rng.integers(0, 256, (9, 13, channels), dtype=np.uint8)
    path = str(tmp_path / "f.png")
    _write_png(path, img, filters)
    got = read_png(path)
    np.testing.assert_array_equal(got, img[..., 2::-1])  # RGB(A) -> BGR, alpha dropped
    np.testing.assert_array_equal(got, cv2.imread(path))


@pytest.mark.parametrize("batched", [False, True])
def test_to_image_and_save_match_jax(tmp_path, batched):
    pytest.importorskip("cv2")
    from artist_style_transfer_tpu.utils import images as jimages
    from artist_style_transfer_tpu_torch.utils import images as timages

    img = np.random.default_rng(8).uniform(-30, 290, (6, 7, 3)).astype(np.float32)
    if batched:
        img = img[None]
    np.testing.assert_array_equal(timages.to_image(img), jimages.to_image(img))
    ours, theirs = str(tmp_path / "a" / "ours.png"), str(tmp_path / "theirs.png")
    timages.save_tensor_image(ours, img)
    jimages.save_tensor_image(theirs, img)
    np.testing.assert_array_equal(read_png(ours), read_png(theirs))


def test_read_png_refuses_what_it_cannot_decode(tmp_path):
    path = tmp_path / "grey.png"
    ihdr = struct.pack(">IIBBBBB", 2, 2, 8, 0, 0, 0, 0)
    body = b"IHDR" + ihdr
    path.write_bytes(b"\x89PNG\r\n\x1a\n" + struct.pack(">I", len(ihdr)) + body
                     + struct.pack(">I", zlib.crc32(body)))
    with pytest.raises(ValueError, match="colour type 0"):
        read_png(str(path))
    (tmp_path / "x.png").write_bytes(b"not a png")
    with pytest.raises(ValueError, match="not a PNG"):
        read_png(str(tmp_path / "x.png"))
