"""ctypes binding of the native JPEG decode + resample thread pool (the port's own
copy of the JAX ``data/native_loader.py``).

``native/dataloader.cpp`` (C++ over libjpeg, a std::thread pool) is compiled at
first use with the flags of ``native/Makefile`` into ``build/`` at the root of the
checkout, which git ignores; ``native/`` is only read. The library's name carries
a hash of the source, the flags and the host (:func:`host_key`: the machine and
its CPU's flags, since ``-march=native`` builds for this CPU), so a changed
source builds anew, and a library that another host built, which travels with
a copied ``build/``, is never loaded: this host builds its own.

- :func:`decode_batch`: parallel decode + resample of JPEG paths into one
  float32 NHWC BGR buffer (the reference decodes serially through cv2.imread,
  dataset.py:93-101);
- :func:`resample`: one image (parity tests).

:func:`available` is False where the library cannot be built or loaded (no
``g++``, no libjpeg); callers then decode with OpenCV. ``load_error`` says why.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import platform
import subprocess
import tempfile
import threading

import numpy as np

REPO_ROOT = pathlib.Path(__file__).resolve().parents[2]
SOURCE = REPO_ROOT / "native" / "dataloader.cpp"
BUILD_DIR = REPO_ROOT / "build"
# native/Makefile's CXX, CXXFLAGS and LDFLAGS.
CXX = "g++"
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall")
LDFLAGS = ("-shared", "-ljpeg", "-lpthread")

MODE_RESIZE = 0  # cv2.resize INTER_LINEAR semantics
MODE_RESCALE = 1  # the reference's affine rescale (dataset.py:36-52)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False
load_error: str | None = None  # why the library is unavailable, once a load was tried


def host_key() -> str:
    """The machine and its CPU's feature flags (``/proc/cpuinfo``; the processor's name
    where that file is missing): what ``-march=native`` compiles for."""
    flags = ""
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                key, _, value = line.partition(":")
                if key.strip() in ("flags", "Features"):  # x86, arm
                    flags = value.strip()
                    break
    except OSError:
        flags = platform.processor()
    return f"{platform.machine()} {flags}"


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join((CXX, *CXXFLAGS, *LDFLAGS)).encode())
    h.update(SOURCE.read_bytes())
    h.update(host_key().encode())
    return BUILD_DIR / f"libastloader-{h.hexdigest()[:16]}.so"


def _build(lib_path: pathlib.Path) -> None:
    """Compile into a temporary file, then rename: a concurrent build never sees half a file."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([CXX, *CXXFLAGS, str(SOURCE), "-o", tmp, *LDFLAGS],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise OSError(f"{CXX} failed ({proc.returncode}): {proc.stderr.strip()[-400:]}")
        os.replace(tmp, lib_path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load() -> ctypes.CDLL | None:
    global _lib, _tried, load_error
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            lib_path = library_path()
            if not lib_path.exists():
                _build(lib_path)
            lib = ctypes.CDLL(str(lib_path))
        except OSError as e:  # no compiler, no libjpeg, a library that does not load
            load_error = str(e)
            return None
        p, i = ctypes.POINTER, ctypes.c_int
        lib.ast_decode_batch.restype = i
        lib.ast_decode_batch.argtypes = [p(ctypes.c_char_p), i, p(ctypes.c_float), i, i, i,
                                         p(ctypes.c_ubyte), i]
        lib.ast_resample.restype = None
        lib.ast_resample.argtypes = [p(ctypes.c_ubyte), i, i, p(ctypes.c_float), i, i, i]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def decode_batch(
    paths: list[str],
    height: int,
    width: int,
    mode: int = MODE_RESIZE,
    num_threads: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Decode + resample JPEGs in parallel -> ((N, H, W, 3) f32 BGR, (N,) bool ok mask).

    A file that fails to decode gives ok False and a zero image.
    ``num_threads=0`` lets the library take one thread a core.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native loader unavailable: {load_error}")
    n = len(paths)
    out = np.zeros((n, height, width, 3), np.float32)
    ok = np.zeros((n,), np.uint8)
    arr = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    lib.ast_decode_batch(arr, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), height,
                         width, mode, ok.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
                         num_threads)
    return out, ok.astype(bool)


def resample(image_bgr_u8: np.ndarray, height: int, width: int,
             mode: int = MODE_RESIZE) -> np.ndarray:
    """Resample one HWC BGR uint8 image -> (H, W, 3) f32."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native loader unavailable: {load_error}")
    src = np.ascontiguousarray(image_bgr_u8, np.uint8)
    out = np.zeros((height, width, 3), np.float32)
    lib.ast_resample(src.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), src.shape[0],
                     src.shape[1], out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), height,
                     width, mode)
    return out
