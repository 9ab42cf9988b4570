"""Build and load the port's CUDA kernels (``csrc/*.cu`` -> ``build/libast_kernels.so``).

The sources have a plain C interface, bound with ``ctypes`` (no PyTorch headers,
so a build takes seconds): one ``nvcc`` a source, all started together, then one
link into a shared library. The build runs at first use and again whenever the hash of the
sources, their headers (``csrc/*.cuh``) and the flags changes; the library
lands in ``build/`` at the root of the checkout, which git ignores. Without ``nvcc`` the build raises: there is
no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
import time

PACKAGE_DIR = pathlib.Path(__file__).resolve().parents[2]
SOURCE_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build"
LIB_NAME = "libast_kernels.so"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "--ptxas-options=-v")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
last_build: dict | None = None  # {"seconds", "log", "built"} of this process's build step


def _sources() -> list[pathlib.Path]:
    return sorted(SOURCE_DIR.glob("*.cu"))


def source_hash() -> str:
    """Hash of the flags, the compiled sources and the headers they include."""
    h = hashlib.sha256(" ".join((*NVCC_FLAGS, "-shared")).encode())
    for src in sorted(_sources() + list(SOURCE_DIR.glob("*.cuh"))):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = [shutil.which("nvcc")]
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")


def build() -> pathlib.Path:
    """Compile the kernels unless an up-to-date library exists; return its path."""
    global last_build
    digest = source_hash()
    lib_path = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    if lib_path.exists() and stamp.exists() and stamp.read_text().strip() == digest:
        last_build = {"seconds": 0.0, "log": "", "built": False}
        return lib_path
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        # One nvcc a source, all running at once; each object holds its own device code.
        jobs = []
        for src in _sources():
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", os.path.join(tmp, src.stem + ".o"), str(src)]
            jobs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                               stderr=subprocess.STDOUT, text=True)))
        log = ""
        for cmd, proc in jobs:
            out = proc.communicate()[0]
            log += out
            if proc.returncode != 0:
                for _, other in jobs:
                    other.kill()
                    other.wait()
                raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}")
        so = os.path.join(tmp, LIB_NAME)
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", so,
               *(os.path.join(tmp, src.stem + ".o") for src in _sources())]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
            )
        os.replace(so, lib_path)
    stamp.write_text(digest + "\n")
    last_build = {
        "seconds": time.perf_counter() - t0,
        "log": log + proc.stdout + proc.stderr,
        "built": True,
    }
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed, with its signatures set."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.ast_gram.argtypes = [p, p, p, p, i, i, i, i, i, i, i, ctypes.c_float, p]
            lib.ast_gram.restype = i
            lib.ast_qconv.argtypes = [p, p, p] + [i] * 14 + [p, p, p, p]
            lib.ast_qconv.restype = i
            lib.ast_error_string.argtypes = [i]
            lib.ast_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(code: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error code."""
    if code != 0:
        msg = library().ast_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
