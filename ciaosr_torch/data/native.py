"""The native MATLAB bicubic: a ctypes binding of the repository's
``native/bicubic.cpp`` (counterpart of ciaosr_tpu/data/native.py).

The C++ library computes what ``core/resize.imresize_np``'s numpy path
computes (the cubic kernel with a = -0.5, widened by 1/scale on a
downscale, symmetric boundaries, rows normalized, a separable apply in
float64), threaded over rows. It exports ``matlab_bicubic_resize(in, h, w,
c, out, oh, ow, scale, antialias, threads)`` on (H, W, C) float32 images
and ``ciaosr_native_version()``.

The library is built at its first use with g++ and the flags of
``native/Makefile`` into ``ciaosr_torch/_build/native-<hash>/`` (the
hash of the source, the flags and the CPU's feature flags, since
``-march=native`` builds for this CPU), compiled to a temporary name and
moved into place, so that processes building at once do not race. A
build or load failure raises, naming ``CIAOSR_NATIVE=0`` (the numpy
path); nothing falls back silently.

One thread a call by default: the thread count changes no bit, and on
the images the pipelines resize (up to DIV2K's 2K pictures) more threads
were no faster, and slower where starting threads is slow (``PERF.md``
§6, PR 27).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "bicubic.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[1] / "_build"
# native/Makefile's: CXXFLAGS, then -shared ... -lpthread
CXXFLAGS = ("-O3", "-march=native", "-ffast-math", "-fPIC", "-std=c++17")

_lib: ctypes.CDLL | None = None
_lock = threading.Lock()


def _cpu_flags() -> str:
    """The CPU's feature flags (Linux), else its platform name."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    return line
    except OSError:
        pass
    return platform.machine() + platform.processor()


def library_path() -> Path:
    """Where the library of this source, these flags and this CPU is
    built."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXXFLAGS).encode())
    h.update(_cpu_flags().encode())
    return BUILD_ROOT / f"native-{h.hexdigest()[:16]}" / "libciaosr_native.so"


def _fail(what: str) -> RuntimeError:
    return RuntimeError(f"native MATLAB bicubic: {what}; set CIAOSR_NATIVE=0 "
                        "to resize with the numpy path")


def build() -> Path:
    """Compile the library unless it is built; returns its path."""
    path = library_path()
    if path.exists():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    try:
        proc = subprocess.run(["g++", *CXXFLAGS, "-shared", "-o", str(tmp),
                               str(SOURCE), "-lpthread"],
                              capture_output=True, text=True)
    except OSError as e:
        raise _fail(f"cannot run g++ ({e})") from e
    if proc.returncode:
        raise _fail(f"g++ failed:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)
    return path


def load() -> ctypes.CDLL:
    """The loaded library, built at the first call."""
    global _lib
    with _lock:
        if _lib is None:
            try:
                lib = ctypes.CDLL(str(build()))
            except OSError as e:
                raise _fail(f"cannot load the library ({e})") from e
            lib.matlab_bicubic_resize.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
                ctypes.c_int, ctypes.c_double, ctypes.c_int, ctypes.c_int]
            lib.matlab_bicubic_resize.restype = None
            lib.ciaosr_native_version.restype = ctypes.c_int
            if lib.ciaosr_native_version() < 1:
                raise _fail("the library's version is below 1")
            _lib = lib
    return _lib


def bicubic_resize(img: np.ndarray, out_h: int, out_w: int, scale: float,
                   antialiasing: bool = True,
                   n_threads: int = 1) -> np.ndarray:
    """MATLAB bicubic of an (H, W, C) image (cast to float32) to
    (out_h, out_w, C) float32 at ``scale``, on ``n_threads`` threads."""
    lib = load()
    img = np.ascontiguousarray(img, dtype=np.float32)
    h, w, c = img.shape
    out = np.empty((out_h, out_w, c), np.float32)
    lib.matlab_bicubic_resize(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), h, w, c,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), out_h, out_w,
        float(scale), int(antialiasing), int(n_threads))
    return out
