"""ctypes bindings of the native C++ dual-number benchmark library (port of
`hank_tpu/utils/native.py`).

Hand-rolled dual numbers with chunked forward-mode gradient drivers on the
ackley / rosenbrock test functions (SURVEY §2.9), which calibrate the AD
engine against native code. The library is built from `native/` as it
stands (`bench_native.cpp`, `dual.hpp`) with g++ and the flags of
`native/Makefile`, into the git-ignored `hank_tpu_torch/_build/`, keyed by
the sources' hash; nothing is written into `native/`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_DIR = os.path.join(os.path.dirname(_PKG), "native")
SOURCES = tuple(os.path.join(NATIVE_DIR, f) for f in ("bench_native.cpp", "dual.hpp"))
BUILD_DIR = os.path.join(_PKG, "_build")
FLAGS = ("-std=c++17", "-O3", "-march=native", "-fPIC", "-shared")
CHUNKS = (1, 4, 8)
FUNCTIONS = ("ackley", "rosenbrock")


def library_path() -> str:
    """Where the build of the present sources lives."""
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for path in SOURCES:
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libhank_native_{h.hexdigest()[:16]}.so")


def _build(path: str) -> None:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found (set CXX): the native library is built from source")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    proc = subprocess.run([cxx, *FLAGS, SOURCES[0], "-o", tmp], capture_output=True,
                          text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, path)


@functools.cache
def load() -> ctypes.CDLL:
    """The native library (built on first use), its C signatures declared."""
    path = library_path()
    if not os.path.exists(path):
        _build(path)
    lib = ctypes.CDLL(path)
    dp = ctypes.POINTER(ctypes.c_double)
    for name in FUNCTIONS:
        for chunk in CHUNKS:
            f = getattr(lib, f"{name}_grad_chunk{chunk}")
            f.argtypes = [dp, dp, ctypes.c_int]
            f.restype = None
        v = getattr(lib, f"{name}_value")
        v.argtypes = [dp, ctypes.c_int]
        v.restype = ctypes.c_double
    lib.bench_gradient.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.bench_gradient.restype = ctypes.c_double
    return lib


def _check(which: str, chunk: int | None = None) -> None:
    if which not in FUNCTIONS:
        raise ValueError(f"which must be one of {FUNCTIONS}, got {which!r}")
    if chunk is not None and chunk not in CHUNKS:
        raise ValueError(f"chunk must be one of {CHUNKS}, got {chunk!r}")


def gradient(which: str, x: np.ndarray, chunk: int = 8) -> np.ndarray:
    """Native chunked forward-mode gradient of ackley/rosenbrock at x."""
    _check(which, chunk)
    lib = load()
    x = np.ascontiguousarray(x, dtype=np.float64).ravel()
    g = np.zeros_like(x)
    dp = ctypes.POINTER(ctypes.c_double)
    getattr(lib, f"{which}_grad_chunk{chunk}")(x.ctypes.data_as(dp), g.ctypes.data_as(dp), len(x))
    return g


def value(which: str, x: np.ndarray) -> float:
    """Native value of ackley/rosenbrock at x."""
    _check(which)
    lib = load()
    x = np.ascontiguousarray(x, dtype=np.float64).ravel()
    dp = ctypes.POINTER(ctypes.c_double)
    return float(getattr(lib, f"{which}_value")(x.ctypes.data_as(dp), len(x)))


def bench(which: str = "rosenbrock", chunk: int = 8, n: int = 1000, iters: int = 1000) -> float:
    """Seconds per native gradient evaluation."""
    _check(which, chunk)
    return float(load().bench_gradient(which.encode(), chunk, n, iters))
