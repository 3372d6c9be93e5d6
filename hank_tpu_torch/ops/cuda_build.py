"""Build and load the hand-written CUDA kernels at first use.

`csrc/household_sweep.cu` is compiled by nvcc for Hopper (`sm_90a`) into a
shared library with a plain C interface, under `hank_tpu_torch/_build/`
(git-ignored), keyed by the SHA-256 of the source so an edited source
rebuilds. The library is loaded with ctypes. Nothing here runs at import:
the CPU tests import every module, and the CPU has no nvcc.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "household_sweep.cu")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class BuildInfo:
    path: str          # the shared library
    seconds: float     # nvcc wall-clock of this call (0.0 when already built)
    log: str           # nvcc's output (ptxas register/shared-memory report)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME): the household-sweep "
                       "kernels are built from source at first use")


def build() -> BuildInfo:
    """Compile the kernel library unless a build of this exact source exists."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    path = os.path.join(BUILD_DIR, f"household_sweep_{digest}.so")
    if os.path.exists(path):
        return BuildInfo(path, 0.0, "")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{log}")
    os.replace(tmp, path)
    return BuildInfo(path, seconds, log)


@functools.cache
def load_library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    lib = ctypes.CDLL(build().path)
    p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.hank_sweep_jvp_f32.argtypes = [p] * 15 + [i] * 3 + [d] * 3 + [p]
    lib.hank_sweep_jvp_f32.restype = i
    lib.hank_sweep_residual_f64.argtypes = [p] * 10 + [i] * 3 + [d] * 3 + [p]
    lib.hank_sweep_residual_f64.restype = i
    lib.hank_sweep_smem_bytes.argtypes = [i, i, i]
    lib.hank_sweep_smem_bytes.restype = ctypes.c_size_t
    lib.hank_cuda_error_string.argtypes = [i]
    lib.hank_cuda_error_string.restype = ctypes.c_char_p
    return lib


# Dynamic shared memory one block may use on Hopper (227 KB).
MAX_SMEM_BYTES = 232_448


def check_shared_memory(lib: ctypes.CDLL, tangent: bool, n_a: int, n_e: int) -> None:
    need = lib.hank_sweep_smem_bytes(int(tangent), n_a, n_e)
    if need > MAX_SMEM_BYTES:
        raise ValueError(f"grid {n_a}x{n_e} needs {need} bytes of shared memory; "
                         f"one block has {MAX_SMEM_BYTES}")


def check_launch(lib: ctypes.CDLL, err: int, name: str) -> None:
    """Raise if the launcher reported a CUDA error (refused launch, bad
    attribute): such a launch never ran and a later synchronize would not
    report it."""
    if err != 0:
        msg = lib.hank_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} at launch: {msg}")
