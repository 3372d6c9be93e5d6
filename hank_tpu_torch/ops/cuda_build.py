"""Build and load the hand-written CUDA kernels at first use.

Each source under `csrc/` is compiled by nvcc for Hopper (`sm_90a`) into a
shared library with a plain C interface, under `hank_tpu_torch/_build/`
(git-ignored):
  - `household_sweep.cu`: the one-asset sweep (kernels 1-4): kernel 1,
    kernels 2-4 and the f64 tangent sweep (single-path and path-batched
    entry points of one kernel template with kernel 1's design), the
    previous kernels they are held to (`_previous` entry points); and the
    forward distribution scan (kernel 7) with its previous kernel;
  - `household_sweep2.cu`: the two-asset sweep (kernels 5-6, single-path
    and path-batched entry points, and the previous kernels 5 and 6 that
    they are held to);
  - `household_sweep2_f64.cu`: the two-asset full-precision residual
    (kernels 5-6's designs in FP64, values only, single-path and
    path-batched) and the same kernels' tangent instantiations (the f64
    directions, single-path and path-batched), built with
    `-fmad=false` (`EXTRA_FLAGS`): each product and sum rounds on its own,
    as the plain f64 pipeline's elementwise operations do;
  - `household_sweep_cluster.cu`: the one-asset sweeps on one thread-block
    cluster per path, each income row's state in its own block's shared
    memory (in kernel 1's, the f64 tangent sweep's, kernel 2's and kernels
    3-4's places on the grids past one block; single path and batched).
The libraries are keyed by the SHA-256 of the sources and the flags, so an
edited source rebuilds; a build runs one nvcc per source, all started
together. The libraries are loaded with ctypes. Nothing here runs at
import: the CPU tests import every module, and the CPU has no nvcc.

`check_fit(need_bytes, what)` is the one shared-memory rule: ValueError
when a kernel needs more than one block has. The wrappers apply it at each
launch; the kernel maps apply it, with the library's own count
(`sweep_smem_bytes` / `sweep2_smem_bytes` / `sweep2_f64_smem_bytes`), when
they are built on the card, so a grid past a kernel's limit stops a solve
before it starts. A one-asset kernel whose count does not fit gives way,
by that count and before any launch, to its cluster instantiation
(`CLUSTER`) where that one's count fits a block and the card holds such a
cluster (`max_clusters`), both at the single path's cluster size
`cluster_of(n_e)`, else to its global-state instantiation (`GLOBAL_STATE`;
`ops/fused_sweep.sweep_kernel`), and the rule applies to that one's count.

`python -m hank_tpu_torch.ops.cuda_build SOURCE.cu ...` compiles each
source with the same flags into a temporary directory and prints, per
kernel, the registers and spill bytes ptxas reports, as JSON lines.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIBRARIES = ("household_sweep", "household_sweep2", "household_sweep2_f64",
             "household_sweep_cluster")
SOURCES = {name: os.path.join(_PKG, "csrc", f"{name}.cu") for name in LIBRARIES}
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# Flags of one library beyond NVCC_FLAGS.
EXTRA_FLAGS = {"household_sweep2_f64": ("-fmad=false",)}


def nvcc_flags(source: str) -> tuple:
    """NVCC_FLAGS and the source's own EXTRA_FLAGS (by file name)."""
    return NVCC_FLAGS + EXTRA_FLAGS.get(os.path.splitext(os.path.basename(source))[0], ())


@dataclasses.dataclass(frozen=True)
class BuildInfo:
    paths: dict        # library name -> shared library
    seconds: float     # nvcc wall-clock of this call (0.0 when already built)
    log: str           # nvcc's output (ptxas register/shared-memory report),
                       # kept beside each library for later calls


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


def _digest() -> str:
    h = hashlib.sha256()
    for name in LIBRARIES:
        with open(SOURCES[name], "rb") as f:
            h.update(f.read())
        h.update(" ".join(nvcc_flags(SOURCES[name])).encode())
    return h.hexdigest()[:16]


def build() -> BuildInfo:
    """Compile every kernel library unless builds of these exact sources
    exist; the missing ones compile in parallel."""
    digest = _digest()
    paths = {name: os.path.join(BUILD_DIR, f"{name}_{digest}.so") for name in LIBRARIES}
    todo = [name for name in LIBRARIES if not os.path.exists(paths[name])]
    if not todo:
        return BuildInfo(paths, 0.0, _saved_logs(paths))
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name in todo:
        tmp = f"{paths[name]}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *nvcc_flags(SOURCES[name]), "-o", tmp, SOURCES[name]]
        procs[name] = (cmd, tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                  stderr=subprocess.STDOUT, text=True))
    logs, failed = [], []
    for name, (cmd, tmp, proc) in procs.items():
        try:
            out, _ = proc.communicate(timeout=900)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
        logs.append(f"== {name}\n{out}")
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}")
        else:
            with open(f"{paths[name]}.log", "w") as f:
                f.write(out)
            os.replace(tmp, paths[name])
    if failed:
        raise RuntimeError("\n".join(failed))
    return BuildInfo(paths, time.perf_counter() - t0, "\n".join(logs))


def _saved_logs(paths: dict) -> str:
    """The nvcc output kept beside each built library (its ptxas report)."""
    logs = []
    for name, path in paths.items():
        if os.path.exists(f"{path}.log"):
            with open(f"{path}.log") as f:
                logs.append(f"== {name}\n{f.read()}")
    return "\n".join(logs)


_SIGNATURES = {
    # name: (number of pointers, of ints, of doubles) before the trailing stream
    "household_sweep": {
        "hank_sweep_jvp_f32": (16, 3, 3),
        "hank_sweep_residual_f64": (11, 3, 3),
        "hank_sweep_jvp_f32_batch": (16, 4, 3),
        "hank_sweep_residual_f64_batch": (11, 4, 3),
        "hank_sweep_residual_f64_previous": (10, 3, 3),
        "hank_sweep_jvp_f32_batch_previous": (15, 4, 3),
        "hank_sweep_residual_f64_batch_previous": (10, 4, 3),
        "hank_sweep_jvp_f64": (16, 3, 3),
        "hank_sweep_jvp_f64_previous": (15, 3, 3),
        "hank_sweep_jvp_f32_global": (17, 3, 3),
        "hank_sweep_jvp_f32_batch_global": (17, 4, 3),
        "hank_sweep_residual_f64_global": (12, 3, 3),
        "hank_sweep_residual_f64_batch_global": (12, 4, 3),
        "hank_sweep_jvp_f64_global": (17, 3, 3),
        "hank_sweep_jvp_f64_batch": (16, 4, 3),
        "hank_sweep_jvp_f64_batch_global": (17, 4, 3),
        "hank_sweep_jvp_f64_batch_previous": (15, 4, 3),
        "hank_forward_scan_f32": (10, 3, 0),
        "hank_forward_scan_f32_previous": (6, 3, 0),
    },
    "household_sweep2": {
        "hank_sweep2_policies_jvp_f32": (15, 4, 4),
        "hank_sweep2_policies_jvp_cluster_f32": (14, 5, 4),
        "hank_sweep2_forward_jvp_f32": (12, 4, 0),
        "hank_sweep2_forward_jvp_cluster_f32": (13, 5, 0),
        "hank_sweep2_policies_jvp_cluster_f32_batch": (14, 6, 4),
        "hank_sweep2_forward_jvp_cluster_f32_batch": (8, 6, 0),
        "hank_sweep2_forward_jvp_cluster_global_f32": (14, 5, 0),
        "hank_sweep2_forward_jvp_cluster_global_f32_batch": (9, 6, 0),
        "hank_sweep2_policies_jvp_cluster_untabled_f32": (14, 5, 4),
    },
    "household_sweep2_f64": {
        "hank_sweep2_policies_f64": (10, 5, 4),
        "hank_sweep2_forward_f64": (10, 5, 0),
        "hank_sweep2_policies_f64_batch": (10, 6, 4),
        "hank_sweep2_forward_f64_batch": (8, 6, 0),
        "hank_sweep2_forward_f64_global": (11, 5, 0),
        "hank_sweep2_forward_f64_global_batch": (9, 6, 0),
        "hank_sweep2_policies_f64_untabled": (10, 5, 4),
        "hank_sweep2_policies_jvp_f64": (15, 7, 4),
        "hank_sweep2_forward_jvp_f64": (14, 6, 0),
        "hank_sweep2_policies_jvp_f64_batch": (15, 7, 4),
        "hank_sweep2_forward_jvp_f64_batch": (9, 7, 0),
    },
    "household_sweep_cluster": {
        "hank_sweep_jvp_f32_cluster": (16, 3, 3),
        "hank_sweep_jvp_f64_cluster": (16, 3, 3),
        "hank_sweep_jvp_f32_batch_cluster": (16, 5, 3),
        "hank_sweep_jvp_f64_batch_cluster": (16, 5, 3),
        "hank_sweep_residual_f64_cluster": (11, 3, 3),
        "hank_sweep_residual_f64_batch_cluster": (11, 5, 3),
    },
}

# The query of each cluster library for how many clusters the card holds.
_MAX_CLUSTERS = {"household_sweep2": "hank_sweep2_max_clusters",
                 "household_sweep2_f64": "hank_sweep2_f64_max_clusters",
                 "household_sweep_cluster": "hank_sweep_cluster_max_clusters"}


@functools.cache
def load_library(name: str = "household_sweep") -> ctypes.CDLL:
    """The built kernel library `name` with its C signatures declared."""
    lib = ctypes.CDLL(build().paths[name])
    p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    for fn, (n_p, n_i, n_d) in _SIGNATURES[name].items():
        getattr(lib, fn).argtypes = [p] * n_p + [i] * n_i + [d] * n_d + [p]
        getattr(lib, fn).restype = i
    if name == "household_sweep":
        lib.hank_sweep_smem_bytes.argtypes = [i, i, i]
        lib.hank_sweep_smem_bytes.restype = ctypes.c_size_t
        lib.hank_forward_scan_smem_bytes.argtypes = [i, i, i]
        lib.hank_forward_scan_smem_bytes.restype = ctypes.c_size_t
    elif name == "household_sweep2":
        lib.hank_sweep2_smem_bytes.argtypes = [i, i, i, i, i]
        lib.hank_sweep2_smem_bytes.restype = ctypes.c_size_t
        lib.hank_sweep2_max_clusters.argtypes = [i, i, i, i, i]
        lib.hank_sweep2_max_clusters.restype = i
    elif name == "household_sweep2_f64":
        lib.hank_sweep2_f64_smem_bytes.argtypes = [i, i, i, i, i]
        lib.hank_sweep2_f64_smem_bytes.restype = ctypes.c_size_t
        lib.hank_sweep2_f64_max_clusters.argtypes = [i, i, i, i, i]
        lib.hank_sweep2_f64_max_clusters.restype = i
    else:
        lib.hank_sweep_cluster_smem_bytes.argtypes = [i, i, i, i]
        lib.hank_sweep_cluster_smem_bytes.restype = ctypes.c_size_t
        lib.hank_sweep_cluster_max_clusters.argtypes = [i, i, i, i]
        lib.hank_sweep_cluster_max_clusters.restype = i
    lib.hank_cuda_error_string.argtypes = [i]
    lib.hank_cuda_error_string.restype = ctypes.c_char_p
    return lib


# Dynamic shared memory one block may use on Hopper (227 KB).
MAX_SMEM_BYTES = 232_448


def check_fit(need: int, what: str, hint: str = "") -> None:
    """ValueError (ending in `hint`) when a kernel that needs `need` bytes of
    dynamic shared memory per block does not fit one block."""
    if need > MAX_SMEM_BYTES:
        raise ValueError(f"{what} needs {need} bytes of shared memory; "
                         f"one block has {MAX_SMEM_BYTES}{hint}")


# `which` of `hank_sweep_smem_bytes`, one per kernel of the one-asset sweep
# (`csrc/household_sweep.cu`): 0 the previous kernel 2 (the counting
# template's f64 residual build), 1 the previous kernels 1 and 3-4 (its f32
# dual build), 2 kernel 1, 3 kernels 3-4, 4 kernel 2 (the ranged kernel's f32
# dual and f64 builds), 5 the f64 tangent sweep (its f64 dual build), 6 the
# previous f64 tangent sweep (the template's f64 dual build), 7-10 the
# ranged kernel's global-state instantiations of 2-5, its state in a global
# workspace; and of
# `hank_sweep_cluster_smem_bytes` (`csrc/household_sweep_cluster.cu`,
# CLUSTER_*), per block of household_sweep_cluster_kernel's cluster: 11
# <float, true, false>, 12 <double, true, false>, 13 <float, true, true>
# (kernels 3-4's place), 14 <double, false, *> (kernel 2's, single path and
# batched). The f64 tangent sweep over B paths: 15 the ranged kernel's
# <double, true, true>, 16 its global-state instantiation and (cluster
# library) 17 <double, true, true>; the same bytes a block as 5, 10 and 12.
PREVIOUS_KERNEL2, PREVIOUS_KERNELS3_4, KERNEL1, KERNELS3_4, KERNEL2 = 0, 1, 2, 3, 4
JVP_F64, PREVIOUS_JVP_F64 = 5, 6
GLOBAL_KERNEL1, GLOBAL_KERNELS3_4, GLOBAL_KERNEL2, GLOBAL_JVP_F64 = 7, 8, 9, 10
CLUSTER_KERNEL1, CLUSTER_JVP_F64, CLUSTER_KERNELS3_4, CLUSTER_KERNEL2 = 11, 12, 13, 14
JVP_F64_BATCH, GLOBAL_JVP_F64_BATCH, CLUSTER_JVP_F64_BATCH = 15, 16, 17
# The global-state instantiation that takes a one-block kernel's place on
# the grids past its shared memory.
GLOBAL_STATE = {KERNEL1: GLOBAL_KERNEL1, KERNELS3_4: GLOBAL_KERNELS3_4,
                KERNEL2: GLOBAL_KERNEL2, JVP_F64: GLOBAL_JVP_F64,
                JVP_F64_BATCH: GLOBAL_JVP_F64_BATCH}
# The cluster instantiation that takes it first.
CLUSTER = {KERNEL1: CLUSTER_KERNEL1, JVP_F64: CLUSTER_JVP_F64,
           KERNELS3_4: CLUSTER_KERNELS3_4, KERNEL2: CLUSTER_KERNEL2,
           JVP_F64_BATCH: CLUSTER_JVP_F64_BATCH}
# The largest cluster a path takes (the portable size).
MAX_CLUSTER = 8


def cluster_of(n_e: int) -> int:
    """The cluster a single path of a one-asset cluster kernel takes: one
    block an income row, at most `MAX_CLUSTER` (`cluster_of` of
    `csrc/household_sweep_cluster.cu`)."""
    return min(n_e, MAX_CLUSTER)


def sweep_smem_bytes(which: int, n_a: int, n_e: int, cluster: int | None = None) -> int:
    """The library's count of a one-asset sweep kernel's shared memory at an
    n_a×n_e grid (`which` as above; a cluster kernel's per block, on a
    cluster of `cluster` blocks, default `cluster_of(n_e)`). Builds the
    library."""
    if which in CLUSTER.values():
        return load_library("household_sweep_cluster").hank_sweep_cluster_smem_bytes(
            which, n_a, n_e, cluster_of(n_e) if cluster is None else cluster)
    return load_library().hank_sweep_smem_bytes(which, n_a, n_e)


def sweep2_smem_bytes(which: int, n_b: int, n_a: int, n_e: int, cluster: int = 1) -> int:
    """The library's count of a two-asset kernel's shared memory per block
    (`check_shared_memory2`'s `which`). Builds the library."""
    return load_library("household_sweep2").hank_sweep2_smem_bytes(which, n_b, n_a, n_e,
                                                                   cluster)


def sweep2_f64_smem_bytes(which: int, n_b: int, n_a: int, n_e: int, cluster: int = 1) -> int:
    """The library's count of an f64 residual kernel's shared memory per
    block (`check_shared_memory2_f64`'s `which`). Builds the library."""
    return load_library("household_sweep2_f64").hank_sweep2_f64_smem_bytes(
        which, n_b, n_a, n_e, cluster)


@functools.cache
def max_clusters(name: str, which: int, *shape: int) -> int:
    """How many clusters of a kernel the card holds at once
    (cudaOccupancyMaxActiveClusters; 0: not one). Library `name`
    "household_sweep2" with which = 2 (kernel 6), 3 (kernel 5) or 4 (kernel
    6 with global lists), or "household_sweep2_f64" with which = 0
    (backward), 1 (forward) or 2 (forward with global lists), at
    `shape` = (n_b, n_a, n_e, cluster): a batched two-asset kernel at an
    n_b×n_a×n_e×2 grid on clusters of `cluster` blocks; "household_sweep_cluster"
    with which one of `CLUSTER`'s values at `shape` = (n_a, n_e[, cluster]):
    a one-asset cluster kernel on clusters of `cluster` blocks (default
    `cluster_of(n_e)`, a single path's). Builds the library."""
    if name == "household_sweep_cluster" and len(shape) == 2:
        shape = (*shape, cluster_of(shape[1]))
    lib = load_library(name)
    n = getattr(lib, _MAX_CLUSTERS[name])(which, *shape)
    if n < 0:
        raise RuntimeError(f"{name}: CUDA error {-n} asking the clusters of kernel {which}: "
                           f"{lib.hank_cuda_error_string(-n).decode()}")
    return n


def check_shared_memory_scan(lib: ctypes.CDLL, which: int, n_a: int, n_e: int) -> None:
    """The forward scan at an n_a×n_e grid: which = 0 the previous kernel 7,
    1 kernel 7."""
    check_fit(lib.hank_forward_scan_smem_bytes(which, n_a, n_e),
                f"forward scan at grid {n_a}x{n_e}")


def check_shared_memory2(lib: ctypes.CDLL, which: int, n_b: int, n_a: int, n_e: int,
                         cluster: int = 1) -> None:
    """At an n_b×n_a×n_e×2 grid: the previous kernel 5 (which = 0), the
    previous kernel 6 (which = 1), or kernel 6 (which = 2), kernel 5 (which =
    3), kernel 6 with its lists in global memory (which = 4) or kernel 5
    untabled (which = 5) on a cluster of `cluster` blocks (the shared memory
    of each block)."""
    what = ("previous kernel 5", "previous kernel 6", f"kernel 6 on a cluster of {cluster}",
            f"kernel 5 on a cluster of {cluster}",
            f"kernel 6 with global lists on a cluster of {cluster}",
            f"kernel 5 untabled on a cluster of {cluster}")[which]
    check_fit(lib.hank_sweep2_smem_bytes(which, n_b, n_a, n_e, cluster),
                f"{what} at grid {n_b}x{n_a}x{n_e}x2")


def check_shared_memory2_f64(lib: ctypes.CDLL, which: int, n_b: int, n_a: int, n_e: int,
                             cluster: int) -> None:
    """At an n_b×n_a×n_e×2 grid, on a cluster of `cluster` blocks: the f64
    backward recursion (which = 0), the f64 forward push (which = 1), the
    forward push with global lists (which = 2) or the backward recursion
    untabled (which = 3); the tangent pair's backward recursion (4), forward
    push (5), forward push with global lists (6), backward recursion
    untabled (7), with its tangent state in the workspace (8) and that one
    untabled (9)."""
    what = ("the f64 backward recursion", "the f64 forward push",
            "the f64 forward push with global lists",
            "the f64 backward recursion untabled",
            "the f64 tangent backward recursion", "the f64 tangent forward push",
            "the f64 tangent forward push with global lists",
            "the f64 tangent backward recursion untabled",
            "the f64 tangent backward recursion with global tangent state",
            "the f64 tangent backward recursion with global tangent state, untabled")[which]
    check_fit(lib.hank_sweep2_f64_smem_bytes(which, n_b, n_a, n_e, cluster),
              f"{what} on a cluster of {cluster} at grid {n_b}x{n_a}x{n_e}x2")


def check_launch(lib: ctypes.CDLL, err: int, name: str) -> None:
    """Raise if the launcher reported a CUDA error (refused launch, bad
    attribute): such a launch never ran and a later synchronize would not
    report it."""
    if err != 0:
        msg = lib.hank_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} at launch: {msg}")


def ptxas_report(log: str) -> list[dict]:
    """Per kernel of an `nvcc -Xptxas -v` log: its mangled name, registers
    and spill-store and spill-load bytes."""
    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = {"kernel": m.group(1)}
            out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    return out


def main(argv: list[str]) -> int:
    for src in argv:
        with tempfile.TemporaryDirectory() as tmp:
            cmd = [_nvcc(), *nvcc_flags(src), "-o", os.path.join(tmp, "k.so"), src]
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        print(json.dumps({"source": src, "kernels": ptxas_report(proc.stdout + proc.stderr)}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
