"""Kernel 7 with and without its source ranges held in registers, on the card.

    python -m hank_tpu_torch.tools.scan_owned_ab [--reps N] [--out FILE]

Builds `csrc/household_sweep.cu` with the library's nvcc flags twice, both
nvccs started together: as shipped, where each thread's first `kMaxOwned`
= 4 destinations take their source ranges from registers loaded a period
ahead and the destinations past 4 × 1024 read theirs in a second loop; and
with `-DHANK_SCAN_OWNED=0`, one loop in which every destination reads its
range from global memory in its own period. Then, at three seeded inputs
(a Krusell-Smith-like savings policy on a double-exponential grid, with
the borrowing limit's pile at g_0, and a Rouwenhorst income chain):
200×7 over 299 periods and 500×7 over 149 (the shapes `chip_smoke.py`
phase 9 times) and 1000×7 over 149 (7000 cells, where the second loop
runs), it
  - checks both builds' kernel 7 (`hank_forward_scan_f32`) bit for bit
    against each other and against the previous kernel 7;
  - times the two in turns (shipped, one loop, one loop, shipped), each
    turn the median of `--reps` event-timed launches.
Every line is a JSON object. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

from hank_tpu_torch.tools.kernel6_split import emit, event_ms

SHAPES = ((299, 200, 7), (149, 500, 7), (149, 1000, 7))


def start_one_loop_build(tmp: str) -> tuple:
    """nvcc of the one-asset library with `-DHANK_SCAN_OWNED=0`, started."""
    from hank_tpu_torch.ops import cuda_build

    path = os.path.join(tmp, "household_sweep_one_loop.so")
    proc = subprocess.Popen([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-DHANK_SCAN_OWNED=0",
                             "-o", path, cuda_build.SOURCES["household_sweep"]],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, path


def load_scan(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.hank_forward_scan_f32.argtypes = [p] * 10 + [i] * 3 + [p]
    lib.hank_forward_scan_f32.restype = i
    lib.hank_cuda_error_string.argtypes = [i]
    lib.hank_cuda_error_string.restype = ctypes.c_char_p
    return lib


def scan_input(T: int, n_a: int, n_e: int, seed: int, dev):
    """(policies (T, n_a, n_e), D0, grid, Pi) in f32 on `dev`."""
    import numpy as np
    import torch

    from hank_tpu_torch.model.grids import make_double_exponential_grid, rouwenhorst

    rng = np.random.default_rng(seed)
    grid = np.asarray(make_double_exponential_grid(0.0, 200.0, n_a))
    Pi, _, z = rouwenhorst(n_e, 0.966, 0.283)
    wave = 0.05 * np.sin(2 * np.pi * np.arange(T) / T)
    pols = (0.98 * (1.01 * grid[None, :, None] + 1.2 * np.asarray(z)[None, None, :])
            - 1.0 + wave[:, None, None])
    D0 = np.exp(-grid / 20.0)[:, None] * (1.0 + 1e-3 * rng.random((n_a, n_e)))
    D0 /= D0.sum()
    return tuple(torch.tensor(np.asarray(a), dtype=torch.float32, device=dev).contiguous()
                 for a in (pols, D0, grid, Pi))


def make_call(lib, pols, D0, grid, Pi):
    """A launch of `lib`'s kernel 7 into buffers of its own; returns
    (call, outputs)."""
    import torch

    from hank_tpu_torch.ops import cuda_build

    T, n_a, n_e = pols.shape
    dev = pols.device
    agg = torch.empty(T, dtype=torch.float32, device=dev)
    D_T = torch.empty((n_a, n_e), dtype=torch.float32, device=dev)
    Pc = torch.empty((T, n_e, n_a), dtype=torch.float32, device=dev)
    ranges = torch.empty((T, n_e, n_a), dtype=torch.int32, device=dev)
    D_hist = torch.empty((T, n_e, n_a), dtype=torch.float32, device=dev)

    def call():
        err = lib.hank_forward_scan_f32(
            pols.data_ptr(), D0.data_ptr(), grid.data_ptr(), Pi.data_ptr(), agg.data_ptr(),
            D_T.data_ptr(), Pc.data_ptr(), ranges.data_ptr(), D_hist.data_ptr(), None,
            T, n_a, n_e, torch.cuda.current_stream(dev).cuda_stream)
        cuda_build.check_launch(lib, err, "hank_forward_scan_f32")

    return call, (agg, D_T)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write every record to this JSON file")
    ap.add_argument("--reps", type=int, default=20, help="timed launches per kernel and turn")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("scan_owned_ab: needs a CUDA device", file=sys.stderr)
        return 1
    from hank_tpu_torch.ops import cuda_build
    from hank_tpu_torch.ops.forward_scan import forward_scan_previous

    records: list = []
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    emit({"device": smi.splitlines()[0] if smi else torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda}, records)
    with tempfile.TemporaryDirectory() as tmp:
        proc, path = start_one_loop_build(tmp)
        shipped = cuda_build.load_library()
        out = proc.communicate(timeout=900)[0]
        if proc.returncode != 0:
            raise RuntimeError(out)
        one_loop = load_scan(path)
        for seed, (T, n_a, n_e) in enumerate(SHAPES):
            inputs = scan_input(T, n_a, n_e, seed, dev)
            (run_s, out_s), (run_o, out_o) = (make_call(lib, *inputs)
                                              for lib in (shipped, one_loop))
            run_s(), run_o()
            previous = forward_scan_previous(*inputs)
            same = all(torch.equal(a, b) and torch.equal(a, c)
                       for a, b, c in zip(out_s, out_o, previous))
            turns = [event_ms(fn, args.reps) for fn in (run_s, run_o, run_o, run_s)]
            emit({"shape": [T, n_a, n_e], "cells": n_a * n_e,
                  "second_loop_runs": n_a * n_e > 4 * 1024,
                  "bit_identical_to_each_other_and_previous": same,
                  "ms_shipped": (turns[0] + turns[3]) / 2,
                  "ms_one_loop": (turns[1] + turns[2]) / 2,
                  "turns_ms": {"shipped": [turns[0], turns[3]],
                               "one_loop": [turns[1], turns[2]]}}, records)
            if not same:
                print(f"scan_owned_ab: outputs differ at {T}x{n_a}x{n_e}", file=sys.stderr)
                return 1
    if args.out:
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
