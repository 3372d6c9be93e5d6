"""Where the one-asset tangent sweep's time goes, on the card.

    python -m hank_tpu_torch.tools.sweep_split [--out FILE] [--reps N]

Builds `csrc/household_sweep.cu` with the library's nvcc flags and
`-DHANK_SWEEP_STAMPS`, which compiles `clock64()` stamps into
`household_sweep_ranged_kernel` (and nothing else; without the macro the
stamps are empty), and runs its tangent instantiations at n_e = 7, T = 150
(149 periods) on seeded inputs shaped as the EGM meets them (V_T the
marginal value of a consumption rule rising in wealth, a seeded D0,
Krusell-Smith's β and γ, prices near r = 0.01, w = 0.9 with noise; the card
tests' recipe, `tests/test_torch_sweep_bits.py::inputs`):

  - the global-state instantiations `<double, true, false, true>` and
    `<float, true, false, true>` at 200×7, 500×7 and 1200×7;
  - beside them at 200×7 and 500×7 the shared-state ones with the same
    arithmetic, `<double, true, false>` and `<float, true, true>` at B = 1.

Per run, one JSON line: ms per launch of the library's build and of the
stamped build (events, `--reps` launches), whether the stamped outputs are
bit for bit the library's, and from the stamps (summed over `--reps`
launches, divided by them): the cycles block thread 0 spends in each stage
a period (expectation and Euler inversion, the implied-wealth row check,
bracket + lerp + envelope, the clamp, the lottery, the mix with the
aggregates' partials, the aggregate tree) and its share of the sweep; and
the thread-cycles a state of each part of a stage's loop (the expectation's
fold over e' against the Euler inversion, the bracket search against the
lerp and envelope, the lottery's range search against its sum, the Markov
mix against the aggregates' terms). A last line sets the global-state
stages against the shared-state ones at the same grid: the extra cycles a
stage pays for state in global memory, where both fit, and at 1200×7 the
global-state stage per state against 500×7's.

Then `csrc/household_sweep_cluster.cu` built with `-DHANK_CLUSTER_STAMPS`
(stamps of each block's thread 0 in the cluster kernel only) and its two
single-path tangent instantiations at the three grids on the same inputs: per block
(rank) of the cluster, the cycles a period in each stage (the waits at
the cluster barriers, the expectation, the row check, bracket and
envelope, the clamp, the lottery, the mix, block 0's aggregates), ms of
the library's and the stamped build, and whether the stamped outputs are
the library's bit for bit. Needs a CUDA device and nvcc.
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

N_E, TM1 = 7, 149
GRIDS = (200, 500, 1200)
SLOTS = 24
BLOCK_STAGES = {0: "expectation_euler", 1: "row_check", 2: "bracket_envelope", 3: "clamp",
                4: "lottery", 5: "mix_terms", 6: "tree"}
SETUP_SLOT = 7
THREAD_PARTS = {10: "expectation_fold", 11: "euler", 12: "bracket_search", 13: "envelope",
                14: "lottery_range", 15: "lottery_sum", 16: "mix_fold", 17: "aggregate_terms"}
CLUSTER_SLOTS = 16
CLUSTER_STAGES = {0: "setup", 1: "waits_backward_and_forward_head", 2: "expectation_euler",
                  3: "row_check", 4: "bracket_envelope", 5: "clamp", 6: "lottery",
                  7: "wait_forward", 8: "mix", 9: "aggregates", 10: "end"}
# (dtype, state) -> (entry point, its pointer count before the ints, batched)
ENTRIES = {("f64", "global"): ("hank_sweep_jvp_f64_global", 17, False),
           ("f64", "shared"): ("hank_sweep_jvp_f64", 16, False),
           ("f32", "global"): ("hank_sweep_jvp_f32_global", 17, False),
           ("f32", "shared"): ("hank_sweep_jvp_f32_batch", 16, True)}


def build_split_library(tmp: str) -> ctypes.CDLL:
    """The one-asset library built with the sweep's stamps (`-DHANK_SWEEP_STAMPS`)."""
    from hank_tpu_torch.ops import cuda_build

    path = os.path.join(tmp, "household_sweep_stamps.so")
    proc = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-DHANK_SWEEP_STAMPS",
                           "-o", path, cuda_build.SOURCES["household_sweep"]],
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(proc.stdout + proc.stderr)
    lib = ctypes.CDLL(path)
    declare(lib)
    lib.hank_sweep_stamps.argtypes = [ctypes.c_void_p]
    lib.hank_sweep_stamps.restype = ctypes.c_int
    return lib


def build_cluster_split_library(tmp: str) -> ctypes.CDLL:
    """The cluster library built with its stamps (`-DHANK_CLUSTER_STAMPS`)."""
    from hank_tpu_torch.ops import cuda_build

    path = os.path.join(tmp, "household_sweep_cluster_stamps.so")
    proc = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-DHANK_CLUSTER_STAMPS",
                           "-o", path, cuda_build.SOURCES["household_sweep_cluster"]],
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(proc.stdout + proc.stderr)
    lib = ctypes.CDLL(path)
    declare_cluster(lib)
    lib.hank_sweep_cluster_stamps.argtypes = [ctypes.c_void_p]
    lib.hank_sweep_cluster_stamps.restype = ctypes.c_int
    return lib


def declare_cluster(lib: ctypes.CDLL) -> None:
    p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    for entry in ("hank_sweep_jvp_f32_cluster", "hank_sweep_jvp_f64_cluster"):
        getattr(lib, entry).argtypes = [p] * 16 + [i] * 3 + [d] * 3 + [p]
        getattr(lib, entry).restype = i


def cluster_split(args, dev, stream, records) -> None:
    """The cluster instantiations' stamps at each grid (module docstring)."""
    import torch

    from hank_tpu_torch.ops import cuda_build

    plain_lib = cuda_build.load_library("household_sweep_cluster")
    declare_cluster(plain_lib)
    stamps = (ctypes.c_ulonglong * (8 * CLUSTER_SLOTS))()
    with tempfile.TemporaryDirectory() as tmp:
        lib = build_cluster_split_library(tmp)
        for kind, dtype in (("f64", torch.float64), ("f32", torch.float32)):
            entry = f"hank_sweep_jvp_{kind}_cluster"
            for n_a in GRIDS:
                paths, consts = inputs(dtype, dev, n_a)
                outs, runs = [], []
                for which in (plain_lib, lib):
                    scratch = [torch.empty((TM1, N_E, n_a), dtype=dtype, device=dev)
                               for _ in range(2)]
                    out = torch.empty((4, TM1), dtype=dtype, device=dev)
                    ptrs = [q.data_ptr() for q in (*paths, *consts, *scratch, *out)] + [0]
                    fn = getattr(which, entry)

                    def run(fn=fn, ptrs=ptrs, keep=scratch):
                        err = fn(*ptrs, TM1, n_a, N_E, 0.982, 2.0, 0.0, stream)
                        if err:
                            raise RuntimeError(f"{entry}: CUDA error {err}")

                    outs.append(out)
                    runs.append(run)
                ms, ms_st = event_ms(runs[0], args.reps), event_ms(runs[1], args.reps)
                torch.cuda.synchronize()
                lib.hank_sweep_cluster_stamps(None)
                for _ in range(args.reps):
                    runs[1]()
                torch.cuda.synchronize()
                if lib.hank_sweep_cluster_stamps(ctypes.cast(stamps, ctypes.c_void_p)):
                    raise RuntimeError("hank_sweep_cluster_stamps failed")
                st = list(stamps)
                by_rank = [{name: st[r * CLUSTER_SLOTS + i] / (args.reps * TM1)
                            for i, name in CLUSTER_STAGES.items()} for r in range(N_E)]
                emit({"cluster_split": {
                    "kernel": f"<{'double' if kind == 'f64' else 'float'},true>", "dtype": kind,
                    "grid": [n_a, N_E], "periods": TM1, "ms": ms, "ms_stamped": ms_st,
                    "stamped_bit_identical": bool(torch.equal(outs[0], outs[1])),
                    "cycles_per_period_by_rank": by_rank}}, records)


def declare(lib: ctypes.CDLL) -> None:
    p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    for entry, n_p, batched in ENTRIES.values():
        getattr(lib, entry).argtypes = [p] * n_p + [i] * (4 if batched else 3) + [d] * 3 + [p]
        getattr(lib, entry).restype = i


def inputs(dtype, device, n_a: int, seed: int = 0):
    """(r, w, dr, dw) paths of TM1 periods and (V_T, D0, grid, e_grid, Pi) in
    the kernels' layout ((n_e, n_a) states), the card tests' recipe."""
    import numpy as np
    import torch

    from hank_tpu_torch.model.grids import make_double_exponential_grid, rouwenhorst

    rng = np.random.default_rng(seed)
    grid = make_double_exponential_grid(0.0, 200.0, n_a)
    Pi, _, z = rouwenhorst(N_E, 0.966, 0.283)
    r0, w0 = 0.01, 0.9
    c = 0.05 * grid[None, :] + 0.9 * w0 * z[:, None] + 0.3
    V = (1 + r0) * c ** -2.0
    D = rng.uniform(0.5, 1.5, (N_E, n_a))
    paths = (r0 * (1 + 0.05 * rng.normal(size=TM1)), w0 * (1 + 0.02 * rng.normal(size=TM1)),
             0.01 * rng.normal(size=TM1), 0.01 * rng.normal(size=TM1))

    def t(a):
        return torch.tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

    return [t(a) for a in paths], [t(a) for a in (V, D / D.sum(), grid, z, Pi)]


def launcher(lib, key, paths, consts, n_a, stream):
    """A callable that launches `key`'s entry point of `lib` on these inputs,
    its (agg, dagg, aggc, daggc), and the scratch it writes (policies, their
    tangents and a global-state launch's workspace)."""
    import torch

    from hank_tpu_torch.ops.fused_sweep import state_workspace_bytes

    entry, _, batched = ENTRIES[key]
    dev, dtype = paths[0].device, paths[0].dtype
    scratch = [torch.empty((TM1, N_E, n_a), dtype=dtype, device=dev) for _ in range(2)]
    out = torch.empty((4, TM1), dtype=dtype, device=dev)
    ptrs = [q.data_ptr() for q in (*paths, *consts, *scratch, *out)] + [0]
    if key[1] == "global":
        scratch.append(torch.empty(state_workspace_bytes(dtype, True, n_a, N_E),
                                   dtype=torch.uint8, device=dev))
        ptrs.append(scratch[-1].data_ptr())
    ints = (1, TM1, n_a, N_E) if batched else (TM1, n_a, N_E)
    fn = getattr(lib, entry)

    def run():
        err = fn(*ptrs, *ints, 0.982, 2.0, 0.0, stream)
        if err:
            raise RuntimeError(f"{entry}: CUDA error {err}")

    return run, out, scratch


def split(stamps: list, reps: int, n_a: int, ms_stamped: float) -> dict:
    """Cycles a period of each block stage and their shares; thread-cycles a
    state of each part of a loop."""
    per = [s / reps for s in stamps]
    sweep = sum(per[i] for i in BLOCK_STAGES) + per[SETUP_SLOT]
    n = n_a * N_E
    return {"cycles_per_ms": sweep / ms_stamped,
            "stage_cycles_per_period": {name: per[i] / TM1 for i, name in BLOCK_STAGES.items()},
            "stage_share": {name: per[i] / sweep for i, name in BLOCK_STAGES.items()},
            "setup_share": per[SETUP_SLOT] / sweep,
            "thread_cycles_per_state": {name: per[i] / (TM1 * n)
                                        for i, name in THREAD_PARTS.items()},
            "states_per_thread": n / 1024}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write every record to this JSON file")
    ap.add_argument("--reps", type=int, default=5, help="launches per stamped and timed run")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("sweep_split: needs a CUDA device", file=sys.stderr)
        return 1
    from hank_tpu_torch.ops import cuda_build

    records: list = []
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    emit({"device": smi.splitlines()[0] if smi else torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda}, records)
    plain_lib = cuda_build.load_library()
    declare(plain_lib)
    stream = torch.cuda.current_stream(dev).cuda_stream
    stamps = (ctypes.c_ulonglong * SLOTS)()
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        lib = build_split_library(tmp)
        for kind, dtype in (("f64", torch.float64), ("f32", torch.float32)):
            for n_a in GRIDS:
                paths, consts = inputs(dtype, dev, n_a)
                for state in ("shared", "global"):
                    key = (kind, state)
                    need = cuda_build.sweep_smem_bytes(
                        {("f64", "shared"): cuda_build.JVP_F64,
                         ("f32", "shared"): cuda_build.KERNELS3_4,
                         ("f64", "global"): cuda_build.GLOBAL_JVP_F64,
                         ("f32", "global"): cuda_build.GLOBAL_KERNEL1}[key], n_a, N_E)
                    if need > cuda_build.MAX_SMEM_BYTES:
                        continue
                    run_plain, out_plain, keep_p = launcher(plain_lib, key, paths, consts, n_a,
                                                            stream)
                    run_st, out_st, keep_s = launcher(lib, key, paths, consts, n_a, stream)
                    ms = event_ms(run_plain, args.reps)
                    ms_st = event_ms(run_st, args.reps)
                    torch.cuda.synchronize()
                    lib.hank_sweep_stamps(None)
                    for _ in range(args.reps):
                        run_st()
                    torch.cuda.synchronize()
                    if lib.hank_sweep_stamps(ctypes.cast(stamps, ctypes.c_void_p)):
                        raise RuntimeError("hank_sweep_stamps failed")
                    bits = bool(torch.equal(out_plain, out_st))
                    rec = {"kernel": f"<{'double' if kind == 'f64' else 'float'},true,"
                                     f"{'true' if key == ('f32', 'shared') else 'false'}"
                                     f"{',true' if state == 'global' else ''}>",
                           "dtype": kind, "state": state, "grid": [n_a, N_E], "periods": TM1,
                           "ms": ms, "ms_stamped": ms_st, "stamped_bit_identical": bits,
                           **split(list(stamps), args.reps, n_a, ms_st)}
                    runs[(kind, state, n_a)] = rec
                    emit({"split": rec}, records)
    # State in global memory against shared memory, per stage and part.
    compare = {}
    for kind in ("f64", "f32"):
        for n_a in GRIDS:
            g = runs.get((kind, "global", n_a))
            s_ = runs.get((kind, "shared", n_a)) or runs.get((kind, "shared", 500))
            if g is None or s_ is None:
                continue
            scale = n_a / s_["grid"][0]
            compare[f"{kind}_{n_a}x7"] = {
                "against_shared_at": s_["grid"],
                "stage_extra_cycles_per_period": {
                    k: g["stage_cycles_per_period"][k] - scale * v
                    for k, v in s_["stage_cycles_per_period"].items()},
                "part_extra_thread_cycles_per_state": {
                    k: g["thread_cycles_per_state"][k] - v
                    for k, v in s_["thread_cycles_per_state"].items()},
                "ms_global_over_shared_scaled": g["ms"] / (scale * s_["ms"])}
    emit({"global_against_shared": compare}, records)
    cluster_split(args, dev, stream, records)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
