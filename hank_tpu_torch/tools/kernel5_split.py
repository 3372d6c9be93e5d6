"""Where kernel 5's time goes, on the card.

    python -m hank_tpu_torch.tools.kernel5_split [--out FILE] [--reps N]

At the two-asset model's published width (40×20×5×2, T=300), at the JAX
package's root of the fiscal-shock path (`hank_tpu_torch/data/
hank_two_asset_T300_jax_cpu.npz`, within 1e-6 of the route's solution on the
card) along a smooth seeded direction:

  - split: `csrc/household_sweep2.cu` built with the library's nvcc flags
    and `-DHANK_K5_STAMPS`, which compiles `clock64()` stamps of each
    block's thread 0 into both kernel 5s (and nothing else: without the
    macro the stamps are empty); the previous kernel's cycles per period in
    each stage (A, B1, B2, C1, C2, C3, C4, D) and their shares, kernel 5's
    per stage and block on its cluster, and whether the stamped kernels'
    outputs equal the previous kernel's bit for bit;
  - kernels: ms of kernel 5 on clusters of n_e blocks (one income a block)
    and of ⌈n_e/2⌉ (two a block), and of the previous kernel, timed in
    turns in this one process, and whether every output is bit for bit the
    previous kernel's.

Every line is a JSON object. The steady state comes from the artifact cache
(`HANK_TPU_TORCH_CACHE`, as `get_or_solve` keeps it) or is solved on the card
and cached (~2 min). Needs a CUDA device and nvcc.
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

# The stamp slots of the previous kernel 5 (`two_asset_bwd_kernel`) and of
# kernel 5 (`two_asset_bwd_cluster_kernel`, per block), and of their sweeps.
PREVIOUS_STAGES = {0: "A", 1: "B1", 2: "B2", 3: "C1", 4: "C2", 5: "C3", 6: "C4", 7: "D"}
CLUSTER_STAGES = {0: "wait_before_A", 1: "A", 2: "B1_and_C1", 3: "C2_and_scan",
                  4: "wait_before_B2", 5: "B2_and_root_chain", 6: "B2_thread0",
                  7: "C4_and_D", 8: "D_to_next_wait"}
SWEEP_SLOT = {"previous": 8, "cluster": 9}


def build_split_library(tmp: str) -> ctypes.CDLL:
    """The two-asset library built with kernel 5's stamps (`-DHANK_K5_STAMPS`)."""
    from hank_tpu_torch.ops import cuda_build

    path = os.path.join(tmp, "household_sweep2_k5_stamps.so")
    proc = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-DHANK_K5_STAMPS",
                           "-o", path, cuda_build.SOURCES["household_sweep2"]],
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(proc.stdout + proc.stderr)
    lib = ctypes.CDLL(path)
    p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.hank_sweep2_policies_jvp_f32.argtypes = [p] * 15 + [i] * 4 + [d] * 4 + [p, p]
    lib.hank_sweep2_policies_jvp_cluster_f32.argtypes = [p] * 14 + [i] * 5 + [d] * 4 + [p, p]
    return lib


def stage_split(stamps: list, stages: dict, sweep_slot: int, Tm1: int) -> dict:
    """Cycles per period of each stage, its share of the sweep's cycles, and
    the share no stage holds, from one block's stamp slots."""
    total = stamps[sweep_slot]
    named = {name: stamps[slot] for slot, name in stages.items()}
    return {"cycles_per_period": {k: c / Tm1 for k, c in named.items()},
            "sweep_cycles_per_period": total / Tm1,
            "share": {**{k: c / total for k, c in named.items()},
                      "unattributed": 1.0 - sum(named.values()) / total}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write every record to this JSON file")
    ap.add_argument("--reps", type=int, default=10, help="timed calls per kernel and turn")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("kernel5_split: needs a CUDA device", file=sys.stderr)
        return 1
    from hank_tpu_torch.model.structures import generate_exog_paths
    from hank_tpu_torch.models import load_model
    from hank_tpu_torch.models.hank_two_asset import fused2_prices
    from hank_tpu_torch.ops import fused_sweep2 as fs2
    from hank_tpu_torch.solvers.steady_state import find_ss
    from hank_tpu_torch.utils.checkpoint import load_steady_state, save_steady_state

    records: list = []
    f32, f64 = torch.float32, torch.float64
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    emit({"device": smi.splitlines()[0] if smi else torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda}, records)

    model = load_model("hank_two_asset", T=300, device=dev)
    Tm1, nE = model.compspec.T - 1, model.compspec.n_endog
    ss = load_steady_state(model, "initial")
    if ss is None:
        ss = find_ss(model, model.ss_initial, "initial")
        save_steady_state(ss, model, "initial")
    data = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data",
                        "hank_two_asset_T300_jax_cpu.npz")
    with np.load(data) as z:
        x = torch.as_tensor(z["x"], dtype=f64, device=dev)
    exog = generate_exog_paths(model, Tm1)
    gen = torch.Generator().manual_seed(7)
    v = (torch.randn(nE, generator=gen, dtype=f64)
         * (0.9 ** torch.arange(Tm1, dtype=f64))[:, None]).reshape(-1).to(dev)
    m32 = fs2.cast_model(model, f32)
    paths = [q.to(f32).contiguous() for q in
             (*fused2_prices(x.reshape(Tm1, nE), exog, model),
              *fused2_prices(v.reshape(Tm1, nE), exog, model))]
    VT = ss.value.to(f32).contiguous()
    liquid, illiq, income, access = fs2._dims(model)
    NB, NA, NE = liquid.n, illiq.n, income.n
    p = model.params
    consts = [t.to(device=dev, dtype=f32).contiguous() for t in
              (liquid.grid, illiq.grid, income.grid, income.transition)]
    scalars = (float(p["β"]), float(access.transition[0, 1]),
               float(p.get("portfolio_reg", 0.0)), float(p["borrow_cons"]))
    prev = fs2.fused2_policies_jvp_previous(*paths, VT, m32)
    ref = torch.stack([*(prev[0][k] for k in fs2.KEYS), *(prev[1][k] for k in fs2.KEYS)])
    stream = torch.cuda.current_stream(dev).cuda_stream
    sizes = sorted({fs2.default_bwd_cluster(NE), (NE + 1) // 2})

    def bits_of(t):
        return torch.equal(t.view(torch.int32), ref.view(torch.int32))

    with tempfile.TemporaryDirectory() as tmp:
        lib = build_split_library(tmp)
        out = torch.empty_like(ref)
        margin = torch.empty(2 * NB * NA * NE, dtype=f32, device=dev)
        stamps = torch.zeros(32 * 16, dtype=torch.int64, device=dev)   # 32 slots a block
        ins = [t.data_ptr() for t in (*paths, VT, *consts)]

        def stamped():
            err = lib.hank_sweep2_policies_jvp_f32(*ins, margin.data_ptr(), out.data_ptr(),
                                                   Tm1, NB, NA, NE, *scalars,
                                                   stamps.data_ptr(), stream)
            if err:
                raise RuntimeError(f"hank_sweep2_policies_jvp_f32: CUDA error {err}")

        ms = event_ms(stamped, 3)
        st = stamps.tolist()
        emit({"split_previous": {
            "stamped_ms": ms, "bit_identical_to_previous": bits_of(out),
            "cycles_per_ms": st[SWEEP_SLOT["previous"]] / ms, "us_per_period": ms * 1e3 / Tm1,
            **stage_split(st, PREVIOUS_STAGES, SWEEP_SLOT["previous"], Tm1)}}, records)

        for c in sizes:
            def stamped_cluster(c=c):
                err = lib.hank_sweep2_policies_jvp_cluster_f32(
                    *ins, out.data_ptr(), Tm1, NB, NA, NE, c, *scalars, stamps.data_ptr(),
                    stream)
                if err:
                    raise RuntimeError(f"hank_sweep2_policies_jvp_cluster_f32: CUDA error {err}")

            out.zero_()
            ms = event_ms(stamped_cluster, 3)
            st = stamps.view(-1, 32)[:c].tolist()
            emit({"split_cluster": {
                "cluster": c, "stamped_ms": ms, "bit_identical_to_previous": bits_of(out),
                "by_block": [stage_split(b, CLUSTER_STAGES, SWEEP_SLOT["cluster"], Tm1)
                             for b in st]}}, records)

    # Kernel 5 at each cluster size against the previous kernel, in turns.
    runs = {"previous": lambda: fs2.fused2_policies_jvp_previous(*paths, VT, m32)}
    bits = {}
    for c in sizes:
        runs[f"cluster_{c}"] = lambda c=c: fs2._launch_bwd_cluster(paths, VT, m32, c)
        pol, dpol = runs[f"cluster_{c}"]()
        bits[c] = bits_of(torch.stack([*(pol[k] for k in fs2.KEYS),
                                       *(dpol[k] for k in fs2.KEYS)]))
    times = {name: [] for name in runs}
    for name in [*runs, *reversed(runs)]:
        times[name].append(event_ms(runs[name], args.reps))
    emit({"kernels": {"ms": times, "bit_identical_to_previous": bits,
                      "default_cluster": fs2.default_bwd_cluster(NE)}}, records)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
