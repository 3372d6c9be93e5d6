"""Where kernel 6's time goes, on the card.

    python -m hank_tpu_torch.tools.kernel6_split [--out FILE] [--reps N]

At the two-asset model's published width (40×20×5×2, T=300), at the JAX
package's root of the fiscal-shock path (`hank_tpu_torch/data/
hank_two_asset_T300_jax_cpu.npz`, within 1e-6 of the route's solution on the
card) along a smooth seeded direction, through kernel 5's policies:

  - split: `csrc/household_sweep2.cu` built with the library's nvcc flags
    and `-DHANK_K6_STAMPS`, which compiles `clock64()` stamps of each
    block's thread 0 into both kernel 6s (and nothing else: without the
    macro the stamps are empty); the share of the previous kernel's cycles
    in each stage, R per group, kernel 6's cycles per stage and block on
    its cluster, and whether the stamped kernels' outputs equal the
    previous kernel's bit for bit;
  - lists: the lengths of the lottery's row lists (the sources whose liquid
    bracket jb = clamp(searchsorted(grid, B'), 1, n_b − 1) is j or j + 1),
    of the column lists, and the exact hits per destination (j, m);
  - barriers: `cluster.sync()` and `__syncthreads()` latency, and how many
    clusters of each size the card holds (probes of the same build);
  - kernels: ms of kernel 6 on clusters of n_e blocks (two groups a block)
    and of 2·n_e (one group a block), and of the previous kernel, timed in
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
import statistics
import subprocess
import sys
import tempfile



def emit(record: dict, sink: list) -> None:
    sink.append(record)
    print(json.dumps(record), flush=True)


def build_split_library(tmp: str) -> ctypes.CDLL:
    """The two-asset library built with its stamps (`-DHANK_K6_STAMPS`)."""
    from hank_tpu_torch.ops import cuda_build

    path = os.path.join(tmp, "household_sweep2_stamps.so")
    proc = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-DHANK_K6_STAMPS",
                           "-o", path, cuda_build.SOURCES["household_sweep2"]],
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(proc.stdout + proc.stderr)
    lib = ctypes.CDLL(path)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.hank_sweep2_forward_jvp_f32.argtypes = [p] * 12 + [i] * 4 + [p, p]
    lib.hank_sweep2_forward_jvp_cluster_f32.argtypes = [p] * 13 + [i] * 5 + [p, p]
    lib.hank_k6_max_clusters.argtypes = [i, i]
    lib.hank_k6_cluster_sync.argtypes = [i, i, i, p, p]
    lib.hank_k6_block_sync.argtypes = [i, p, p]
    return lib


def event_ms(fn, reps: int) -> float:
    """Median device ms of `fn()` over `reps` event-timed calls after one warm-up."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def list_lengths(pB, pA, bgrid, agrid) -> dict:
    """Row and column list lengths and hits per destination of every
    (period, income, access) group, from the policies' brackets."""
    import torch

    n_b, n_a = bgrid.numel(), agrid.numel()
    jb = torch.searchsorted(bgrid, pB.contiguous()).clamp(1, n_b - 1)
    ja = torch.searchsorted(agrid, pA.contiguous()).clamp(1, n_a - 1)
    one_hot = torch.nn.functional.one_hot
    rb = (one_hot(jb, n_b) + one_hot(jb - 1, n_b)).float()      # (t, b, a, e, acc, j)
    ca = (one_hot(ja, n_a) + one_hot(ja - 1, n_a)).float()      # (t, b, a, e, acc, m)
    rows = rb.sum(dim=(1, 2))                                     # (t, e, acc, j)
    cols = ca.sum(dim=(1, 2))
    hits = torch.einsum("tbaegj,tbaegm->tegjm", rb, ca)
    t, e, acc, j = (int(i) for i in torch.unravel_index(rows.argmax(), rows.shape))
    r = rows.flatten()
    top = float(r.max())
    edges = torch.linspace(0.0, top + 1.0, 13)
    return {"rows": {"lists": r.numel(), "max": top, "median": float(r.median()),
                     "mean": float(r.mean()), "longest": {"t": t, "e": e, "acc": acc, "j": j},
                     "histogram_edges": edges.tolist(),
                     "histogram": torch.histc(r.cpu(), bins=12, min=0.0, max=top + 1.0).tolist()},
            "columns": {"max": float(cols.max()), "median": float(cols.flatten().median())},
            "hits_per_destination": {"max": float(hits.max()), "mean": float(hits.mean()),
                                     "max_per_group_period_mean": float(
                                         hits.flatten(3).max(dim=-1).values.mean())}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write every record to this JSON file")
    ap.add_argument("--reps", type=int, default=10, help="timed calls per kernel and turn")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("kernel6_split: needs a CUDA device", file=sys.stderr)
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
    pol, dpol = fs2.fused2_policies_jvp(*paths, ss.value.to(f32).contiguous(), m32)
    D0 = ss.D.to(f32).contiguous()
    liquid, illiq, income, access = fs2._dims(model)
    NB, NA, NE = liquid.n, illiq.n, income.n
    consts = [t.to(device=dev, dtype=f32).contiguous() for t in
              (liquid.grid, illiq.grid, income.transition, access.transition)]
    prev = fs2.fused2_forward_jvp_previous(pol, dpol, D0, m32)
    stream = torch.cuda.current_stream(dev).cuda_stream

    with tempfile.TemporaryDirectory() as tmp:
        lib = build_split_library(tmp)
        # Split of the previous kernel.
        out = torch.empty((6, Tm1), dtype=f32, device=dev)
        stamps = torch.zeros(32 * 16, dtype=torch.int64, device=dev)   # 32 slots a block
        ptrs = [t.data_ptr() for t in (*(pol[k] for k in fs2.KEYS),
                                       *(dpol[k] for k in fs2.KEYS), D0, *consts, out)]

        def stamped():
            err = lib.hank_sweep2_forward_jvp_f32(*ptrs, Tm1, NB, NA, NE, stamps.data_ptr(),
                                                  stream)
            if err:
                raise RuntimeError(f"hank_sweep2_forward_jvp_f32: CUDA error {err}")

        stamped_ms = event_ms(stamped, 3)
        same = (torch.equal(out[:3], torch.stack([prev[0][k] for k in fs2.KEYS]))
                and torch.equal(out[3:], torch.stack([prev[1][k] for k in fs2.KEYS])))
        st = stamps.tolist()
        total = st[6]
        stages = {"L": st[0], "R": st[1], "M": st[2], "tree": st[3]}
        emit({"split": {
            "stamped_ms": stamped_ms, "bit_identical_to_previous": same,
            "cycles_per_ms": total / stamped_ms, "us_per_period": stamped_ms * 1e3 / Tm1,
            "share": {**{k: c / total for k, c in stages.items()},
                      "unattributed": 1.0 - sum(stages.values()) / total},
            "R_cycles_per_period_by_group": [c / Tm1 for c in st[7:7 + 2 * NE]],
            "L_cycles_per_group_period": st[0] / (Tm1 * 2 * NE),
            "warp0_share_of_R": {"build": st[4] / st[1], "walk": st[5] / st[1]}}}, records)

        # Split of kernel 6 on its cluster, per block.
        Dpath = torch.empty((Tm1, 2, D0.numel()), dtype=f32, device=dev)
        for c in sorted({fs2.default_cluster(NE), NE}):
            stamps.zero_()

            def stamped_cluster():
                err = lib.hank_sweep2_forward_jvp_cluster_f32(
                    *ptrs[:-1], Dpath.data_ptr(), ptrs[-1], Tm1, NB, NA, NE, c,
                    stamps.data_ptr(), stream)
                if err:
                    raise RuntimeError(f"hank_sweep2_forward_jvp_cluster_f32: CUDA error {err}")

            ms = event_ms(stamped_cluster, 3)
            same = (torch.equal(out[:3], torch.stack([prev[0][k] for k in fs2.KEYS]))
                    and torch.equal(out[3:], torch.stack([prev[1][k] for k in fs2.KEYS])))
            st = stamps.view(-1, 32)[:c].tolist()
            names = {0: "L", 1: "R_count_and_place", 2: "R_terms_and_ranks", 3: "R_sum_and_send",
                     4: "cluster_wait_A", 5: "M", 6: "cluster_wait_B", 7: "aggregates",
                     8: "all"}
            emit({"split_cluster": {
                "cluster": c, "stamped_ms": ms, "bit_identical_to_previous": same,
                "cycles_per_period_by_block": [{n: b[i] / Tm1 for i, n in names.items()}
                                               for b in st]}}, records)

        emit({"lists": list_lengths(pol["B"], pol["A"], consts[0], consts[1])}, records)

        # Barriers and cluster occupancy.
        cyc = torch.zeros(1, dtype=torch.int64, device=dev)
        fits, sync = {}, {}
        for c in (2, 4, 5, 8, 10, 16):
            fits[c] = lib.hank_k6_max_clusters(c, 65536)
        for c in (5, 10):
            if fits[c] > 0 and lib.hank_k6_cluster_sync(c, 65536, 10000, cyc.data_ptr(),
                                                         stream) == 0:
                torch.cuda.synchronize()
                sync[c] = int(cyc) / 10000
        lib.hank_k6_block_sync(10000, cyc.data_ptr(), stream)
        torch.cuda.synchronize()
        emit({"barriers": {"cluster_sync_cycles": sync, "syncthreads_cycles": int(cyc) / 10000,
                           "clusters_of_1024_threads_64KB_that_fit": fits}}, records)

    # Kernel 6 at each cluster size against the previous kernel, in turns.
    sizes = sorted({NE, fs2.default_cluster(NE)})
    runs = {"previous": lambda: fs2.fused2_forward_jvp_previous(pol, dpol, D0, m32)}
    inputs = fs2._forward_inputs("kernel6_split", pol, dpol, D0, m32)
    bits = {}
    for c in sizes:
        runs[f"cluster_{c}"] = lambda c=c: fs2._launch_cluster(*inputs, m32, c)
        new = runs[f"cluster_{c}"]()
        bits[c] = all(torch.equal(a[k].view(torch.int32), b[k].view(torch.int32))
                      for a, b in zip(new, prev) for k in fs2.KEYS)
    order = [*runs, *reversed(runs)]
    times = {name: [] for name in runs}
    for name in order:
        times[name].append(event_ms(runs[name], args.reps))
    emit({"kernels": {"ms": times, "bit_identical_to_previous": bits,
                      "default_cluster": fs2.default_cluster(NE)}}, records)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
