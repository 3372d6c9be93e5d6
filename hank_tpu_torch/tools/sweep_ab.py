"""The one-asset solves with kernels 2-4 against the same solves with the
previous kernels 2-4, in one process on the card.

    python -m hank_tpu_torch.tools.sweep_ab [--reps N] [--out FILE]

Kernels 2-4 and the previous kernels 2-4 (the counting template,
`household_sweep_kernel`) give the same bits, so the solves take the same
iterates either way and only the time differs. Per solve, the script runs
turns of `reps` timed solves each (previous, new, new, previous: the
previous kernels by rebinding the three wrappers the solvers call,
`ops/fused_residual.fused_residual_sweep`, `fused_residual_sweep_batch` and
`ops/fused_sweep_batch.fused_sweep_jvp_batch`, to their `_previous`
twins), checks that every solve returns the same path bit for bit, and
prints the median seconds of each. The solves are `chip_smoke.py`'s:

  - ks_headline: Krusell-Smith 200×7, T=300, permanent TFP shock Z 1→2,
    Newton-Krylov, f32 directions, eps 1e-8, GMRES restart 10, from x_ss
    (kernel 1 and kernel 2);
  - ensemble_b64: B=64 shock paths Z_b,t = 2 − ρ_bᵗ on the same model,
    `solve_ensemble_host` Newton-Krylov (kernels 3-4, batched kernel 2);
  - hank_one_asset (50×7, T=300) and ks_large_grid (500×7, T=150):
    `run.solve_model`, Newton-Krylov, f32 directions, eps 1e-8, steady
    states from a fresh temporary cache (kernels 1 and 2).

Every line is a JSON object. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time


def emit(fh, **rec) -> None:
    line = json.dumps(rec)
    print(line, flush=True)
    if fh is not None:
        fh.write(line + "\n")
        fh.flush()


@contextlib.contextmanager
def previous_kernels():
    """The solvers' wrappers of kernels 2-4 bound to the previous kernels."""
    from hank_tpu_torch.ops import fused_residual as fr
    from hank_tpu_torch.ops import fused_sweep_batch as fsb

    saved = (fr.fused_residual_sweep, fr.fused_residual_sweep_batch,
             fsb.fused_sweep_jvp_batch)
    fr.fused_residual_sweep = fr.fused_residual_sweep_previous
    fr.fused_residual_sweep_batch = fr.fused_residual_sweep_batch_previous
    fsb.fused_sweep_jvp_batch = fsb.fused_sweep_jvp_batch_previous
    try:
        yield
    finally:
        fr.fused_residual_sweep, fr.fused_residual_sweep_batch, \
            fsb.fused_sweep_jvp_batch = saved


def ab(name: str, solve, reps: int, fh) -> dict:
    """Turns (previous, new, new, previous) of `reps` timed `solve()` calls
    after one warm-up of each; every call must return the warm-up's path
    bit for bit. `solve()` returns (path tensor, info)."""
    import torch

    from hank_tpu_torch.ops import fused_residual as fr
    from hank_tpu_torch.ops import fused_sweep_batch as fsb

    def previous_launches():
        return (fr.fused_residual_sweep_previous.launches
                + fr.fused_residual_sweep_batch_previous.launches
                + fsb.fused_sweep_jvp_batch_previous.launches)

    def timed():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x, info = solve()
        torch.cuda.synchronize()
        return x, info, time.perf_counter() - t0

    x_new, info, _ = timed()
    launched = previous_launches()
    with previous_kernels():
        x_old, _, _ = timed()
    launched = previous_launches() - launched
    runs = {"previous": [], "new": []}
    same = torch.equal(x_new, x_old)
    for which in ("previous", "new", "new", "previous"):
        with previous_kernels() if which == "previous" else contextlib.nullcontext():
            for _ in range(reps):
                x, _, seconds = timed()
                runs[which].append(seconds)
                same = same and torch.equal(x, x_new)
    if not same:
        raise RuntimeError(f"{name}: the previous kernels' solve differs from the new one's")
    rec = {"solve": name, "median_s": {k: statistics.median(v) for k, v in runs.items()},
           "runs_s": runs, "bit_identical": True,
           "outer_iterations": info.get("iterations"),
           "matvecs": info.get("inner_iterations"),
           "previous_kernel_launches_in_one_solve": launched}
    emit(fh, **rec)
    return rec


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("sweep_ab: needs a CUDA device", file=sys.stderr)
        return 1
    from hank_tpu_torch import run
    from hank_tpu_torch.models import load_model
    from hank_tpu_torch.models.krusell_smith import exogenousZ
    from hank_tpu_torch.parallel.ensemble import solve_ensemble_host
    from hank_tpu_torch.solvers.newton import make_path_solver
    from hank_tpu_torch.solvers.ss_jacobian import get_steady_state_jacobian
    from hank_tpu_torch.solvers.steady_state import find_ss

    fh = open(args.out, "w") if args.out else None
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    emit(fh, device=smi, torch=torch.__version__, reps=args.reps)
    f32, f64 = torch.float32, torch.float64
    dev = torch.device("cuda:0")

    # KS 200×7, T=300: the headline solve and the B=64 ensemble.
    model = load_model("krusell_smith", T=300, device=dev)
    Tm1 = model.compspec.T - 1
    ss0 = find_ss(model, model.ss_initial, "initial")
    ssT = find_ss(model, model.ss_ending, "ending")
    Jbar = get_steady_state_jacobian(ssT, model)
    endog = model.vars_of_type("endogenous")
    x_ss = torch.stack([torch.as_tensor(ssT.vars[k]) for k in endog]).repeat(Tm1)
    exog = {"Z": exogenousZ(Tm1, rho=0.8, z_start=1.0, z_end=2.0).to(dev)}
    solver = make_path_solver(Jbar, exog, model, ss0, ssT, method="newton_krylov",
                              direction_dtype=f32, eps=1e-8, gmres_restart=10)
    ab("ks_headline", lambda: solver(x_ss), args.reps, fh)

    B = 64
    t = torch.arange(1, Tm1 + 1, dtype=f64)
    rhos = 0.5 + 0.4 * torch.arange(B, dtype=f64) / B
    exog_b = {"Z": (2.0 - rhos[:, None] ** t[None, :]).to(dev)}
    ab("ensemble_b64", lambda: solve_ensemble_host(
        x_ss, Jbar, exog_b, model, ss0, ssT, eps=1e-8, method="newton_krylov",
        direction_dtype=f32), args.reps, fh)

    # The driver's two other one-asset families.
    previous = os.environ.get("HANK_TPU_TORCH_CACHE")
    with tempfile.TemporaryDirectory() as cache:
        os.environ["HANK_TPU_TORCH_CACHE"] = cache
        try:
            for name, T in (("hank_one_asset", 300), ("ks_large_grid", 150)):
                m = load_model(name, T=T, device=dev)

                def solve(m=m):
                    x, info, _, _ = run.solve_model(m, method="newton_krylov",
                                                    direction_dtype=f32, eps=1e-8,
                                                    verbose=False)
                    return torch.as_tensor(x), info

                ab(name, solve, args.reps, fh)
        finally:
            if previous is None:
                os.environ.pop("HANK_TPU_TORCH_CACHE", None)
            else:
                os.environ["HANK_TPU_TORCH_CACHE"] = previous
    if fh is not None:
        fh.close()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
