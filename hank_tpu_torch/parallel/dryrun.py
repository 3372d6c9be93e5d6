"""Multi-rank dry run of the three sharded paths (port of
`__graft_entry__.py:105-233`, `_tiny_model` and `dryrun_multichip`).

On a small Krusell-Smith model (16 wealth points, n_e = n exogenous states,
T = 8) with its real steady state, every rank of an n-rank group runs:
  - SP: J̄ with its seed sweeps split over gcd(n, n_endog) ranks, against
    the unsplit J̄ (1e-12);
  - TP: the backward and forward household blocks with the exogenous state
    axis split over all n ranks, aggregates within 1e-9 of the unsplit
    blocks;
  - DP: an ensemble of 2n shock paths split over all n ranks, solved by
    both methods to ‖F‖ < 1e-8 on every row, row 0 re-checked by the plain
    f64 pipeline (< 1e-7).

    python -m hank_tpu_torch.parallel.dryrun --n 2 --device cpu   # gloo ranks
    python -m hank_tpu_torch.parallel.dryrun --n 1                # one card
    torchrun --nproc-per-node 4 -m hank_tpu_torch.parallel.dryrun # 4 cards

Without torchrun the script spawns its n ranks itself (`spawn_ranks`); under
torchrun each process is one rank. NCCL on the cards, gloo on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import multiprocessing.connection
import os
import sys
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from hank_tpu_torch.parallel.mesh import destroy_distributed, init_distributed

# How long `spawn_ranks` waits for its ranks by default.
SPAWN_TIMEOUT_S = 900.0


def _rank_main(rank: int, world: int, device, tmp: str, fn, args) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    try:
        dev = init_distributed(device, init_file=os.path.join(tmp, "store"))
        try:
            result = fn(dev, *args)
        finally:
            destroy_distributed()
        torch.save(result, os.path.join(tmp, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def spawn_ranks(fn, n: int, *args, device=None, timeout: float = SPAWN_TIMEOUT_S) -> list:
    """Run `fn(device, *args)` on n new processes (the `spawn` method), one
    rank each of one process group (`init_distributed` through a FileStore in
    a temporary directory; NCCL on the cards, the default, gloo for
    device="cpu"), and return each rank's result in rank order.

    `fn` and `args` must pickle (a module-level function). When a rank
    fails, or `timeout` seconds pass, the other ranks are killed and
    RuntimeError (TimeoutError) is raised with the failing rank's traceback.
    """
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="hank_tpu_torch_ranks_") as tmp:
        procs = [ctx.Process(target=_rank_main, args=(r, n, device, tmp, fn, args))
                 for r in range(n)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        pending = list(procs)
        try:
            while pending and time.monotonic() < deadline:
                multiprocessing.connection.wait([p.sentinel for p in pending],
                                                timeout=deadline - time.monotonic())
                pending = [p for p in pending if p.exitcode is None]
                if any(p.exitcode for p in procs if p not in pending):
                    break
        finally:
            for p in pending:
                p.kill()
            for p in procs:
                p.join(30)
        errors = []
        for r in range(n):
            path = os.path.join(tmp, f"rank{r}.err")
            if os.path.exists(path):
                with open(path) as f:
                    errors.append(f"rank {r}:\n{f.read()}")
        if errors or any(p.exitcode for p in procs):
            codes = [p.exitcode for p in procs]
            if not errors and pending:
                raise TimeoutError(f"spawn_ranks: ranks still running after {timeout} s "
                                   f"(exit codes {codes})")
            raise RuntimeError(f"spawn_ranks: exit codes {codes}\n" + "\n".join(errors))
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(n)]


def tiny_model(n_a: int = 16, n_e: int = 3, T: int = 8, device="cuda"):
    """Krusell-Smith with an n_a-point double-exponential wealth grid on
    [0, 200] and an n_e-state Rouwenhorst income process (ρ 0.966, σ 0.283)
    (`__graft_entry__.py:105-117`)."""
    from hank_tpu_torch.model.grids import make_double_exponential_grid, rouwenhorst
    from hank_tpu_torch.model.structures import HeterogeneityDimension
    from hank_tpu_torch.models import load_model

    f64 = torch.float64
    model = load_model("krusell_smith", T=T, device=device)
    wealth = HeterogeneityDimension(
        "wealth", "endogenous", n_a,
        torch.tensor(make_double_exponential_grid(0.0, 200.0, n_a), dtype=f64, device=device),
        None, "KD")
    Pi, _, z = rouwenhorst(n_e, 0.966, 0.283)
    prod = HeterogeneityDimension("productivity", "exogenous", n_e,
                                  torch.tensor(z, dtype=f64, device=device),
                                  torch.tensor(Pi, dtype=f64, device=device), None)
    return dataclasses.replace(model, heterogeneity={"wealth": wealth, "productivity": prod})


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"dryrun_multichip: {msg}")


def _dryrun_rank(device, n: int) -> dict:
    """One rank's dry run (module docstring); returns its checks' numbers."""
    from hank_tpu_torch.blocks.backward import backward_iteration
    from hank_tpu_torch.blocks.forward import forward_iteration
    from hank_tpu_torch.parallel.ensemble import solve_ensemble
    from hank_tpu_torch.parallel.mesh import make_mesh
    from hank_tpu_torch.parallel.state_sharding import (backward_iteration_sharded,
                                                        forward_iteration_sharded)
    from hank_tpu_torch.solvers.newton import make_full_residual_fn
    from hank_tpu_torch.solvers.ss_jacobian import get_steady_state_jacobian
    from hank_tpu_torch.solvers.steady_state import find_ss

    f64 = torch.float64
    model = tiny_model(n_e=max(2, n), device=device)    # n_e = n: the state axis splits
    ss = find_ss(model, model.ss_initial, "dryrun")
    cs = model.compspec
    Tm1 = cs.T - 1
    out = {"ranks": n, "device": str(device)}

    # SP: J̄ with its seeds over gcd(n, n_endog) ranks (the others are not
    # in that mesh and keep the unsplit J̄).
    J_ref = get_steady_state_jacobian(ss, model)
    jac_mesh = make_mesh(math.gcd(n, cs.n_endog))
    Jbar = (get_steady_state_jacobian(ss, model, mesh=jac_mesh)
            if jac_mesh.get_coordinate() is not None else J_ref)
    out["sp_ranks"] = jac_mesh.size(0)
    out["sp_max_abs_vs_unsplit"] = float((Jbar - J_ref).abs().max())
    _require(bool(torch.isfinite(Jbar).all()) and out["sp_max_abs_vs_unsplit"] <= 1e-12,
             f"split J̄ off the unsplit one by {out['sp_max_abs_vs_unsplit']:.3e}")

    # TP: the household blocks with the exogenous axis over all n ranks.
    state_mesh = make_mesh(n, ("state",))
    endog = model.vars_of_type("endogenous")
    x0 = torch.stack([torch.as_tensor(ss.vars[k], dtype=f64, device=device)
                      for k in endog]).repeat(Tm1)
    t = torch.arange(1, cs.T, dtype=f64, device=device)
    exog_one = {"Z": 1.0 + 0.05 * 0.8 ** t}
    pol_sh = backward_iteration_sharded(x0, exog_one, model, ss.vars, ss.value, state_mesh)
    pol_ref = backward_iteration(x0, exog_one, model, ss.vars, ss.value)
    agg_sh = forward_iteration_sharded(pol_sh, model, ss.D, state_mesh)
    agg_ref = forward_iteration(pol_ref, model, ss.D)
    out["tp_max_abs_vs_unsplit"] = max(float((agg_sh[k] - agg_ref[k]).abs().max())
                                       for k in agg_ref)
    _require(out["tp_max_abs_vs_unsplit"] < 1e-9,
             f"state-split aggregates off by {out['tp_max_abs_vs_unsplit']:.3e}")

    # DP: 2n shock paths over all n ranks, both methods, against J̄.
    mesh = make_mesh(n)
    B = 2 * n
    rhos = 0.5 + 0.4 * torch.arange(B, dtype=f64, device=device) / B
    exog_batch = {"Z": 1.0 + 0.05 * rhos[:, None] ** t[None, :]}
    F0 = make_full_residual_fn(model, ss, ss, {k: v[0] for k, v in exog_batch.items()})
    for method in ("boehl", "newton_krylov"):
        x_paths, info = solve_ensemble(x0, Jbar, exog_batch, model, ss, ss, mesh=mesh,
                                       method=method, eps=1e-8)
        _require(x_paths.shape == (B, Tm1 * len(endog)), f"{method}: shape {x_paths.shape}")
        worst = float(info["residual_norm"].max())
        r0 = float(torch.linalg.norm(F0(x_paths[0])))
        _require(worst < 1e-8, f"{method} ensemble residual {worst:.3e}")
        _require(r0 < 1e-7, f"{method} row-0 plain f64 residual {r0:.3e}")
        out[f"dp_{method}"] = {"residual_norm_max": worst, "row0_plain_f64": r0,
                               "iterations": info["iterations"],
                               "inner_iterations": info["inner_iterations"]}
    return out


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """Spawn n_devices ranks (NCCL on the cards by default, gloo for
    device="cpu") and run the SP, TP and DP paths on each (module
    docstring); any failed check raises. Returns rank 0's numbers."""
    return spawn_ranks(_dryrun_rank, n_devices, n_devices, device=device)[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=None,
                    help="ranks to spawn (default: every visible card; ignored under torchrun)")
    ap.add_argument("--device", default=None, help="'cpu' for gloo ranks (default: the cards)")
    args = ap.parse_args(argv)
    if "RANK" in os.environ:
        dev = init_distributed(args.device)
        try:
            out = _dryrun_rank(dev, dist.get_world_size())
        finally:
            destroy_distributed()
        if int(os.environ["RANK"]) != 0:
            return 0
    else:
        n = args.n or (torch.cuda.device_count() if args.device in (None, "cuda") else 1)
        _require(n >= 1, "no card is visible; pass --device cpu for gloo ranks")
        out = dryrun_multichip(n, device=args.device)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
