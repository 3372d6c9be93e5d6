"""End-to-end driver: model -> steady states -> J̄ -> transition path (port
of `hank_tpu/run.py`, `RunMain.jl:12-61`).

Build the model, solve its steady states, compute the steady-state
sequence-space Jacobian, generate the shock path, run the path solver, and
report and save the solved transition. A library call (`solve_model`) or a
CLI that runs on the card unless `--device cpu` asks otherwise:

    python -m hank_tpu_torch.run --model hank_one_asset --mixed --out /tmp/path.csv
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time

import numpy as np
import torch

METHODS = ("newton_krylov", "boehl", "dense", "linear")
WARM_STARTS = ("ss", "linear")


def _accept_warm_start(x_ss, x_lin, lin_info, verbose):
    """Keep-best guard for `warm_start="linear"`: on a shock large enough
    that the linear step lands infeasible (non-finite residual) or does not
    improve on the first-order forcing ‖F(x_ss)‖, start the nonlinear
    solver from the steady-state path instead."""
    r_lin = float(lin_info["residual_norm"])
    if math.isfinite(r_lin) and r_lin < float(lin_info["f0_norm"]):
        return x_lin
    if verbose:
        print(f"[warm_start=linear] linear step rejected "
              f"(‖F(x_lin)‖ = {r_lin:.3g} vs forcing "
              f"{float(lin_info['f0_norm']):.3g}) — starting from the SS path")
    return x_ss


def solve_model(model, exog_paths=None, *, method: str = "newton_krylov",
                direction_dtype=None, eps: float = 1e-8, verbose: bool = True,
                cache: bool = True, records: list | None = None,
                residual_mode: str = "auto", warm_start: str = "ss",
                **solver_kwargs):
    """Full solve: steady states + J̄ (cached, `utils/checkpoint.get_or_solve`)
    + transition path, on the model's device.

    method: "newton_krylov" | "boehl" (`make_path_solver`), "dense"
    (`solve_path_dense`) or "linear" (the first-order IRF,
    `solvers/linear.py`). warm_start: the nonlinear solvers' initial guess,
    "ss" (the steady-state path) or "linear" (the first-order IRF, kept only
    when it beats the forcing). Extra keyword arguments go to
    `make_path_solver`. Unlike the reference (ADVICE.md), the arguments are
    checked before the dispatch: `warm_start` and solver keyword arguments
    are refused on the "linear" and "dense" branches, which do not use them.

    Returns (x_path (T-1, n_endog) numpy, info, ss_initial, ss_ending).
    """
    from hank_tpu_torch.model.structures import generate_exog_paths
    from hank_tpu_torch.solvers.newton import make_path_solver, solve_path_dense
    from hank_tpu_torch.utils.checkpoint import get_or_solve
    from hank_tpu_torch.utils.timing import phase

    if method not in METHODS:
        raise ValueError(f"method must be one of {METHODS}, got {method!r}")
    if warm_start not in WARM_STARTS:
        raise ValueError(f"warm_start must be 'ss' or 'linear', got {warm_start!r}")
    if method in ("linear", "dense"):
        if warm_start != "ss":
            raise ValueError(f"warm_start={warm_start!r} applies only to the iterative "
                             f"solvers, not to method={method!r}")
        if solver_kwargs:
            raise ValueError(f"solver options {sorted(solver_kwargs)} apply only to the "
                             f"iterative solvers, not to method={method!r}")

    recs = records if records is not None else []
    with phase("steady states + SS Jacobian", recs, verbose):
        ss0, ssT, Jbar = get_or_solve(model, verbose=verbose, cache=cache)

    Tm1 = model.compspec.T - 1
    if exog_paths is None:
        exog_paths = generate_exog_paths(model, Tm1)

    endog = model.vars_of_type("endogenous")
    x0 = torch.stack([torch.as_tensor(ssT.vars[k]) for k in endog]).repeat(Tm1)

    if method == "linear":
        from hank_tpu_torch.solvers.linear import linear_impulse_response

        with phase("linear impulse response", recs, verbose):
            x, info = linear_impulse_response(Jbar, exog_paths, model, ss0, ssT)
        info = {"iterations": 1, "residual_norm": info["residual_norm"],
                "f0_norm": info["f0_norm"]}
    elif method == "dense":
        with phase("path solve (dense)", recs, verbose):
            x, info = solve_path_dense(x0, exog_paths, model, ss0, ssT, eps=eps)
    else:
        if warm_start == "linear":
            from hank_tpu_torch.solvers.linear import linear_impulse_response

            with phase("linear warm start", recs, verbose):
                x_lin, lin_info = linear_impulse_response(Jbar, exog_paths, model, ss0, ssT)
                x0 = _accept_warm_start(x0, x_lin, lin_info, verbose)
        solver = make_path_solver(Jbar, exog_paths, model, ss0, ssT,
                                  method=method, direction_dtype=direction_dtype,
                                  eps=eps, verbose=verbose, records=records,
                                  residual_mode=residual_mode, **solver_kwargs)
        with phase("path solve", recs, verbose):
            x, info = solver(x0)
    x_path = x.detach().cpu().numpy().reshape(Tm1, len(endog))
    return x_path, info, ss0, ssT


def main(argv=None) -> dict:
    """The CLI; prints the run's summary as JSON and returns it."""
    parser = argparse.ArgumentParser(description="hank_tpu_torch end-to-end solver")
    parser.add_argument("--model", default="krusell_smith",
                        help="shipped model name or path to a YAML spec")
    parser.add_argument("--T", type=int, default=None, help="override horizon")
    parser.add_argument("--method", default="newton_krylov", choices=list(METHODS),
                        help="'linear' = first-order IRF (one preconditioned "
                             "Newton step, solvers/linear.py)")
    parser.add_argument("--mixed", action="store_true",
                        help="f32 directions (inexact Newton): the CUDA kernels where the "
                             "model has a kernel pair, else the mixed-tail map")
    parser.add_argument("--eps", type=float, default=1e-8)
    parser.add_argument("--warm-start", default="ss", choices=list(WARM_STARTS),
                        help="nonlinear-solver initial guess: steady-state "
                             "path or the first-order IRF (solvers/linear.py)")
    parser.add_argument("--residual-mode", default="auto", choices=["auto", "ds", "f64"],
                        help="full-precision residual: an FP64 residual kernel "
                             "(auto/ds: kernel 2, or the two-asset pair; "
                             "solvers/newton.residual_route) or the plain f64 pipeline")
    parser.add_argument("--direction-mode", default="auto", choices=["auto", "xla", "pallas"],
                        help="direction route (solvers/newton.py): 'auto' the CUDA kernels "
                             "where the model has them, 'xla' AD of the plain pipeline, which "
                             "also takes grids past the kernels' shared memory")
    parser.add_argument("--device", default="cuda",
                        help="torch device of the model and the solve (default: cuda)")
    parser.add_argument("--out", default=None, help="CSV output path")
    parser.add_argument("--plot", default=None, metavar="PNG",
                        help="write a transition-path plot (RunMain.jl:57-60)")
    parser.add_argument("--no-cache", action="store_true")
    args = parser.parse_args(argv)

    from hank_tpu_torch.model.parser import build_model_from_yaml
    from hank_tpu_torch.models import SHIPPED, load_model

    if args.model in SHIPPED:
        model = load_model(args.model, device=args.device,
                           **({"T": args.T} if args.T else {}))
    else:
        model = build_model_from_yaml(args.model, device=args.device)
        if args.T:
            model = dataclasses.replace(
                model, compspec=dataclasses.replace(model.compspec, T=args.T))

    t0 = time.time()
    x_path, info, ss0, ssT = solve_model(
        model, method=args.method,
        direction_dtype=torch.float32 if args.mixed else None,
        eps=args.eps, cache=not args.no_cache,
        residual_mode=args.residual_mode, warm_start=args.warm_start,
        **({} if args.direction_mode == "auto" else {"direction_mode": args.direction_mode}))
    wall = time.time() - t0

    endog = model.vars_of_type("endogenous")
    summary = {
        "model": model.name or args.model,
        "T": model.compspec.T,
        "method": args.method + ("-mixed" if args.mixed else ""),
        "iterations": int(info["iterations"]),
        "residual_norm": float(info["residual_norm"]),
        "wall_seconds": round(wall, 2),
        "impact": {k: float(x_path[0, i]) for i, k in enumerate(endog)},
        "terminal": {k: float(x_path[-1, i]) for i, k in enumerate(endog)},
    }
    print(json.dumps(summary, indent=2))

    if args.out:
        header = ",".join(("t",) + endog)
        rows = np.column_stack([np.arange(1, x_path.shape[0] + 1), x_path])
        np.savetxt(args.out, rows, delimiter=",", header=header, comments="")
        print(f"path written to {args.out}")

    if args.plot:
        from hank_tpu_torch.utils.plotting import plot_transition

        plot_transition(x_path, endog, args.plot, ss_initial=ss0,
                        ss_ending=ssT, title=summary["model"])
        print(f"plot written to {args.plot}")
    return summary


if __name__ == "__main__":
    main()
