"""Path solver: matrix-free Newton-Krylov (port of the `newton_krylov`
branch of `hank_tpu/solvers/newton.py`).

Every outer iteration, as in the reference's traced `run` (`:1072-1090`)
with the full-precision residual kernel active:
  1. F(x) in full precision from kernel 2 (`ops/fused_residual.py`);
  2. the Newton step from `gmres_matfree`, whose matvecs are f32 JVP sweeps
     from kernel 1 (`ops/fused_sweep.py`), left-preconditioned by one f32
     matvec with the precomputed J̄⁻¹ (`:910-914`);
  3. backtracking with strict descent, halving the step at most 6 times
     (`:918-970`).
The loop stops at ‖F‖ ≤ eps, at `max_outer`, or when an outer finds no
descent; a stall warns and returns the incumbent.

The f32 J̄⁻¹ matvec is a plain `torch.matmul`; TF32 must be off for it
(`torch.backends.cuda.matmul.allow_tf32 = False`, the default), and the
solver refuses to run otherwise.
"""

from __future__ import annotations

import math
import warnings
from typing import Callable, Mapping

import torch

from hank_tpu_torch.blocks.assemble import assemble_full_xmat, residuals as eval_residuals
from hank_tpu_torch.blocks.backward import backward_iteration
from hank_tpu_torch.blocks.forward import forward_iteration
from hank_tpu_torch.config import TINY, config
from hank_tpu_torch.ops.fused_residual import make_sweep_residual_fn
from hank_tpu_torch.ops.fused_sweep import make_fused_jvp_dir
from hank_tpu_torch.ops.linalg import gmres_matfree, make_reusable_solver


def make_full_residual_fn(model, ss_initial, ss_ending,
                          exog_paths: Mapping[str, torch.Tensor]) -> Callable:
    """The equilibrium map F(x) through the plain blocks
    (`NewtonRaphson.jl:77-83`); differentiable with `torch.func.jvp`."""
    def F(x):
        policies = backward_iteration(x, exog_paths, model, ss_ending.vars,
                                      ss_ending.value)
        aggs = forward_iteration(policies, model, ss_initial.D)
        x_mat = assemble_full_xmat(x, aggs, exog_paths, model,
                                   ss_initial.vars, ss_ending.vars)
        return eval_residuals(x_mat, model)
    return F


def _check_finite(fnorm: float, method: str, iteration: int, x: torch.Tensor) -> None:
    """Raise on a non-finite residual norm (`SteadyState.jl:199` safe_eval).
    With strict-descent backtracking this means even the INITIAL residual
    was non-finite."""
    if not math.isfinite(fnorm):
        n_bad = int((~torch.isfinite(x)).sum())
        raise FloatingPointError(
            f"[{method}] non-finite residual norm {fnorm} at outer iteration "
            f"{iteration} ({n_bad}/{x.numel()} non-finite entries in x). "
            "Likely an infeasible aggregate path (e.g. r < -1); loosen the "
            "shock or start closer to the steady state.")


def _boehl_alpha(ray: torch.Tensor) -> torch.Tensor:
    """Adaptive Richardson step size from the Rayleigh-quotient estimate
    (`hank_tpu/solvers/newton.py:84-94`). The inner iteration is
    y ← y + α(J̄⁻¹F − J̄⁻¹J y); with P = J̄⁻¹J it converges for
    α < 2/λ_max(P), and ray = ⟨y, Py⟩/⟨y, y⟩ tracks the dominant curvature
    along y, so α = 1/max(ray, 1) keeps the spectral radius of (I − αP)
    below 1 while taking full steps when P ≈ I. Clipped to [0.05, 1]."""
    return torch.clamp(1.0 / torch.clamp(ray, min=1.0), 0.05, 1.0)


def newton_raphson_hank(x0, Jbar, exog_paths, model, ss_initial, ss_ending,
                        **kwargs):
    """Solve F(x) = 0 for the perfect-foresight path; one-shot form of
    `make_path_solver(...)(x0)`. Returns (x, info) with info =
    {"iterations", "residual_norm"}."""
    return make_path_solver(Jbar, exog_paths, model, ss_initial, ss_ending,
                            **kwargs)(x0)


def make_path_solver(
    Jbar: torch.Tensor,
    exog_paths: Mapping[str, torch.Tensor],
    model,
    ss_initial,
    ss_ending,
    *,
    eps: float = 1e-9,
    method: str = "newton_krylov",
    max_outer: int | None = None,
    gmres_restart: int = 20,
    gmres_maxiter: int = 2,
    direction_dtype=torch.float32,
    records: list | None = None,
):
    """Build a reusable path solver `run(x0) -> (x, info)`.

    method: only "newton_krylov" is ported; "boehl" (and the reference's
      stall rescue into it) raises NotImplementedError.
    direction_dtype: only torch.float32 (kernel-1 directions) is ported.
    records: optional list, appended one dict per outer iteration.
    """
    if method == "boehl":
        raise NotImplementedError(
            "method='boehl' is not ported yet: ROADMAP.md, next items "
            "(the boehl branch and its stall rescue)")
    if method != "newton_krylov":
        raise ValueError(f"unknown method '{method}' (expected 'newton_krylov')")
    if direction_dtype != torch.float32:
        raise NotImplementedError(
            "only direction_dtype=torch.float32 (kernel-1 directions) is ported")
    if Jbar.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("torch.backends.cuda.matmul.allow_tf32 must be False: "
                           "the f32 J̄⁻¹ preconditioner needs full f32 products")

    F = make_sweep_residual_fn(model, ss_initial, ss_ending, exog_paths)
    jvp_dir32 = make_fused_jvp_dir(model, ss_initial, ss_ending, exog_paths)
    solve_jbar = make_reusable_solver(Jbar)
    Jinv32 = solve_jbar.A_inv.to(torch.float32)
    max_outer = config.path_newton_max_iter if max_outer is None else max_outer
    gmres_tol = 3e-7      # f32 operator floor: no more than the JVP noise

    def precond(v):
        return (Jinv32 @ v.to(torch.float32)).to(v.dtype)

    def nk_step(x, Fx, fnorm, fnorm_prev):
        # Eisenstat-Walker (choice 2) forcing, floored at the direction
        # noise and at what the final target still requires.
        eta = min(max(0.9 * (fnorm / fnorm_prev) ** 2, gmres_tol), 0.5)
        eta = max(eta, 0.1 * eps / max(fnorm, TINY))
        d, _ = gmres_matfree(lambda v: jvp_dir32(x, v).to(x.dtype), Fx,
                             x0=solve_jbar(Fx), M=precond, tol=eta, atol=0.0,
                             restart=gmres_restart, maxiter=gmres_maxiter)
        # Backtracking: halve the step until the residual decreases (≤ 6
        # halvings); a full step that descends costs no extra residual.
        alpha = 1.0
        x_t = x - d
        Fx_t = F(x_t)
        fn_t = float(torch.linalg.norm(Fx_t))
        tries = 0
        while not (math.isfinite(fn_t) and fn_t < fnorm) and tries < 6:
            alpha *= 0.5
            x_t = x - alpha * d
            Fx_t = F(x_t)
            fn_t = float(torch.linalg.norm(Fx_t))
            tries += 1
        # Strict descent: keep the incumbent if every halving failed.
        if math.isfinite(fn_t) and fn_t < fnorm:
            return x_t, Fx_t, fn_t
        return x, Fx, fnorm

    def run(x0):
        x = x0
        Fx = F(x0)
        fnorm = fprev = float(torch.linalg.norm(Fx))
        _check_finite(fnorm, "newton_krylov", 0, x)
        iters = 0
        while fnorm > eps and iters < max_outer and (iters == 0 or fnorm < fprev):
            x, Fx, fn = nk_step(x, Fx, fnorm, fprev)
            fprev, fnorm = fnorm, fn
            iters += 1
            if records is not None:
                records.append({"iteration": iters, "residual_norm": fnorm})
        if fnorm > eps and iters and fnorm >= fprev:
            warnings.warn(f"[newton_krylov] stalled at |F| = {fnorm:.3e} after "
                          f"{iters} outer iterations (no descent direction found)")
        return x, {"iterations": iters, "residual_norm": fnorm}

    return run
