"""Ensembles of shock paths on one GPU (port of `hank_tpu/parallel/ensemble.py`).

An ensemble is B perfect-foresight problems that share the model, both
steady states and J̄, and differ in their shock paths: x is (B, n) and each
exogenous path (B, T-1). The batch is a leading dimension, not a vmap of the
single-path solver. A host loop drives every path in lockstep through three
batched operations, by one of two routes:
  - the kernel route, for the one-asset CRRA EGM family
    (`supports_fused_sweep`) with f32 directions: F_b, the f64 residual of
    every row, has its household block in one launch of the batched kernel
    2 (`ops/fused_residual.make_sweep_residual_fn_batch`), and the direction
    map every row's f32 JVP in one launch of the batched kernel 1
    (`ops/fused_sweep_batch.make_fused_jvp_batch`, kernels 3-4); on CPU
    tensors the two kernels run their plain versions;
  - the plain route, for every other model or f64 directions
    (`hank_tpu/parallel/ensemble.py:76-95, 242-279`): F_b is
    `torch.func.vmap` of the plain f64 F, the direction map that of
    `torch.func.jvp` of F (f64) or of the single path's mixed-tail map
    (`solvers/newton.mixed_tail_map`, f32);
and J̄⁻¹ is applied to every row by one (B, n) × (n, n) f64 `torch.matmul`.

The reference's v5e width guard (`chunk`, `_probe_width_consistency` and the
row padding helpers), its `fused` switch and its `mesh` sharding are not
ported: the first two are TPU workarounds, the last waits on ROADMAP Queue
1's `parallel/mesh.py` and `parallel/state_sharding.py`.
"""

from __future__ import annotations

import time
from typing import Mapping

import numpy as np
import torch

from hank_tpu_torch.config import TINY, config
from hank_tpu_torch.ops.fused_residual import make_sweep_residual_fn_batch
from hank_tpu_torch.ops.fused_sweep_batch import make_fused_jvp_batch
from hank_tpu_torch.ops.linalg import make_reusable_solver, rayleigh_quotient
from hank_tpu_torch.ops.fused_sweep import supports_fused_sweep
from hank_tpu_torch.solvers.newton import (_boehl_alpha, _is_mixed, make_full_residual_fn,
                                           mixed_tail_map)

_NO_MESH = ("mesh= is not ported yet: sharding an ensemble over several cards "
            "waits on parallel/mesh.py and parallel/state_sharding.py (ROADMAP.md "
            "Queue 1)")

# solve_ensemble keyword arguments that solve_ensemble_host takes as they are
# (`hank_tpu/parallel/ensemble.py:121-124`).
_ROUTABLE = {"eps", "max_outer", "max_inner", "direction_dtype", "verbose", "records"}


def _rownorm(a: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(a, dim=-1)


def _plain_residual_batch(model, ss_initial, ss_ending):
    """F_b(x_b, exog_batch) of the plain route: `torch.func.vmap` of the
    plain f64 F of one row under that row's shock paths."""
    def F_one(x, ex):
        return make_full_residual_fn(model, ss_initial, ss_ending, ex)(x)

    return torch.func.vmap(F_one)


def residual_ensemble(x_batch: torch.Tensor,
                      exog_batch: Mapping[str, torch.Tensor],
                      model, ss_initial, ss_ending, mesh=None) -> torch.Tensor:
    """Batched f64 F(x) over an ensemble of (x, shock-path) pairs: batched
    kernel 2 for the one-asset family, the vmapped plain F otherwise.

    x_batch: (B, n_endog*(T-1)); exog_batch leaves: (B, T-1). Returns (B, n).
    """
    if mesh is not None:
        raise NotImplementedError(_NO_MESH)
    if supports_fused_sweep(model):
        return make_sweep_residual_fn_batch(model, ss_initial, ss_ending)(x_batch, exog_batch)
    return _plain_residual_batch(model, ss_initial, ss_ending)(x_batch, exog_batch)


def solve_ensemble(x0, Jbar, exog_batch, model, ss_initial, ss_ending, mesh=None,
                   method: str = "boehl", **solver_kwargs):
    """Solve the transition path for every shock in the ensemble.

    The reference traces its whole solver under `jax.vmap` off the TPU and
    routes to `solve_ensemble_host` on the TPU (`ensemble.py:120-140`). The
    port has the host-driven loop only, so this always routes to
    `solve_ensemble_host` and raises NotImplementedError for a method or
    keyword arguments that do not map onto it.
    """
    unknown = sorted(set(solver_kwargs) - _ROUTABLE)
    if method not in ("boehl", "newton_krylov") or unknown:
        raise NotImplementedError(
            "solve_ensemble runs through solve_ensemble_host, which takes "
            f"method 'boehl' or 'newton_krylov' and {sorted(_ROUTABLE)}; got "
            f"method={method!r}, unsupported {unknown}")
    return solve_ensemble_host(x0, Jbar, exog_batch, model, ss_initial, ss_ending,
                               mesh=mesh, method=method, **solver_kwargs)


def solve_ensemble_host(x0: torch.Tensor,
                        Jbar: torch.Tensor,
                        exog_batch: Mapping[str, torch.Tensor],
                        model, ss_initial, ss_ending,
                        mesh=None,
                        eps: float = 1e-8,
                        max_outer: int | None = None,
                        max_inner: int = 500,
                        inner_eta: float = 1e-5,
                        direction_dtype=torch.float32,
                        method: str = "boehl",
                        gmres_m: int = 30,
                        verbose: bool = False,
                        records: list | None = None) -> tuple[torch.Tensor, dict]:
    """Lockstep batched solve of every path, driven from the host.

    x0: (n,) shared guess (broadcast) or (B, n). exog_batch leaves: (B, T-1).

    method: "boehl" (default) runs the lockstep Richardson y-iteration
    (`hank_tpu/parallel/ensemble.py:450-519`): keep-best per path, revert
    non-finite rows, freeze rows that stalled. "newton_krylov" runs the
    lockstep inexact Newton with a host-driven batched GMRES
    (`_run_ensemble_nk`, `:522-702`); gmres_m is its Arnoldi length.
    direction_dtype: torch.float32 (default) or None / torch.float64; the
    kernel route with f32 directions for the one-asset family, the plain
    route otherwise (module docstring).

    Returns (x (B, n), info) with a (B,) "residual_norm", the lockstep counts
    "iterations" (outers) and "inner_iterations" (direction sweeps), and
    "stalled_paths"; newton_krylov adds "host_ls_seconds", the host clock
    spent in the per-path Hessenberg least squares.
    """
    if mesh is not None:
        raise NotImplementedError(_NO_MESH)
    if method not in ("boehl", "newton_krylov"):
        raise ValueError(f"method={method!r}: expected 'boehl'|'newton_krylov'")
    mixed = _is_mixed(direction_dtype)
    x_dtype = config.dtype
    B = next(iter(exog_batch.values())).shape[0]
    n = x0.shape[-1]
    x = x0.to(x_dtype).expand(B, n).clone() if x0.dim() == 1 else x0.to(x_dtype)
    max_outer = max_outer or config.path_newton_max_iter

    if mixed and supports_fused_sweep(model):
        F_b = make_sweep_residual_fn_batch(model, ss_initial, ss_ending)
        jvp_kernel = make_fused_jvp_batch(model, ss_initial, ss_ending)

        def jvp_b(x, v):
            return jvp_kernel(x, v, exog_batch).to(x_dtype)
    else:
        F_b = _plain_residual_batch(model, ss_initial, ss_ending)
        jvp_mixed = mixed_tail_map(model, ss_initial, ss_ending)[0] if mixed else None

        def jvp_one(x, v, ex):
            if mixed:
                return jvp_mixed(x, v, ex)
            F = make_full_residual_fn(model, ss_initial, ss_ending, ex)
            return torch.func.jvp(F, (x,), (v,))[1]

        jvp_vmapped = torch.func.vmap(jvp_one)

        def jvp_b(x, v):
            return jvp_vmapped(x, v, exog_batch)
    A_inv_T = make_reusable_solver(Jbar).A_inv.to(x_dtype).T

    def solve_b(Y):
        return Y @ A_inv_T

    if method == "newton_krylov":
        return _run_ensemble_nk(x, exog_batch, F_b, lambda x, v: solve_b(jvp_b(x, v)),
                                solve_b, eps=eps, max_outer=max_outer, gmres_m=gmres_m,
                                gmres_tol=3e-7 if mixed else 1e-12, verbose=verbose,
                                records=records)

    ray_b = torch.func.vmap(rayleigh_quotient)

    def inner_step(x, y, Fx, tol):
        """One lockstep Richardson sweep over all B paths."""
        Lxy = jvp_b(x, y)
        R = solve_b(Fx - Lxy)
        alpha = _boehl_alpha(ray_b(solve_b(Lxy), y))
        rnorm = _rownorm(R)
        return torch.where((rnorm > tol)[:, None], y + alpha[:, None] * R, y), rnorm

    y = torch.zeros_like(x)
    Fx = F_b(x, exog_batch)
    fnorm = _rownorm(Fx)
    # Per-path resilience: keep the best iterate per path, revert non-finite
    # rows to it, and freeze rows that have stalled, so one infeasible shock
    # cannot poison or fail the other B-1 paths.
    x_best, F_best, f_best = x, Fx, fnorm
    since_improve = torch.zeros(B, dtype=torch.int32, device=x.device)
    frozen = ~torch.isfinite(fnorm)
    inf = torch.full((B,), float("inf"), dtype=x_dtype, device=x.device)
    iters = total_inner = 0
    while bool(((fnorm > eps) & ~frozen).any()) and iters < max_outer:
        tol = torch.clamp(inner_eta * _rownorm(solve_b(Fx)), min=TINY)
        rnorm, best_r, y_best = inf, inf, y
        diverged = frozen            # frozen rows sit out the inner loop too
        inner_its = 0
        while bool(((rnorm > tol) & ~diverged).any()) and inner_its < max_inner:
            y_prev = y
            y, rnorm = inner_step(x, y, Fx, tol)
            y_best = torch.where((rnorm < best_r)[:, None], y_prev, y_best)
            best_r = torch.minimum(best_r, rnorm)
            diverged = (diverged | ~torch.isfinite(rnorm)
                        | (rnorm > 10.0 * torch.maximum(best_r, tol)))
            inner_its += 1
        # Inner divergence (indefinite preconditioned operator at a kink or
        # the noise floor): keep that row's best inner iterate.
        y = torch.where(diverged[:, None], y_best, y)
        x_new = torch.where((fnorm > eps)[:, None], x - y, x)
        Fx_new = F_b(x_new, exog_batch)
        fn_new = _rownorm(Fx_new)
        bad = ~torch.isfinite(fn_new)
        x = torch.where(frozen[:, None], x, torch.where(bad[:, None], x_best, x_new))
        Fx = torch.where(frozen[:, None], Fx, torch.where(bad[:, None], F_best, Fx_new))
        fnorm = torch.where(frozen, fnorm, torch.where(bad, f_best, fn_new))
        y = torch.where((bad | frozen)[:, None], torch.zeros_like(y), y)
        since_improve = torch.where(fnorm < 0.5 * f_best, 0, since_improve + 1)
        improved = fnorm < f_best
        x_best = torch.where(improved[:, None], x, x_best)
        F_best = torch.where(improved[:, None], Fx, F_best)
        f_best = torch.where(improved, fnorm, f_best)
        frozen = frozen | (since_improve >= 4)
        iters += 1
        total_inner += inner_its
        n_conv = int((fnorm <= eps).sum())
        n_stall = int((frozen & (fnorm > eps)).sum())
        if verbose:
            print(f"[ensemble/host] outer {iters}: max|F| = "
                  f"{float(torch.where(frozen, 0.0, fnorm).max()):.3e}, "
                  f"{n_conv}/{B} converged, {n_stall} stalled "
                  f"(+{inner_its} sweeps)", flush=True)
        if records is not None:
            records.append({"iteration": iters, "max_residual_norm": float(fnorm.max()),
                            "converged": n_conv, "stalled": n_stall,
                            "inner_sweeps": inner_its})
    better = f_best < fnorm
    x = torch.where(better[:, None], x_best, x)
    fnorm = torch.where(better, f_best, fnorm)
    return x, {"iterations": iters, "inner_iterations": total_inner,
               "residual_norm": fnorm,
               "stalled_paths": int((frozen & (fnorm > eps)).sum())}


def _ls_rrel(H: np.ndarray, bn: np.ndarray, k: int):
    """Per-path Hessenberg least squares on the host in numpy f64: y (B, k)
    and the relative GMRES residual of each path."""
    B = H.shape[0]
    y = np.zeros((B, k))
    rrel = np.ones(B)
    for b in range(B):
        if bn[b] <= TINY:
            rrel[b] = 0.0
            continue
        Hb = H[b, :k + 1, :k]
        e1 = np.zeros(k + 1)
        e1[0] = bn[b]
        yb, *_ = np.linalg.lstsq(Hb, e1, rcond=None)
        y[b] = yb
        rrel[b] = float(np.linalg.norm(Hb @ yb - e1)) / bn[b]
    return y, rrel


def _run_ensemble_nk(x, exog_batch, F_b, matvec, solve_b, *, eps: float,
                     max_outer: int, gmres_m: int, gmres_tol: float, verbose: bool,
                     records: list | None) -> tuple[torch.Tensor, dict]:
    """Lockstep batched inexact Newton with a host-driven batched GMRES
    (`hank_tpu/parallel/ensemble.py:522-702`).

    Each outer solves J̄⁻¹J_x·dx = −J̄⁻¹F per path with one shared Arnoldi
    schedule: every Arnoldi step is one lockstep batched matvec. The Krylov
    basis is a zero-padded (B, m+1, n) tensor, written in place row by row;
    each step brings the new Hessenberg column and norms to the host, where
    the per-path (k+1, k) least squares runs in numpy f64. Per-path
    Eisenstat-Walker forcing, one restart from the deflated residual,
    lockstep backtracking with per-path halving, and keep-best/freeze.
    """
    B, n = x.shape
    m = gmres_m
    dtype, device = x.dtype, x.device
    ls_seconds = 0.0

    def normalize(w):
        wn = _rownorm(w)
        v = torch.where((wn > TINY)[:, None], w / torch.clamp(wn, min=TINY)[:, None],
                        torch.zeros_like(w))
        return v, wn

    def gmres_cycle(x, r0, eta, active):
        """One lockstep Arnoldi cycle; stops early once every active path's
        projected residual meets its forcing tolerance."""
        nonlocal ls_seconds
        bn = _rownorm(r0).cpu().numpy()
        Vs = torch.zeros((B, m + 1, n), dtype=dtype, device=device)
        Vs[:, 0] = normalize(r0)[0]
        H = np.zeros((B, m + 1, m))
        k = 0
        y = np.zeros((B, 0))
        rrel = np.where(bn > TINY, 1.0, 0.0)
        for j in range(m):
            w = matvec(x, Vs[:, j])
            # CGS2 against the zero-padded basis: padded rows contribute 0.
            h1 = torch.einsum("bkn,bn->bk", Vs, w)
            w = w - torch.einsum("bk,bkn->bn", h1, Vs)
            h2 = torch.einsum("bkn,bn->bk", Vs, w)
            w = w - torch.einsum("bk,bkn->bn", h2, Vs)
            v_next, wn = normalize(w)
            Vs[:, j + 1] = v_next
            hw = torch.cat([h1 + h2, wn[:, None]], dim=1).cpu().numpy()
            if not np.isfinite(hw).all():
                break                      # the caller keeps its best iterate
            H[:, :, j] = hw[:, :m + 1]
            H[:, j + 1, j] = hw[:, m + 1]
            k = j + 1
            t0 = time.perf_counter()
            y, rrel = _ls_rrel(H, bn, k)
            ls_seconds += time.perf_counter() - t0
            if not (active & (rrel > eta)).any():
                break
        if k == 0:
            return torch.zeros_like(r0), rrel, 0
        y_pad = np.zeros((B, m + 1))
        y_pad[:, :k] = y
        dx = torch.einsum("bk,bkn->bn", torch.as_tensor(y_pad, dtype=dtype, device=device),
                          Vs)
        return dx, rrel, k

    Fx = F_b(x, exog_batch)
    fnorm = _rownorm(Fx)
    x_best, F_best, f_best = x, Fx, fnorm
    since_improve = torch.zeros(B, dtype=torch.int32, device=device)
    frozen = ~torch.isfinite(fnorm)
    fprev = fnorm.cpu().numpy()          # first-outer forcing: eta clips to 0.5
    iters = total_mv = 0
    while bool(((fnorm > eps) & ~frozen).any()) and iters < max_outer:
        fn_np = fnorm.cpu().numpy()
        active = ~frozen.cpu().numpy() & (fn_np > eps)
        # Eisenstat-Walker (choice 2) per path, floored at the direction
        # noise and at what the final target still requires.
        eta = np.clip(0.9 * (fn_np / np.maximum(fprev, TINY)) ** 2, gmres_tol, 0.5)
        eta = np.maximum(eta, 0.1 * eps / np.maximum(fn_np, TINY))
        b_rhs = -solve_b(Fx)
        dx, rrel, mv = gmres_cycle(x, b_rhs, eta, active)
        total_mv += mv
        if mv and (active & (rrel > eta)).any():
            # One restart from the deflated residual: a cycle that hit m
            # without meeting the forcing term usually still made progress.
            r = b_rhs - matvec(x, dx)
            total_mv += 1
            if bool(torch.isfinite(_rownorm(r)).all()):
                dx2, _, mv2 = gmres_cycle(x, r, eta, active)
                dx = dx + dx2
                total_mv += mv2
        # Lockstep backtracking: per-path step halving, accepted paths hold.
        accepted = frozen | (fnorm <= eps)
        alpha = torch.ones(B, dtype=dtype, device=device)
        x_new, Fx_new, fn_new = x, Fx, fnorm
        for _ in range(6):
            x_try = torch.where(accepted[:, None], x_new, x + alpha[:, None] * dx)
            Fx_try = F_b(x_try, exog_batch)
            fn_try = _rownorm(Fx_try)
            ok = ~accepted & torch.isfinite(fn_try) & (fn_try < fnorm)
            x_new = torch.where(ok[:, None], x_try, x_new)
            Fx_new = torch.where(ok[:, None], Fx_try, Fx_new)
            fn_new = torch.where(ok, fn_try, fn_new)
            accepted = accepted | ok
            if bool(accepted.all()):
                break
            alpha = torch.where(accepted, alpha, 0.5 * alpha)
        fprev = fn_np
        x, Fx, fnorm = x_new, Fx_new, fn_new
        improved = fnorm < f_best
        x_best = torch.where(improved[:, None], x, x_best)
        F_best = torch.where(improved[:, None], Fx, F_best)
        f_best = torch.where(improved, fnorm, f_best)
        since_improve = torch.where(
            fnorm < 0.99 * torch.as_tensor(fprev, dtype=dtype, device=device),
            0, since_improve + 1)
        frozen = frozen | (since_improve >= 3)
        iters += 1
        n_conv = int((fnorm <= eps).sum())
        n_stall = int((frozen & (fnorm > eps)).sum())
        if verbose:
            print(f"[ensemble/nk] outer {iters}: max|F| = "
                  f"{float(torch.where(frozen, 0.0, fnorm).max()):.3e}, "
                  f"{n_conv}/{B} converged, {n_stall} stalled "
                  f"(+{mv} matvecs)", flush=True)
        if records is not None:
            records.append({"iteration": iters, "max_residual_norm": float(fnorm.max()),
                            "converged": n_conv, "stalled": n_stall,
                            "matvecs": total_mv})
    better = f_best < fnorm
    x = torch.where(better[:, None], x_best, x)
    fnorm = torch.where(better, f_best, fnorm)
    return x, {"iterations": iters, "inner_iterations": total_mv,
               "residual_norm": fnorm,
               "stalled_paths": int((frozen & (fnorm > eps)).sum()),
               "host_ls_seconds": ls_seconds}
