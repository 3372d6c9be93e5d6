"""Path solvers: Boehl (2024) quasi-Newton and matrix-free Newton-Krylov
(port of `hank_tpu/solvers/newton.py`).

Both methods keep the residuals in f64 and take their search directions
in f64 by default (`direction_dtype=None`) or in f32
(`direction_dtype=torch.float32`), by the route `direction_mode` picks
(`:394-494`). With f32 directions (`direction_route`):
  - "pallas", the kernel route: the model's f32 kernel pair, kernel 1
    (`ops/fused_sweep.py`) for the one-asset CRRA EGM family
    (`supports_fused_sweep`), kernels 5-6 (`ops/fused_sweep2.py`) for the
    two-asset Calvo-access family (`supports_fused_sweep2`), their plain
    versions on CPU tensors; ValueError for any other model (`:419-426`);
  - "xla", the mixed-tail map (`mixed_tail_map`): the household blocks in
    f32, the assembly and residual tail in f64, AD by `torch.func.jvp`;
  - "auto": the kernel route where a kernel pair supports the model and
    the model's arrays are on the card, else the mixed-tail map.
With f64 directions (`f64_direction_route`), a departure from the
reference, whose f64 directions ignore `direction_mode` and are always XLA
AD of the f64 pipeline (`:389`):
  - "auto": the f64 sweep kernel (`ops/fused_sweep.fused_sweep_jvp_f64`,
    `household_sweep_ranged_kernel<double, true, false>`) for the one-asset
    family on the card, else `torch.func.jvp` of the plain f64 pipeline
    (always on CPU tensors);
  - "xla": `torch.func.jvp` of the plain f64 pipeline;
  - "pallas": the f64 sweep kernel, its plain version on CPU tensors;
    ValueError for a model outside the one-asset family.
The boehl endgame's "f64-ad" rung is the f64 direction route under f64
directions and AD of the plain f64 pipeline under f32 ones. Residuals
(`residual_route`) come from the native-f64 kernel 2
(`ops/fused_residual.py`) for the one-asset family unless
`residual_mode="f64"`; for the two-asset family from the f64 kernel pair
(`ops/fused_residual2.py`) on the card ("auto") or on any device ("ds"),
a departure from the reference, which keeps that F on XLA; else from the
plain f64 pipeline.
On the card every one-asset kernel route decides by the model's grid,
before any launch, between two hand-written kernels (`sweep_setup`,
`fused_sweep.sweep_kernel`): the one-block kernel where its shared memory
takes the grid, else its global-state instantiation
(`household_sweep_ranged_kernel<S, TANGENT, BATCHED, true>`, the state in
a global workspace; at n_e = 7 it takes n_a ≤ 4980 for the f64 tangent
sweep, ≤ 5390 for kernel 2, ≤ 10792 in kernel 1's place). Past that
one's count, and past kernels 5-6's or the f64 pair's for the two-asset
family (`fused_sweep2._build_fused2`), the route raises ValueError when
the solver is built, naming the plain routes ("xla", "f64") that take the
grid: a departure from the reference, which probes its kernel and
degrades to XLA with a warning (`:356-376, 431-450`).

method="newton_krylov" (`:900-1069`): per outer, the Newton step from
`gmres_matfree` over the direction operator, left-preconditioned by one
matvec with the precomputed J̄⁻¹; backtracking with strict descent. With
f32 directions and a residual that is not kernel 2, the early outers run
on the f32 residual of the same route until ‖F‖ ≤ max(1e-3, 100·eps)
(`:975-1025`). When an outer finds no descent, `stall_rescue` hands the
iterate to the host-inner boehl solver (`:1026-1055`).

method="boehl" (`:499-898`): the y-iteration y ← y + α(J̄⁻¹F − J̄⁻¹J y)
with the adaptive Rayleigh-quotient step α, per outer. With
`host_inner=True` the Richardson phase stops at its noise floor and a
host-driven preconditioned GMRES endgame (`_host_pgmres`) takes over, with
a Levenberg-Marquardt damping and an operator ladder f32 → f64-ad → fd
(ad → fd with f64 directions; `endgame="auto"` is "jvp", as the reference
resolves it off a TPU).

`solve_path_dense` (`:1097-1129`) is dense Newton with the Jacobian by
`torch.func.jacfwd`: the small-T ground truth of the tests.

The f32 J̄⁻¹ matvec of Newton-Krylov is a plain `torch.matmul`; TF32 must
be off for it (`torch.backends.cuda.matmul.allow_tf32 = False`, the
default), and the solver refuses to run otherwise.
"""

from __future__ import annotations

import math
import time
import warnings
from typing import Callable, Mapping

import numpy as np
import torch

from hank_tpu_torch.blocks.assemble import assemble_full_xmat, residuals as eval_residuals
from hank_tpu_torch.blocks.backward import backward_iteration
from hank_tpu_torch.blocks.forward import forward_iteration
from hank_tpu_torch.config import TINY, config
from hank_tpu_torch.ops.fused_residual import make_sweep_residual_fn
from hank_tpu_torch.ops.fused_residual2 import make_fused2_residual_fn_f64
from hank_tpu_torch.ops.fused_sweep import (make_fused_jvp_dir, make_fused_jvp_dir_f64,
                                            make_fused_residual_fn, supports_fused_sweep)
from hank_tpu_torch.ops.fused_sweep2 import (make_fused2_jvp_dir, make_fused2_residual_fn,
                                             supports_fused_sweep2)
from hank_tpu_torch.ops.precision import cast_model, cast_paths, cast_ss
from hank_tpu_torch.ops.linalg import (dense_solve, gmres_matfree, make_reusable_solver,
                                       rayleigh_quotient)


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


def _cgs2(Vm: torch.Tensor, w: torch.Tensor, k: int):
    """One CGS2 projection of w against the first k rows of the (m+1, n)
    basis Vm (`_cgs2_program`, `:97-121`): returns the new Hessenberg
    column (m+1,), the orthogonalised w and its norm."""
    Vk = Vm[:k]
    h1 = Vk @ w
    w1 = w - Vk.T @ h1
    h2 = Vk @ w1
    w2 = w1 - Vk.T @ h2
    h = torch.zeros(Vm.shape[0], dtype=w.dtype, device=w.device)
    h[:k] = h1 + h2
    return h, w2, torch.linalg.norm(w2)


def _host_pgmres_cycle(apply_A, b: torch.Tensor, m: int, tol: float):
    """One Arnoldi/CGS2 cycle of host-driven GMRES with the (m+1, m)
    Hessenberg least squares in numpy f64 (`:124-162`).

    Returns (dx, rel_residual, matvecs); dx is None if a matvec came back
    non-finite (the caller escalates to a more robust operator)."""
    bn = float(torch.linalg.norm(b))
    if bn == 0.0 or not math.isfinite(bn):
        return None, float("inf"), 0
    Vm = torch.zeros((m + 1, b.shape[0]), dtype=b.dtype, device=b.device)
    Vm[0] = b / bn
    H = np.zeros((m + 1, m))
    y = np.zeros(0)
    k = 0
    rrel = float("inf")
    for j in range(m):
        w = apply_A(Vm[j])
        hcol_d, w, hn_d = _cgs2(Vm, w, j + 1)
        hcol = hcol_d[:j + 1].cpu().numpy()
        hn = float(hn_d)
        if not (math.isfinite(hn) and np.isfinite(hcol).all()):
            return None, float("inf"), j + 1
        H[:j + 1, j] = hcol
        H[j + 1, j] = hn
        k = j + 1
        e1 = np.zeros(k + 1)
        e1[0] = bn
        y, *_ = np.linalg.lstsq(H[:k + 1, :k], e1, rcond=None)
        rrel = float(np.linalg.norm(H[:k + 1, :k] @ y - e1)) / bn
        if hn < 1e-14 * bn or rrel < tol:
            break
        Vm[j + 1] = w / hn
    dx = Vm[:k].T @ torch.as_tensor(y[:k], dtype=b.dtype, device=b.device)
    return dx, rrel, k


def _host_pgmres(apply_A, b: torch.Tensor, m: int, tol: float, restarts: int = 1):
    """Host-driven restarted GMRES (`:165-219`): solves A·dx = b to relative
    tolerance `tol` with at most `m` matvecs per cycle and up to `restarts`
    extra cycles. A cycle that made real progress without reaching `tol`
    is followed by one exact residual (one matvec) and another cycle from
    the deflated right-hand side; a stagnant one (< 10% drop) stops.

    Unlike the Richardson y-iteration, GMRES contracts even where the
    preconditioned operator is indefinite along the iterate, which is what
    happens at a kinked residual's f32 noise floor.

    Returns (dx, rel_residual, matvecs); dx is None if a matvec came back
    non-finite on the first cycle; later non-finite cycles return the best
    accumulated iterate."""
    bn = float(torch.linalg.norm(b))
    if bn == 0.0 or not math.isfinite(bn):
        return None, float("inf"), 0
    dx_total = None
    r = b
    rrel_prev = 1.0
    total_mv = 0
    rrel = float("inf")
    for cycle in range(restarts + 1):
        dx, rrel_c, mv = _host_pgmres_cycle(apply_A, r, m, tol / rrel_prev)
        total_mv += mv
        if dx is None:
            if dx_total is None:
                return None, float("inf"), total_mv
            return dx_total, rrel, total_mv
        dx_total = dx if dx_total is None else dx_total + dx
        rrel = rrel_c * rrel_prev            # vs the ORIGINAL b
        if rrel < tol or cycle == restarts:
            break
        # True deflated residual (Arnoldi's estimate drifts across cycles).
        r = b - apply_A(dx_total)
        total_mv += 1
        rn = float(torch.linalg.norm(r))
        if not math.isfinite(rn):
            break
        rrel = rn / bn
        if rrel < tol or rrel > 0.9 * rrel_prev:
            break
        rrel_prev = rrel
    return dx_total, rrel, total_mv


def newton_raphson_hank(x0, Jbar, exog_paths, model, ss_initial, ss_ending,
                        **kwargs):
    """Solve F(x) = 0 for the perfect-foresight path; one-shot form of
    `make_path_solver(...)(x0)`. Returns (x, info) with info =
    {"iterations", "residual_norm", ...}."""
    return make_path_solver(Jbar, exog_paths, model, ss_initial, ss_ending,
                            **kwargs)(x0)


DIRECTION_MODES = ("auto", "xla", "pallas")


def kernel_pair(model, ss_initial, ss_ending, exog_paths):
    """(jvp_dir32, residual32) of the model's f32 kernel pair (module
    docstring): the direction map and the f32 F(x) through the same
    kernels with a zero tangent."""
    if supports_fused_sweep(model):
        return (make_fused_jvp_dir(model, ss_initial, ss_ending, exog_paths),
                make_fused_residual_fn(model, ss_initial, ss_ending, exog_paths))
    if supports_fused_sweep2(model):
        return (make_fused2_jvp_dir(model, ss_initial, ss_ending, exog_paths),
                make_fused2_residual_fn(model, ss_initial, ss_ending, exog_paths))
    raise ValueError("direction_mode='pallas' requested but the model supports neither "
                     "household-sweep kernel pair (supports_fused_sweep / "
                     "supports_fused_sweep2 both False); use 'auto' or 'xla'")


def mixed_tail_map(model, ss_initial, ss_ending):
    """(jvp_dir, F_lo) of the mixed-tail direction map (`:462-494`): the
    household blocks (all the work) run on an f32 copy of the model, the
    steady states and the shock paths; the assembly and residual tail run
    in the working f64 on the f64 shock paths; AD by `torch.func.jvp`.
    jvp_dir(x, v, exog_paths) and F_lo(x, exog_paths) take and return the
    working dtype."""
    x_dtype, lo = config.dtype, torch.float32
    m_lo = cast_model(model, lo)
    s0_lo, sT_lo = cast_ss(ss_initial, lo), cast_ss(ss_ending, lo)

    def F_dir(x_lo, exog_paths):
        pols = backward_iteration(x_lo, cast_paths(exog_paths, lo), m_lo, sT_lo.vars,
                                  sT_lo.value)
        aggs = forward_iteration(pols, m_lo, s0_lo.D)
        aggs_hi = {k: v.to(x_dtype) for k, v in aggs.items()}
        x_mat = assemble_full_xmat(x_lo.to(x_dtype), aggs_hi, exog_paths, model,
                                   ss_initial.vars, ss_ending.vars)
        return eval_residuals(x_mat, model)

    def jvp_dir(x, v, exog_paths):
        return torch.func.jvp(lambda z: F_dir(z, exog_paths), (x.to(lo),),
                              (v.to(lo),))[1].to(x.dtype)

    def F_lo(x, exog_paths):
        return F_dir(x.to(lo), exog_paths).to(x.dtype)

    return jvp_dir, F_lo


def direction_route(model, ss_initial, ss_ending, exog_paths, direction_mode: str = "auto"):
    """(jvp_dir32, F32) of the f32 direction route `direction_mode` picks
    (module docstring).

    One departure from the reference, whose "auto" takes a kernel only for
    the one-asset family on its TPU (`:402-418`): on the card "auto" takes
    kernels 5-6 for the two-asset family too, because their `jvp_dir` is
    132-133 ms per direction against 15-27 s for the plain f32 one on an
    H100 80GB HBM3 at 700 W (PERF.md §6). For the one-asset family the
    kernel is kernel 1, or past its shared memory the global-state
    `<float, true, false, true>` (module docstring)."""
    kernels = supports_fused_sweep(model) or supports_fused_sweep2(model)
    if direction_mode == "pallas" or (direction_mode == "auto" and kernels
                                      and ss_ending.value.is_cuda):
        return kernel_pair(model, ss_initial, ss_ending, exog_paths)
    jvp_dir, F_lo = mixed_tail_map(model, ss_initial, ss_ending)
    return (lambda x, v: jvp_dir(x, v, exog_paths)), (lambda x: F_lo(x, exog_paths))


def ad_direction(F: Callable) -> Callable:
    """jvp_dir(x, v) by `torch.func.jvp` of F (the plain f64 pipeline):
    the f64 directions' plain route. `ad_direction.calls` counts its
    directions."""
    def jvp_dir(x, v):
        ad_direction.calls += 1
        return torch.func.jvp(F, (x,), (v,))[1]

    return jvp_dir


ad_direction.calls = 0


def f64_direction_route(model, ss_initial, ss_ending, exog_paths,
                        direction_mode: str = "auto") -> Callable:
    """jvp_dir(x, v) of the f64 direction route `direction_mode` picks
    (module docstring).

    A departure from the reference, whose f64 directions are XLA AD of the
    f64 pipeline whatever `direction_mode` says (`:389`): on the card "auto"
    takes the f64 sweep kernel (`household_sweep_ranged_kernel<double,
    true, false>`) for the one-asset family, because AD through the eager
    plain pipeline took 65.1 s for the one-asset HANK 50×7, T=300 solve
    (one outer) where the f64 tangent sweep takes 0.110 s, on an H100 80GB
    HBM3 at 700 W (PERF.md §5). Past that kernel's shared memory (n_a > 529
    at n_e = 7) its global-state instantiation `<double, true, false,
    true>` takes the grid, and past that one's count (n_a > 4980) the
    build raises. On CPU tensors "auto" is AD, as in the reference."""
    sweep = supports_fused_sweep(model)
    if direction_mode == "pallas" and not sweep:
        raise ValueError("direction_mode='pallas' with f64 directions needs the one-asset "
                         "f64 sweep kernel (supports_fused_sweep is False for this "
                         "model); use 'auto' or 'xla'")
    if direction_mode == "pallas" or (direction_mode == "auto" and sweep
                                      and ss_ending.value.is_cuda):
        return make_fused_jvp_dir_f64(model, ss_initial, ss_ending, exog_paths)
    return ad_direction(make_full_residual_fn(model, ss_initial, ss_ending, exog_paths))


def _kernel_residual(model, residual_mode: str) -> bool:
    """Whether `residual_mode` picks kernel 2 as the full-precision F(x),
    which also turns off Newton-Krylov's f32-residual phase."""
    if residual_mode not in ("auto", "ds", "f64"):
        raise ValueError(f"unknown residual_mode {residual_mode!r}")
    sweep = supports_fused_sweep(model)
    if residual_mode == "ds" and not (sweep or supports_fused_sweep2(model)):
        raise ValueError("residual_mode='ds' needs a residual kernel: the one-asset "
                         "kernel 2 (supports_fused_sweep) or the two-asset f64 pair "
                         "(supports_fused_sweep2); both are False for this model")
    return residual_mode != "f64" and sweep


def residual_route(model, ss_initial, ss_ending, exog_paths, residual_mode: str = "auto"):
    """The full-precision F(x) that `residual_mode` picks (`:330-331`):
      - "auto": kernel 2 wherever `supports_fused_sweep` holds; the two-asset
        f64 pair (`ops/fused_residual2.py`) for `supports_fused_sweep2`
        models on the card; else the plain f64 pipeline;
      - "ds": kernel 2 or the f64 pair (their plain versions on CPU
        tensors), or ValueError for a model outside both families;
      - "f64": the plain pipeline.
    The f64 pair is a departure from the reference, whose two-asset F stays
    on the compiled f64 pipeline (`:352-376`: its residual kernel takes the
    one-asset family only): the plain f64 F took 2.0-5.4 s a call on the
    two-asset route at 40×20×5×2, T=300, 94% of the solve, on an H100 80GB
    HBM3 at 700 W (PERF.md §5). Unlike kernel 2, the pair leaves
    Newton-Krylov's f32-residual phase on (`_kernel_residual`), as the
    reference runs it for this family, so the solver's outers, matvecs
    and F calls are those of the plain route. Kernel 2 past its shared
    memory (n_a > 1036 at n_e = 7) is its global-state instantiation
    `<double, false, false, true>`; past that one's count (n_a > 5390) the
    build raises."""
    if _kernel_residual(model, residual_mode):
        return make_sweep_residual_fn(model, ss_initial, ss_ending, exog_paths)
    if (residual_mode != "f64" and supports_fused_sweep2(model)
            and (residual_mode == "ds" or ss_ending.value.is_cuda)):
        return make_fused2_residual_fn_f64(model, ss_initial, ss_ending, exog_paths)
    return make_full_residual_fn(model, ss_initial, ss_ending, exog_paths)


def _is_mixed(direction_dtype) -> bool:
    """True for f32 (kernel) directions, False for f64 ones (None or
    torch.float64, the working dtype, as in the reference)."""
    if direction_dtype is None or direction_dtype == torch.float64:
        return False
    if direction_dtype == torch.float32:
        return True
    raise ValueError(f"direction_dtype must be None, torch.float64 or torch.float32, "
                     f"got {direction_dtype!r}")


def make_path_solver(
    Jbar: torch.Tensor,
    exog_paths: Mapping[str, torch.Tensor],
    model,
    ss_initial,
    ss_ending,
    *,
    eps: float = 1e-9,
    method: str = "boehl",
    max_outer: int | None = None,
    richardson_max_outer: int | None = None,
    max_inner: int = 500,
    gmres_restart: int = 20,
    gmres_maxiter: int = 2,
    direction_dtype=None,
    direction_mode: str = "auto",
    residual_mode: str = "auto",
    host_inner: bool = False,
    verbose: bool = False,
    records: list | None = None,
    stall_rescue: bool = True,
    endgame: str = "auto",
    endgame_gmres_tol: float | None = None,
):
    """Build a reusable path solver `run(x0) -> (x, info)` (module docstring).

    direction_dtype: None (or torch.float64) for f64 directions
      (`f64_direction_route`); torch.float32 for f32 directions.
    direction_mode: the directions' route, "auto" | "xla" | "pallas"
      (`direction_route` for f32 directions, `f64_direction_route` for f64
      ones; the reference's f64 directions ignore it).
    residual_mode: "auto" | "ds" | "f64" (`residual_route`).
    host_inner: (boehl) Richardson phase + host-PGMRES endgame.
    richardson_max_outer: (boehl, host_inner) cap on the Richardson outers;
      0 skips that phase (the endgame-only route from a linear warm start).
    endgame_gmres_tol: (boehl, host_inner) relative tolerance of the
      endgame's GMRES solve, 1e-3 when not given.
    endgame: "auto" (= "jvp" here), "jvp" (with f32 directions, the f64 AD
      rung before fd) or "fd" (f32 then fd).
    stall_rescue: (newton_krylov) hand a no-descent iterate to boehl.
    records: optional list, appended one dict per outer iteration.

    info holds "iterations" and "residual_norm" (floats); boehl adds
    "inner_iterations" and "y_norm", and with host_inner "prof": program →
    {"calls", "secs"} for "sweep" (Richardson steps), "solve_j", "F" and
    "pgmres_mv" (endgame matvecs).
    """
    if method not in ("boehl", "newton_krylov"):
        raise ValueError(f"unknown method '{method}' (expected 'boehl' or 'newton_krylov')")
    if host_inner and method != "boehl":
        raise ValueError("host_inner requires method='boehl'")
    if ((richardson_max_outer is not None or endgame_gmres_tol is not None)
            and not (method == "boehl" and host_inner)):
        raise ValueError("richardson_max_outer and endgame_gmres_tol apply only to "
                         "method='boehl' with host_inner=True")
    if endgame not in ("auto", "jvp", "fd"):
        raise ValueError(f"unknown endgame {endgame!r}")
    if direction_mode not in DIRECTION_MODES:
        raise ValueError(f"unknown direction_mode {direction_mode!r} "
                         f"(expected one of {DIRECTION_MODES})")
    mixed = _is_mixed(direction_dtype)
    if mixed and Jbar.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("torch.backends.cuda.matmul.allow_tf32 must be False: "
                           "the f32 J̄⁻¹ preconditioner needs full f32 products")

    F = residual_route(model, ss_initial, ss_ending, exog_paths, residual_mode)
    F_exact = make_full_residual_fn(model, ss_initial, ss_ending, exog_paths)
    solve_jbar = make_reusable_solver(Jbar)
    max_outer = config.path_newton_max_iter if max_outer is None else max_outer
    # The f64 directions; under f32 directions, AD for the boehl endgame's
    # "f64-ad" rung, as before the f64 sweep kernel (`direction_mode` names
    # the f32 route there).
    jvp_full = (ad_direction(F_exact) if mixed else
                f64_direction_route(model, ss_initial, ss_ending, exog_paths, direction_mode))

    F32 = None
    if mixed:
        jvp_dir32, F32_lo = direction_route(model, ss_initial, ss_ending, exog_paths,
                                            direction_mode)

        def jvp_dir(x, v):
            return jvp_dir32(x, v).to(x.dtype)

        def F32(x):
            return F32_lo(x).to(x.dtype)
    else:
        jvp_dir = jvp_full

    if method == "newton_krylov":
        # The f32 residual phase: off where kernel 2 is F, which already
        # costs about an f32 sweep and carries f64 accuracy (`:985-992`).
        fast = F32 if not _kernel_residual(model, residual_mode) else None
        return _make_newton_krylov(
            F, jvp_dir, solve_jbar, F32=fast, mixed=mixed, eps=eps, max_outer=max_outer,
            gmres_restart=gmres_restart, gmres_maxiter=gmres_maxiter, records=records,
            verbose=verbose,
            rescue=(lambda outers_left: make_path_solver(
                Jbar, exog_paths, model, ss_initial, ss_ending, method="boehl",
                eps=eps, max_outer=outers_left, max_inner=max_inner,
                direction_dtype=direction_dtype, direction_mode=direction_mode,
                residual_mode=residual_mode, host_inner=True, verbose=verbose,
                records=records))
            if stall_rescue else None)

    # Inexact-Newton inner stop of the y-iteration: the preconditioned
    # residual R = J̄⁻¹(F(x) − J(x)y) has dropped by `inner_eta` from
    # J̄⁻¹F(x) (the f32-direction forcing of the reference).
    inner_eta = 1e-5

    def rich_step(x, y, Fx):
        """One Richardson step: (y + α·R, ‖R‖)."""
        Lxy = jvp_dir(x, y)
        R = solve_jbar(Fx - Lxy)
        alpha = _boehl_alpha(rayleigh_quotient(solve_jbar(Lxy), y))
        return y + alpha * R, torch.linalg.norm(R)

    if not host_inner:
        def run(x0):
            x, y = x0, x0
            Fx = F(x0)
            fnorm = float(torch.linalg.norm(Fx))
            iters = total_inner = 0
            while fnorm > eps and iters < max_outer:
                tol = max(inner_eta * float(torch.linalg.norm(solve_jbar(Fx))), TINY)
                rnorm, inner_its = math.inf, 0
                while rnorm > tol and inner_its < max_inner:
                    y, rn = rich_step(x, y, Fx)
                    rnorm = float(rn)
                    inner_its += 1
                x = x - y
                Fx = F(x)
                fnorm = float(torch.linalg.norm(Fx))
                _check_finite(fnorm, "boehl", iters + 1, x)
                iters += 1
                total_inner += inner_its
                if verbose:
                    print(f"[boehl] outer {iters}: |F| = {fnorm:.3e} (+{inner_its} sweeps)")
                if records is not None:
                    records.append({"iteration": iters, "residual_norm": fnorm,
                                    "inner_sweeps": inner_its})
            return x, {"iterations": iters, "inner_iterations": total_inner,
                       "residual_norm": fnorm, "y_norm": float(torch.linalg.norm(y))}

        return run

    rich_max_outer = (max_outer if richardson_max_outer is None
                      else min(richardson_max_outer, max_outer))
    gmres_tol = 1e-3 if endgame_gmres_tol is None else endgame_gmres_tol
    endgame_mode = "jvp" if endgame == "auto" else endgame

    # FD step: the model's CompSpec.dx clamped into the window where the
    # central-difference error h²·‖F‴‖/6 + ε₆₄‖F‖/h stays ≲ 1e-10 per unit
    # tangent (`:609-615`). FD differences the plain f64 pipeline.
    fd_h = float(min(max(model.compspec.dx, 1e-6), 1e-5))

    def jvp_fd(x, v):
        vn = float(torch.linalg.norm(v))
        if vn == 0.0 or not math.isfinite(vn):
            return torch.zeros_like(x)
        u = v * (1.0 / vn)
        return (F_exact(x + fd_h * u) - F_exact(x - fd_h * u)) * (vn / (2.0 * fd_h))

    # The endgame's operator ladder, cheapest first; each rung is the
    # preconditioned matvec v ↦ J̄⁻¹·J·v. With f64 directions the first
    # rung is already the f64 AD one (`:632-636`).
    ladder = [("f32" if mixed else "ad", lambda x, v: solve_jbar(jvp_dir(x, v)))]
    if mixed and endgame_mode == "jvp":
        ladder.append(("f64-ad", lambda x, v: solve_jbar(jvp_full(x, v))))
    ladder.append(("fd", lambda x, v: solve_jbar(jvp_fd(x, v))))

    def run(x0):
        # Per-program wall-clock accumulators: program -> [calls, secs].
        prof = {"sweep": [0, 0.0], "solve_j": [0, 0.0], "F": [0, 0.0],
                "pgmres_mv": [0, 0.0]}

        def _timed(key, fn, *a):
            t0 = time.perf_counter()
            out = fn(*a)
            if x0.is_cuda:
                torch.cuda.synchronize(x0.device)
            prof[key][0] += 1
            prof[key][1] += time.perf_counter() - t0
            return out

        x, y = x0, x0
        Fx = _timed("F", F, x)
        fnorm = float(torch.linalg.norm(Fx))
        iters = total_inner = 0
        best = fnorm
        since_improve = 0
        x_best, F_best = x, Fx
        # Phase 1: Richardson y-iteration with the f32 direction operator,
        # down to its noise floor.
        while fnorm > eps and iters < rich_max_outer:
            tol = max(inner_eta * float(torch.linalg.norm(
                _timed("solve_j", solve_jbar, Fx))), 1e-300)
            rnorm, inner_its = math.inf, 0
            best_r, y_best_in = math.inf, y
            while rnorm > tol and inner_its < max_inner:
                y_new, rn = _timed("sweep", rich_step, x, y, Fx)
                rnew = float(rn)
                if rnew < best_r:
                    best_r, y_best_in = rnew, y
                elif not math.isfinite(rnew) or rnew > 10.0 * max(best_r, tol):
                    # Inner divergence: keep the best inner iterate; the
                    # GMRES endgame handles the indefinite region.
                    y = y_best_in
                    rnorm = rnew
                    break
                y = y_new
                rnorm = rnew
                inner_its += 1
            if not bool(torch.isfinite(y).all()):
                break                                # endgame from the best
            x = x - y
            Fx = _timed("F", F, x)
            fnorm = float(torch.linalg.norm(Fx))
            _check_finite(fnorm, "boehl", iters + 1, x)
            iters += 1
            total_inner += inner_its
            since_improve = 0 if fnorm < 0.5 * best else since_improve + 1
            if fnorm < best:
                best, x_best, F_best = fnorm, x, Fx
            if verbose:
                print(f"[boehl/host] outer {iters}: |F| = {fnorm:.3e} "
                      f"(+{inner_its} sweeps)", flush=True)
            if records is not None:
                records.append({"iteration": iters, "residual_norm": fnorm,
                                "inner_sweeps": inner_its})
            # One non-halving outer marks the f32-direction floor; climbing
            # far above the best iterate too (`:704-725`).
            if since_improve >= 1 or fnorm > 3.0 * best:
                break
        # Phase 2: host-PGMRES Newton endgame from the best iterate. Each
        # outer solves (J̄⁻¹J + λI)·dx = J̄⁻¹F and backtracks on the true
        # residual norm; λ (Levenberg-Marquardt) shrinks on success and
        # grows on failure, and the operator escalates once damping is
        # exhausted or a matvec is non-finite (`:726-843`).
        if fnorm > eps:
            x, Fx, fnorm = x_best, F_best, best
            level = 0
            m_kry = min(40, x.shape[0])
            lam = 0.0
            eg_stall = 0
            if verbose and iters:
                print(f"[boehl/host] Richardson floor at |F| = {best:.3e}; GMRES "
                      f"endgame ({ladder[level][0]} operator)", flush=True)
            while fnorm > eps and iters < max_outer:
                # Three outers in a row improving the best by < 2% each: the
                # residual's own evaluation-noise floor.
                if eg_stall >= 3:
                    break
                name, op = ladder[level]
                xc, lam_c = x, lam
                dx, rrel, mv = _host_pgmres(
                    lambda v: _timed("pgmres_mv", op, xc, v) + lam_c * v,
                    solve_jbar(Fx), m=m_kry, tol=gmres_tol)
                total_inner += mv
                iters += 1
                if dx is None:
                    # A NaN operator stays NaN whatever λ·v adds: escalate now.
                    if level + 1 < len(ladder):
                        level += 1
                        lam = 0.0
                        x, Fx, fnorm = x_best, F_best, best
                        if verbose:
                            print(f"[boehl/host] non-finite {name} matvec; escalating "
                                  f"to {ladder[level][0]}", flush=True)
                        continue
                    break                            # no operator left
                accepted = False
                if bool(torch.isfinite(dx).all()):
                    # The full backtracking ladder while outers accept; once
                    # one failed at this damping, probe the two ends only.
                    steps = (1.0, 0.5, 0.25, 0.1, 0.03, 0.01) if eg_stall == 0 else (1.0, 0.1)
                    for s in steps:
                        xt = x - s * dx
                        Ft = _timed("F", F, xt)
                        fn = float(torch.linalg.norm(Ft))
                        if math.isfinite(fn) and fn < fnorm:
                            x, Fx, fnorm = xt, Ft, fn
                            accepted = True
                            break
                if accepted:
                    lam *= 0.3
                    if lam < 1e-6:
                        lam = 0.0
                    eg_stall = eg_stall + 1 if fnorm > 0.98 * best else 0
                    if fnorm < best:
                        best, x_best, F_best = fnorm, x, Fx
                    if verbose:
                        print(f"[boehl/host] endgame outer {iters}: |F| = {fnorm:.3e} "
                              f"({name}, +{mv} matvecs, step {s}, lam {lam:.1e})",
                              flush=True)
                    if records is not None:
                        records.append({"iteration": iters, "residual_norm": fnorm,
                                        "inner_sweeps": mv, "operator": name})
                elif lam < 1e1:
                    lam = max(30.0 * lam, 1e-2)
                    eg_stall += 1
                    x, Fx, fnorm = x_best, F_best, best
                    if verbose:
                        print(f"[boehl/host] no descent ({name}); raising LM damping "
                              f"to {lam:.1e}", flush=True)
                elif level + 1 < len(ladder):
                    level += 1
                    lam = 0.0
                    x, Fx, fnorm = x_best, F_best, best
                    if verbose:
                        print(f"[boehl/host] damping exhausted with {name} operator; "
                              f"escalating to {ladder[level][0]}", flush=True)
                else:
                    break                            # genuine stall
        if best < fnorm:
            x, fnorm = x_best, best
        return x, {"iterations": iters, "inner_iterations": total_inner,
                   "residual_norm": fnorm, "y_norm": float(torch.linalg.norm(y)),
                   "prof": {k: {"calls": v[0], "secs": round(v[1], 3)}
                            for k, v in prof.items()}}

    return run


def _make_newton_krylov(F, jvp_dir, solve_jbar, *, F32, mixed, eps, max_outer,
                        gmres_restart, gmres_maxiter, records, verbose, rescue):
    """The Newton-Krylov `run` (`:900-1069`); `rescue(outers_left)` builds
    the boehl solver a stalled iterate is handed to, or is None. With f32
    directions (`mixed`) GMRES stops at the f32 operator floor and is
    preconditioned by an f32 J̄⁻¹ matvec; with f64 ones at 1e-12, by the f64
    J̄⁻¹ (`:902-916`). F32, when given, is the f32 residual of the early
    outers (`:975-1025`): GMRES right-hand side, backtracking and progress
    norm until ‖F‖ ≤ max(1e-3, 100·eps), then a re-anchor on F; an f32
    outer without descent hands over to F at once."""
    if mixed:
        Jinv32 = solve_jbar.A_inv.to(torch.float32)
        gmres_tol = 3e-7      # f32 operator floor: no more than the JVP noise

        def precond(v):
            return (Jinv32 @ v.to(torch.float32)).to(v.dtype)
    else:
        gmres_tol = 1e-12
        precond = solve_jbar

    def nk_step(Fres, x, Fx, fnorm, fnorm_prev):
        # Eisenstat-Walker (choice 2) forcing, floored at the direction
        # noise and at what the final target still requires.
        eta = min(max(0.9 * (fnorm / fnorm_prev) ** 2, gmres_tol), 0.5)
        eta = max(eta, 0.1 * eps / max(fnorm, TINY))
        d, _ = gmres_matfree(lambda v: jvp_dir(x, v), Fx, x0=solve_jbar(Fx), M=precond,
                             tol=eta, atol=0.0, restart=gmres_restart,
                             maxiter=gmres_maxiter)
        # Backtracking: halve the step until the residual decreases (≤ 6
        # halvings); a full step that descends costs no extra residual.
        alpha = 1.0
        x_t = x - d
        Fx_t = Fres(x_t)
        fn_t = float(torch.linalg.norm(Fx_t))
        tries = 0
        while not (math.isfinite(fn_t) and fn_t < fnorm) and tries < 6:
            alpha *= 0.5
            x_t = x - alpha * d
            Fx_t = Fres(x_t)
            fn_t = float(torch.linalg.norm(Fx_t))
            tries += 1
        # Strict descent: keep the incumbent if every halving failed.
        if math.isfinite(fn_t) and fn_t < fnorm:
            return x_t, Fx_t, fn_t
        return x, Fx, fnorm

    residual_switch = max(1e-3, 100.0 * eps)

    def run(x0):
        x = x0
        in_fast_phase = F32 is not None
        Fx = (F32 if in_fast_phase else F)(x0)
        fnorm = fprev = float(torch.linalg.norm(Fx))
        _check_finite(fnorm, "newton_krylov", 0, x)
        iters = 0
        while fnorm > eps and iters < max_outer:
            if in_fast_phase and fnorm <= residual_switch:
                # Re-anchor in full precision at the phase switch (the f32
                # Fx carries ~1e-6-scale noise).
                in_fast_phase = False
                Fx = F(x)
                fprev = fnorm
                fnorm = float(torch.linalg.norm(Fx))
                if fnorm <= eps:
                    break
            x, Fx, fn = nk_step(F32 if in_fast_phase else F, x, Fx, fnorm, fprev)
            fprev, fnorm = fnorm, fn
            _check_finite(fnorm, "newton_krylov", iters + 1, x)
            iters += 1
            if fnorm >= fprev:
                if in_fast_phase:
                    # The f32 noise floor can stall the fast phase before
                    # the switch: hand over to full precision.
                    in_fast_phase = False
                    Fx = F(x)
                    fnorm = float(torch.linalg.norm(Fx))
                    continue
                # No descent along the Newton direction: a curved valley the
                # step cannot traverse (the two-asset fiscal path). Hand the
                # iterate to the adaptively damped boehl y-iteration.
                if rescue is not None:
                    warnings.warn(f"[newton_krylov] no descent at |F| = {fnorm:.3e} "
                                  f"after {iters} outers — switching to the boehl "
                                  "y-iteration")
                    x, rinfo = rescue(max(max_outer - iters, 4))(x)
                    fnorm = rinfo["residual_norm"]
                    iters += rinfo["iterations"]
                    break
                warnings.warn(f"[newton_krylov] stalled at |F| = {fnorm:.3e} after "
                              f"{iters} outer iterations (no descent direction found)")
                break
            if verbose:
                print(f"[newton_krylov] outer {iters}: |F| = {fnorm:.3e}"
                      + (" (f32 phase)" if in_fast_phase else ""))
            if records is not None:
                records.append({"iteration": iters, "residual_norm": fnorm})
        return x, {"iterations": iters, "residual_norm": fnorm}

    return run


def solve_path_dense(x0, exog_paths, model, ss_initial, ss_ending, *,
                     eps: float = 1e-9, max_iter: int = 50):
    """Naive dense-Jacobian Newton on the full path (small T only;
    `:1097-1129`): J(x) by `torch.func.jacfwd` through the plain pipeline
    each iteration, O(n_endog·(T-1)) JVP sweeps per step. The ground-truth
    cross-check of the fast solvers. Returns (x, info) with info =
    {"iterations", "residual_norm"} (the final ‖F‖, a Python float)."""
    F = make_full_residual_fn(model, ss_initial, ss_ending, exog_paths)
    J = torch.func.jacfwd(F)
    x = x0
    for it in range(max_iter):
        Fx = F(x)
        x = x - dense_solve(J(x), Fx)
        if float(torch.linalg.norm(Fx)) < eps:
            break
    return x, {"iterations": it + 1,
               "residual_norm": float(torch.linalg.norm(F(x)))}
