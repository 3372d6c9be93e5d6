"""Steady-state solver: VFI fixed point + outer Newton with backtracking
(port of `hank_tpu/solvers/steady_state.py`, `SteadyState.jl`).

The VFI fixed point is a `torch.autograd.Function` whose forward-mode `jvp`
rule solves the tangent fixed point dv = ∂_v f · dv + ∂_x f · dx at the
converged value (implicit differentiation, the reference's `custom_jvp`),
with the same Aitken-accelerated iteration as the primal. The Newton
Jacobian is a loop of `torch.func.jvp` over the free variables' unit
vectors (the reference's `jax.jacfwd`; vmap cannot run a loop that stops on
`.item()`). Before that loop, `F.prepare_jacobian(p)` solves the tangent
fixed points of all columns at once, batched as `jax.jacfwd` batches them,
and each column's `jvp` rule then reads its own.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Callable, Mapping

import torch

from hank_tpu_torch.blocks.assemble import residuals as eval_residuals
from hank_tpu_torch.config import config
from hank_tpu_torch.ops.linalg import (accelerated_fixed_point, dense_solve,
                                      invariant_dist_colstoch, make_invariant_solver)
from hank_tpu_torch.ops.transition import (dense_full_transition, exog_apply,
                                          lottery_apply_multi)


@dataclasses.dataclass(frozen=True)
class SteadyState:
    """Steady-state solution (`SteadyState.jl:21-27`): aggregate `vars` (0-d
    f64 tensors keyed by `model.var_names()`), one (*state_shape,) policy
    per heterogeneous variable, the stationary distribution `D` and the
    converged marginal `value` (the backward recursion's terminal
    condition)."""

    vars: Mapping[str, torch.Tensor]
    policies: Mapping[str, torch.Tensor]
    D: torch.Tensor
    value: torch.Tensor


def _free_keys(model, ss_spec) -> tuple[str, ...]:
    """Newton search variables: endogenous vars not pinned (`SteadyState.jl:72-75`)."""
    pinned = set(ss_spec.fixed.keys())
    return tuple(k for k in model.vars_of_type("endogenous") if k not in pinned)


def make_vfi_solver(model) -> Callable[[torch.Tensor], torch.Tensor]:
    """`vfi(xvec) -> value*` for the (n_v,) aggregate vector, differentiable
    in forward mode by implicit differentiation (`SteadyState.jl:134-141`)."""
    names = model.var_names()
    state_shape = model.state_shape()
    # A model carrying several marginal values (the two-asset (V_b, V_a)
    # pair) declares `ValueFunction.n_values`; the value gets that leading axis.
    n_values = getattr(model.value_fn, "n_values", 1)
    value_shape = state_shape if n_values == 1 else (n_values, *state_shape)
    eps = min(model.compspec.eps, config.vfi_eps)
    max_iter = config.vfi_max_iter

    def bellman(value, xvec):
        xvals = {name: xvec[i] for i, name in enumerate(names)}
        return model.value_fn(value, xvals, model)["Value"]

    # The last fixed point, the Bellman step linearised there, and the
    # tangent fixed points of the Newton Jacobian's columns. The Jacobian
    # takes one `torch.func.jvp` per free variable and each reruns the
    # forward at the same x: the cache serves it the same v* (bit for bit).
    cache = {}

    def linearize(dxs: torch.Tensor) -> None:
        """At the last fixed point (v*, x), called outside any transform
        (forward-mode AD does not nest): trace the tangent map once, then
        solve dv = ∂_v f · dv + ∂_x f · dx for every row of dxs (n, n_v) in
        one batched iteration, so a tangent step costs one primal-sized pass
        for all n columns. The `jvp` rule serves a tangent dx equal to a row
        of dxs from these solutions."""
        if "x" not in cache:
            return
        if "lin" not in cache:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", UserWarning)   # fx const-fold notes
                lin = torch.func.linearize(bellman, cache["v"], cache["x"])[1]
                # The first call folds the graph's constants; it too must
                # run outside the transforms.
                lin(torch.zeros_like(cache["v"]), torch.zeros_like(cache["x"]))
            cache["lin"] = lin
        step = torch.func.vmap(cache["lin"])
        dvs = accelerated_fixed_point(
            lambda dv: step(dv, dxs),
            torch.zeros((dxs.shape[0], *value_shape), dtype=dxs.dtype, device=dxs.device),
            eps, max_iter)
        cache["tangents"] = (dxs.clone(), dvs)

    class _VFI(torch.autograd.Function):
        @staticmethod
        def forward(xvec):
            if "x" in cache and torch.equal(cache["x"], xvec):
                return cache["v"].clone()
            # Constant initial marginal value: the first EGM implied-wealth
            # grid is then strictly increasing (`SteadyState.jl:129-132`).
            v0 = torch.ones(value_shape, dtype=xvec.dtype, device=xvec.device)
            v = accelerated_fixed_point(lambda v: bellman(v, xvec), v0, eps, max_iter)
            cache.clear()
            cache.update(x=xvec.clone(), v=v.detach().clone())
            return v

        @staticmethod
        def setup_context(ctx, inputs, output):
            ctx.save_for_forward(inputs[0], output)

        @staticmethod
        def jvp(ctx, dx):
            xvec, v_star = ctx.saved_tensors
            if "tangents" in cache and torch.equal(cache["x"], xvec):
                dxs, dvs = cache["tangents"]
                for i in range(dxs.shape[0]):
                    if torch.equal(dxs[i], dx):
                        return dvs[i].clone()
            if "lin" in cache and torch.equal(cache["x"], xvec):
                lin = cache["lin"]

                def tan_step(dv):
                    return lin(dv, dx)
            else:
                def tan_step(dv):
                    return torch.func.jvp(bellman, (v_star, xvec), (dv, dx))[1]

            return accelerated_fixed_point(tan_step, torch.zeros_like(v_star),
                                           eps, max_iter)

    def vfi(xvec):
        return _VFI.apply(xvec)

    vfi.linearize = linearize
    return vfi


def make_ss_pipeline(model, ss_spec):
    """SS evaluation pipeline for one steady state: (F, household, free)
    with F(p) the (n_eq,) Newton objective and household(p) ->
    (xvec, value*, policies, D) (`SteadyState.jl:111-154`)."""
    names = model.var_names()
    free = _free_keys(model, ss_spec)
    device = model.device
    het_keys = model.vars_of_type("heterogeneous")
    endog_dims = model.endog_dims()
    transitions = [d.transition for d in model.exog_dims()]
    state_shape = model.state_shape()

    grids = [d.grid for d in endog_dims]
    policy_vars = [d.policy_var for d in endog_dims]
    # The invariant distribution: a dense direct solve for small
    # one-endogenous-axis state spaces, the matrix-free power iteration with
    # implicit differentiation otherwise (several endogenous axes, large grids).
    use_dense = (len(endog_dims) == 1
                 and model.n_total() <= config.invariant_dense_max_states)
    if not use_dense:
        def apply(endog_policies, D):
            return exog_apply(lottery_apply_multi(endog_policies, D, grids),
                              transitions, len(endog_dims))

        invariant_solve = make_invariant_solver(
            apply, eps=min(model.compspec.eps, config.invariant_eps))
    vfi = make_vfi_solver(model)

    def assemble(p, fill):
        """(n_v,) vector: free variables from p, pinned ones from the spec,
        the rest from `fill`."""
        zero = torch.zeros((), dtype=p.dtype, device=device)
        cols = []
        for name in names:
            if name in free:
                cols.append(p[free.index(name)])
            elif name in ss_spec.fixed:
                cols.append(torch.tensor(ss_spec.fixed[name], dtype=p.dtype, device=device))
            else:
                cols.append(fill.get(name, zero))
        return torch.stack(cols)

    def household(p):
        xvec = assemble(p, {})
        v_star = vfi(xvec)
        xvals = {name: xvec[i] for i, name in enumerate(names)}
        result = model.value_fn(v_star, xvals, model)
        policies = {k: result[k] for k in het_keys}
        if use_dense:
            lam = dense_full_transition(policies[policy_vars[0]], grids[0], transitions)
            D = invariant_dist_colstoch(lam).reshape(state_shape)
        else:
            D0 = torch.full(state_shape, 1.0 / model.n_total(), dtype=p.dtype, device=device)
            D = invariant_solve([policies[v] for v in policy_vars], D0)
        xvec = assemble(p, {k: torch.sum(policies[k] * D) for k in het_keys})
        return xvec, result["Value"], policies, D

    def F(p):
        xvec = household(p)[0]
        cs = model.compspec
        x_mat = xvec[:, None].expand(len(names), 1 + cs.max_lag + cs.max_lead)
        return eval_residuals(x_mat, model)

    def prepare_jacobian(p):
        """Solve the VFI tangent fixed points of the Newton Jacobian's
        columns at p, whose F was the last one evaluated."""
        vfi.linearize(torch.func.jacfwd(lambda q: assemble(q, {}))(p).T.contiguous())

    F.prepare_jacobian = prepare_jacobian

    return F, household, free


def _jacobian(F, p):
    """Dense ∂F/∂p column by column with `torch.func.jvp`."""
    eye = torch.eye(p.shape[0], dtype=p.dtype, device=p.device)
    return torch.stack([torch.func.jvp(F, (p,), (eye[i],))[1]
                        for i in range(p.shape[0])], dim=1)


def find_ss(model, ss_spec, label: str = "", verbose: bool = False) -> SteadyState:
    """Projected Newton-Raphson with backtracking (`SteadyState.jl:184-233`):
    forward-mode Jacobian through the implicit-diff VFI, dense solve,
    η-halving line search with a 1e-8 floor and strict decrease, 100
    iterations with a non-convergence warning."""
    F, household, free = make_ss_pipeline(model, ss_spec)
    dtype, device = config.dtype, model.device
    inf = math.inf
    lo = torch.tensor([ss_spec.bounds.get(k, (-inf, inf))[0] for k in free],
                      dtype=dtype, device=device)
    hi = torch.tensor([ss_spec.bounds.get(k, (-inf, inf))[1] for k in free],
                      dtype=dtype, device=device)

    def project(q):
        return torch.minimum(torch.maximum(q, lo), hi)

    def safe_norm(v):
        n = float(torch.linalg.norm(v))
        return n if math.isfinite(n) else inf

    p = project(torch.tensor([ss_spec.guesses.get(k, 1.0) for k in free],
                             dtype=dtype, device=device))
    # Tighter than the reference's 1e-6: the path solver's 1e-9 target
    # needs a steady state consistent at that level.
    eps = min(model.compspec.eps, 1e-9)
    z = F(p)
    it = 0
    max_iter = config.ss_newton_max_iter
    while safe_norm(z) > eps and it < max_iter:
        z_norm = safe_norm(z)
        if verbose:
            print(f"  [{label}] iteration {it}: residual norm = {z_norm:.3e}")
        F.prepare_jacobian(p)           # at p, whose F was the last evaluated
        step = dense_solve(_jacobian(F, p), z)
        eta = 1.0
        p_new = project(p - eta * step)
        z_new = F(p_new)
        improved = safe_norm(z_new) < z_norm
        while not improved:
            eta /= 2.0
            if eta <= 1e-8:
                break
            p_new = project(p - eta * step)
            z_new = F(p_new)
            improved = safe_norm(z_new) < z_norm
        if not improved:
            warnings.warn(
                f"find_ss [{label}]: line search stalled at iteration {it} "
                f"(residual norm {z_norm:.3e}); keeping current iterate")
            break
        p, z = p_new, z_new
        it += 1
    if it == max_iter:
        warnings.warn(f"find_ss [{label}]: did not converge in {max_iter} "
                      f"iterations (residual norm {safe_norm(z):.3e})")

    xvec, value, policies, D = household(p)
    return SteadyState(vars={name: xvec[i] for i, name in enumerate(model.var_names())},
                       policies=policies, D=D, value=value)


def get_steady_states(model, verbose: bool = False) -> tuple[SteadyState, SteadyState]:
    """Initial and ending steady states (`SteadyState.jl:245-259`); one solve
    when the specs are identical (transitory shock)."""
    ss_initial = find_ss(model, model.ss_initial, "initial", verbose)
    if model.ss_initial is model.ss_ending or model.ss_initial == model.ss_ending:
        return ss_initial, ss_initial
    return ss_initial, find_ss(model, model.ss_ending, "ending", verbose)


def single_run(ss_initial: SteadyState, ss_ending: SteadyState, model,
               exog_paths: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """One full pass F(x) at the initial steady state's x, constant over the
    path (`SteadyState.jl:272-286`)."""
    from hank_tpu_torch.solvers.newton import make_full_residual_fn

    x0 = torch.stack([torch.as_tensor(ss_initial.vars[k], dtype=config.dtype, device=model.device)
                      for k in model.vars_of_type("endogenous")]).repeat(model.compspec.T - 1)
    return make_full_residual_fn(model, ss_initial, ss_ending, exog_paths)(x0)
