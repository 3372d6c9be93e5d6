"""Steady-state sequence-space Jacobian J̄ (port of
`hank_tpu/solvers/ss_jacobian.py`, Boehl 2024 / `SteadyStateJacobian.jl`).

F is decomposed by the chain rule into the direct blocks (JDI), the
backward policy responses (JBI) and the forward residual responses (JFI);
by block-Toeplitz invariance at the steady state one block column of each
suffices, and the full Jacobian follows from a diagonal cumulative sum.
JDI and JBI are `torch.func.vmap` over the seeds of one `torch.func.jvp`
(as the reference vmaps `jax.jvp`: one pass carries every seed's tangent);
JFI is one `torch.func.vjp` whose pullback is vmapped over the seeds.

With `mesh=` (`parallel/mesh.py`), the n_endog seeds of each sweep split
over the mesh's "dp" axis: each rank runs its block of seeds, then one
all-gather per output (the reference's sequence parallelism, SURVEY §2.10
SP row). The mesh size must divide n_endog.

The AD validation tools (`direct_jacobian_columns`, `dense_path_jacobian`)
differentiate the full plain pipeline, as the reference's
`directJVPJacobian` / `directNumJacobian` do (`SteadyState.jl:296-356`).
"""

from __future__ import annotations

from typing import Mapping

import torch

from hank_tpu_torch.blocks.assemble import assemble_full_xmat, residuals as eval_residuals
from hank_tpu_torch.blocks.backward import backward_iteration
from hank_tpu_torch.blocks.forward import forward_iteration
from hank_tpu_torch.config import config
from hank_tpu_torch.parallel.mesh import gather_rows, row_block


def _ss_paths(ss, model):
    """Constant-at-SS flat x, exogenous and aggregate paths
    (`SteadyStateJacobian.jl:52-57`)."""
    Tm1 = model.compspec.T - 1
    dtype, device = config.dtype, model.device

    def const(k):
        return torch.as_tensor(ss.vars[k], dtype=dtype, device=device).expand(Tm1).clone()

    x_ss = torch.stack([torch.as_tensor(ss.vars[k], dtype=dtype, device=device)
                        for k in model.vars_of_type("endogenous")]).repeat(Tm1)
    exog_ss = {k: const(k) for k in model.vars_of_type("exogenous")}
    agg_ss = {k: const(k) for k in model.vars_of_type("heterogeneous")}
    return x_ss, exog_ss, agg_ss


def _unit(n: int, i: int, like: torch.Tensor) -> torch.Tensor:
    e = torch.zeros(n, dtype=like.dtype, device=like.device)
    e[i] = 1.0
    return e


def _seed_sweep(fn, x: torch.Tensor, first: int, n: int):
    """The JVPs of `fn` at x along the n unit seeds e_first … e_{first+n-1},
    as one `torch.func.vmap`ped `torch.func.jvp`: each output gains a leading
    seed axis."""
    seeds = torch.stack([_unit(x.shape[0], first + i, x) for i in range(n)])
    return torch.func.vmap(lambda t: torch.func.jvp(fn, (x,), (t,))[1])(seeds)


def _seed_block(n_seeds: int, mesh) -> tuple[int, int]:
    """(first, count) of this rank's block of the n_seeds seeds; all of them
    without a mesh. ValueError when the mesh's "dp" size does not divide
    n_seeds (`hank_tpu/solvers/ss_jacobian.py:225-227`)."""
    if mesh is None:
        return 0, n_seeds
    try:
        return row_block(n_seeds, mesh, "dp")
    except ValueError as e:
        raise ValueError(f"the mesh size must divide n_endog: {e}") from None


def _gather_seeds(out, mesh):
    """Every rank's seeds of a sweep's output (a tensor or a dict of them,
    the seed axis first), in seed order, on every rank."""
    if mesh is None:
        return out
    if isinstance(out, dict):
        return {k: gather_rows(v, mesh, "dp") for k, v in out.items()}
    return gather_rows(out, mesh, "dp")


def direct_jacobian_blocks(ss, model, mesh=None) -> tuple[torch.Tensor, int]:
    """Direct blocks B_δ = ∂z_{p+δ}/∂x_p with policies frozen at SS, from
    n_endog JVPs at the interior period p = T-1-k-1
    (`SteadyStateJacobian.jl:112-145`). Returns (blocks, k) with blocks[j]
    (n_endog, n_endog) = [res_eq, x_var] for δ = j − k. With `mesh`, the
    seeds split over its "dp" axis (module docstring)."""
    cs = model.compspec
    Tm1 = cs.T - 1
    nE = cs.n_endog
    first, count = _seed_block(nE, mesh)
    x_ss, exog_ss, agg_ss = _ss_paths(ss, model)

    def g(x):
        x_mat = assemble_full_xmat(x, agg_ss, exog_ss, model, ss.vars, ss.vars)
        return eval_residuals(x_mat, model)

    k = max(cs.max_lag, cs.max_lead)
    p0 = Tm1 - 1 - k
    if p0 < 0:
        raise ValueError(f"perturbed period p={p0} out of range for T={cs.T}, k={k}")
    raw = _gather_seeds(_seed_sweep(g, x_ss, p0 * nE + first, count), mesh)  # (nE, Tm1*nE)
    blocks = torch.stack([raw[:, (p0 + d) * nE:(p0 + d + 1) * nE].T
                          for d in range(-k, k + 1)])
    return blocks, k


def intermediate_jacobians(ss, model, mesh=None) -> tuple[dict, dict]:
    """JBI[v], JFI[v]: (n_endog, T-1, *state_shape) one-block-columns
    (`SteadyStateJacobian.jl:187-256`). With `mesh`, the seeds of both
    split over its "dp" axis (module docstring)."""
    cs = model.compspec
    Tm1 = cs.T - 1
    nE = cs.n_endog
    first, count = _seed_block(nE, mesh)
    x_ss, exog_ss, _ = _ss_paths(ss, model)
    het_keys = model.vars_of_type("heterogeneous")
    last = (Tm1 - 1) * nE

    def back(x):
        return backward_iteration(x, exog_ss, model, ss.vars, ss.value)

    JBI = _gather_seeds(_seed_sweep(back, x_ss, last + first, count), mesh)

    pol_ss = {v: ss.policies[v].to(x_ss.dtype).expand(Tm1, *ss.policies[v].shape).clone()
              for v in het_keys}

    def fwd(policies):
        aggs = forward_iteration(policies, model, ss.D)
        x_mat = assemble_full_xmat(x_ss, aggs, exog_ss, model, ss.vars, ss.vars)
        return eval_residuals(x_mat, model)

    _, pullback = torch.func.vjp(fwd, pol_ss)
    seeds = torch.stack([_unit(Tm1 * nE, last + first + i, x_ss) for i in range(count)])
    JFI = _gather_seeds(torch.func.vmap(lambda s: pullback(s)[0])(seeds), mesh)
    return JBI, JFI


def _diag_cumsum(G: torch.Tensor) -> torch.Tensor:
    """J[r, c] = Σ_{d=0}^{min(r,c)} G[r-d, c-d] for a block array G — the
    block-Toeplitz recursion (`SteadyStateJacobian.jl:358-371`) as gather →
    cumsum along diagonals → gather."""
    n = G.shape[0]
    device = G.device
    offs = torch.arange(-(n - 1), n, device=device)
    t = torch.arange(n, device=device)
    s_ids = t[None, :] + offs[:, None]                   # (2n-1, n)
    valid = (s_ids >= 0) & (s_ids < n)
    A = G[s_ids.clamp(0, n - 1), t[None, :].expand_as(s_ids)]
    A = A * valid.reshape(*valid.shape, *([1] * (G.ndim - 2))).to(G.dtype)
    Acum = torch.cumsum(A, dim=1)
    r = torch.arange(n, device=device)[:, None]
    c = torch.arange(n, device=device)[None, :]
    return Acum[r - c + n - 1, c]


def assemble_jacobian(blocks: torch.Tensor, k: int, JBI: Mapping, JFI: Mapping,
                      model, boundary_correction: bool = False) -> torch.Tensor:
    """Direct blocks + indirect products → the dense
    (n_endog·(T-1), n_endog·(T-1)) J̄, rows residual period-major and
    columns x period-major (`SteadyStateJacobian.jl:399-410`).

    `boundary_correction` adds the lag-1 direct block at the first period's
    diagonal block, the reference's left-boundary fix (`:374-379`); off by
    default, because the assembly matches a dense Jacobian without it
    (`hank_tpu/solvers/ss_jacobian.py:24-29`)."""
    cs = model.compspec
    Tm1 = cs.T - 1
    nE = cs.n_endog
    H = torch.zeros((Tm1, Tm1, nE, nE), dtype=config.dtype, device=model.device)
    for v in model.vars_of_type("heterogeneous"):
        fi = JFI[v].reshape(nE, Tm1, -1)
        bi = JBI[v].reshape(nE, Tm1, -1)
        H = H + torch.einsum("jtm,ism->tsji", fi, bi)

    # Direct edge placement (`:307-319`): corner δ=0, right column lags,
    # top row leads.
    L = Tm1 - 1
    H[L, L] += blocks[k]
    for d in range(1, k + 1):
        H[L - d, L] += blocks[k + d]
        H[L, L - d] += blocks[k - d]

    J = _diag_cumsum(H.flip(0, 1))
    if boundary_correction and k >= 1:
        J[0, 0] += blocks[k + 1]
    return J.permute(0, 2, 1, 3).reshape(Tm1 * nE, Tm1 * nE)


def get_steady_state_jacobian(ss, model, boundary_correction: bool = False,
                              mesh=None) -> torch.Tensor:
    """J̄ at `ss` (the ending steady state, the linearisation point of the
    path); the system must be square (`SteadyStateJacobian.jl:41-65`).
    `boundary_correction` as in `assemble_jacobian`. With `mesh`, the JDI,
    JBI and JFI seeds split over its "dp" axis, whose size must divide
    n_endog (ValueError before any sweep); at one rank the result is the
    unmeshed J̄ bit for bit wherever a J̄ build repeats its own bits (on the
    card, under torch's deterministic algorithms: the lottery's scatter_add
    sums with atomics there)."""
    if len(model.equations) != model.compspec.n_endog:
        raise ValueError(
            f"System is not square: {len(model.equations)} equations but "
            f"{model.compspec.n_endog} endogenous variables. "
            "Newton-Raphson requires n_eq == n_endog.")
    _seed_block(model.compspec.n_endog, mesh)
    blocks, k = direct_jacobian_blocks(ss, model, mesh=mesh)
    JBI, JFI = intermediate_jacobians(ss, model, mesh=mesh)
    return assemble_jacobian(blocks, k, JBI, JFI, model,
                             boundary_correction=boundary_correction)


def _full_pipeline(ss_initial, ss_ending, model, exog_paths):
    """x at the ending steady state and the full plain F under `exog_paths`
    (constant at the ending steady state by default)."""
    from hank_tpu_torch.solvers.newton import make_full_residual_fn

    x_ss, exog_ss, _ = _ss_paths(ss_ending, model)
    return x_ss, make_full_residual_fn(model, ss_initial, ss_ending,
                                       exog_ss if exog_paths is None else exog_paths)


def direct_jacobian_columns(ss_initial, ss_ending, model, columns,
                            exog_paths: Mapping[str, torch.Tensor] | None = None,
                            mode: str = "jvp", fd_step: float | None = None) -> torch.Tensor:
    """Selected columns of the full pipeline's Jacobian at the ending steady
    state's x, by one `torch.func.jvp` per column (mode "jvp") or by forward
    differences (mode "fd", step `fd_step`, by default the model's
    `CompSpec.dx`, `ModelParser.jl:312-317`): the reference's
    `directJVPJacobian` / `directNumJacobian` (`SteadyState.jl:296-356`)
    for any column set. Returns (n, len(columns))."""
    if mode not in ("jvp", "fd"):
        raise ValueError(f"mode must be 'jvp' or 'fd', got {mode!r}")
    if fd_step is None:
        fd_step = model.compspec.dx
    x_ss, F = _full_pipeline(ss_initial, ss_ending, model, exog_paths)
    n = x_ss.shape[0]
    if mode == "jvp":
        cols = [torch.func.jvp(F, (x_ss,), (_unit(n, c, x_ss),))[1] for c in columns]
    else:
        base = F(x_ss)
        cols = [(F(x_ss + fd_step * _unit(n, c, x_ss)) - base) / fd_step for c in columns]
    return torch.stack(cols, dim=1)


def dense_path_jacobian(ss_initial, ss_ending, model,
                        exog_paths: Mapping[str, torch.Tensor] | None = None) -> torch.Tensor:
    """The dense ∂F/∂x of the full pipeline at the ending steady state's x,
    every column by forward-mode AD: the ground truth the Toeplitz assembly
    is held to. One vmapped JVP over all n_endog·(T-1) seeds, so small T
    only."""
    x_ss, F = _full_pipeline(ss_initial, ss_ending, model, exog_paths)
    return _seed_sweep(F, x_ss, 0, x_ss.shape[0]).T
