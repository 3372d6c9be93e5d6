"""Steady-state sequence-space Jacobian J̄ (port of
`hank_tpu/solvers/ss_jacobian.py`, Boehl 2024 / `SteadyStateJacobian.jl`).

F is decomposed by the chain rule into the direct blocks (JDI), the
backward policy responses (JBI) and the forward residual responses (JFI);
by block-Toeplitz invariance at the steady state one block column of each
suffices, and the full Jacobian follows from a diagonal cumulative sum.
JDI and JBI are `torch.func.vmap` over the seeds of one `torch.func.jvp`
(as the reference vmaps `jax.jvp`: one pass carries every seed's tangent);
JFI is one `torch.func.vjp` whose pullback is vmapped over the seeds.
"""

from __future__ import annotations

from typing import Mapping

import torch

from hank_tpu_torch.blocks.assemble import assemble_full_xmat, residuals as eval_residuals
from hank_tpu_torch.blocks.backward import backward_iteration
from hank_tpu_torch.blocks.forward import forward_iteration
from hank_tpu_torch.config import config


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


def direct_jacobian_blocks(ss, model) -> tuple[torch.Tensor, int]:
    """Direct blocks B_δ = ∂z_{p+δ}/∂x_p with policies frozen at SS, from
    n_endog JVPs at the interior period p = T-1-k-1
    (`SteadyStateJacobian.jl:112-145`). Returns (blocks, k) with blocks[j]
    (n_endog, n_endog) = [res_eq, x_var] for δ = j − k."""
    cs = model.compspec
    Tm1 = cs.T - 1
    nE = cs.n_endog
    x_ss, exog_ss, agg_ss = _ss_paths(ss, model)

    def g(x):
        x_mat = assemble_full_xmat(x, agg_ss, exog_ss, model, ss.vars, ss.vars)
        return eval_residuals(x_mat, model)

    k = max(cs.max_lag, cs.max_lead)
    p0 = Tm1 - 1 - k
    if p0 < 0:
        raise ValueError(f"perturbed period p={p0} out of range for T={cs.T}, k={k}")
    raw = _seed_sweep(g, x_ss, p0 * nE, nE)                          # (nE, Tm1*nE)
    blocks = torch.stack([raw[:, (p0 + d) * nE:(p0 + d + 1) * nE].T
                          for d in range(-k, k + 1)])
    return blocks, k


def intermediate_jacobians(ss, model) -> tuple[dict, dict]:
    """JBI[v], JFI[v]: (n_endog, T-1, *state_shape) one-block-columns
    (`SteadyStateJacobian.jl:187-256`)."""
    cs = model.compspec
    Tm1 = cs.T - 1
    nE = cs.n_endog
    x_ss, exog_ss, _ = _ss_paths(ss, model)
    het_keys = model.vars_of_type("heterogeneous")
    last = (Tm1 - 1) * nE

    def back(x):
        return backward_iteration(x, exog_ss, model, ss.vars, ss.value)

    JBI = _seed_sweep(back, x_ss, last, nE)

    pol_ss = {v: ss.policies[v].to(x_ss.dtype).expand(Tm1, *ss.policies[v].shape).clone()
              for v in het_keys}

    def fwd(policies):
        aggs = forward_iteration(policies, model, ss.D)
        x_mat = assemble_full_xmat(x_ss, aggs, exog_ss, model, ss.vars, ss.vars)
        return eval_residuals(x_mat, model)

    _, pullback = torch.func.vjp(fwd, pol_ss)
    seeds = torch.stack([_unit(Tm1 * nE, last + i, x_ss) for i in range(nE)])
    JFI = torch.func.vmap(lambda s: pullback(s)[0])(seeds)
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
                      model) -> torch.Tensor:
    """Direct blocks + indirect products → the dense
    (n_endog·(T-1), n_endog·(T-1)) J̄, rows residual period-major and
    columns x period-major (`SteadyStateJacobian.jl:399-410`)."""
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

    return _diag_cumsum(H.flip(0, 1)).permute(0, 2, 1, 3).reshape(Tm1 * nE, Tm1 * nE)


def get_steady_state_jacobian(ss, model) -> torch.Tensor:
    """J̄ at `ss` (the ending steady state, the linearisation point of the
    path); the system must be square (`SteadyStateJacobian.jl:41-65`). No
    boundary correction: the reference validates its assembly against a
    dense Jacobian, which needs none (`hank_tpu/solvers/ss_jacobian.py:24-29`)."""
    if len(model.equations) != model.compspec.n_endog:
        raise ValueError(
            f"System is not square: {len(model.equations)} equations but "
            f"{model.compspec.n_endog} endogenous variables. "
            "Newton-Raphson requires n_eq == n_endog.")
    blocks, k = direct_jacobian_blocks(ss, model)
    JBI, JFI = intermediate_jacobians(ss, model)
    return assemble_jacobian(blocks, k, JBI, JFI, model)
