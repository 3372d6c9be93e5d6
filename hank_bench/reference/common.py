"""Shared pieces of the plain reference: grids, the column interpolation of
the endogenous grid method, the Young lottery, the fixed points of the
steady state, and the dense stationary distribution.

Plain torch and numpy only: nothing here imports the program under test.
Every function takes a leading batch of paths where a path carries one.
"""

from __future__ import annotations

import math

import numpy as np
import torch


# ── grids, computed in float64 numpy from a configuration's numbers ─────────

def double_exponential_grid(n: int, grid_min: float, grid_max: float) -> np.ndarray:
    """a = min + exp(exp(u) − 1) − 1, u uniform on [0, log(1 + log(1 + max − min))]."""
    u = np.linspace(0.0, np.log(1.0 + np.log(1.0 + grid_max - grid_min)), n)
    return grid_min + np.exp(np.exp(u) - 1.0) - 1.0


def rouwenhorst(n: int, rho: float, sigma: float) -> tuple[np.ndarray, np.ndarray]:
    """Rouwenhorst (1995) discretisation of a log-AR(1): (levels normalised to
    unit mean under the stationary law, row-stochastic transition)."""
    p = (1.0 + rho) / 2.0
    Pi = np.array([[p, 1.0 - p], [1.0 - p, p]])
    for m in range(3, n + 1):
        old = Pi
        Pi = np.zeros((m, m))
        Pi[:-1, :-1] += p * old
        Pi[:-1, 1:] += (1.0 - p) * old
        Pi[1:, :-1] += (1.0 - p) * old
        Pi[1:, 1:] += p * old
        Pi[1:-1, :] /= 2.0
    # Stationary law: pin the first mass, solve the rest of (I − Πᵀ)π = 0.
    tail = np.linalg.solve(np.eye(n - 1) - Pi.T[1:, 1:], Pi.T[1:, 0])
    pi = np.concatenate([[1.0], tail])
    pi /= pi.sum()
    z = np.exp(2.0 * sigma / np.sqrt(n - 1) * np.arange(n))
    return z / np.sum(z * pi), Pi


def access_process(n: int, lam: float) -> tuple[np.ndarray, np.ndarray]:
    """I.i.d. Calvo access: state 0 locked, 1 free to rebalance, drawn with
    probability `lam` whatever the current state."""
    if n != 2:
        raise ValueError(f"the access process has 2 states, got {n}")
    return np.array([0.0, 1.0]), np.array([[1.0 - lam, lam], [1.0 - lam, lam]])


GRIDS = {"double_exponential": double_exponential_grid,
         "rouwenhorst": rouwenhorst,
         "access": access_process}


def make_dimensions(config: dict) -> dict:
    """{dimension: (grid, transition or None)} in float64 numpy, from the
    configuration's `dimensions` entries (`grid` names the function, the
    other keys are its arguments)."""
    out = {}
    for name, spec in config["dimensions"].items():
        args = {k: v for k, v in spec.items() if k != "grid"}
        made = GRIDS[spec["grid"]](**args)
        out[name] = made if isinstance(made, tuple) else (made, None)
    return out


# ── endogenous grid method and lottery ───────────────────────────────────────

def interp_columns(x: torch.Tensor, knots: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Linear interpolation per column with flat extrapolation.

    knots: (..., n_k, n_c) knot vectors, one per column; x: (..., n_q, n_c)
    queries (or (n_q,) shared by every column); vals: like knots (or (n_k,)).
    The bracket of a query is the count of knots below it, clipped to
    [1, n_k − 1], which also holds for locally non-monotone knots."""
    n_k, n_c = knots.shape[-2:]
    if x.dim() == 1:
        x = x[:, None].expand(x.shape[0], n_c)
    x = x.expand(*knots.shape[:-2], *x.shape[-2:])
    if vals.dim() == 1:
        vals = vals[:, None].expand(n_k, n_c)
    vals = vals.expand(knots.shape)
    idx = (knots.unsqueeze(-3) < x.unsqueeze(-2)).sum(dim=-2).clamp(1, n_k - 1)
    lo, hi = knots.gather(-2, idx - 1), knots.gather(-2, idx)
    v_lo, v_hi = vals.gather(-2, idx - 1), vals.gather(-2, idx)
    denom = hi - lo
    t = ((x - lo) / torch.where(denom > 0, denom, torch.ones_like(denom))).clamp(0.0, 1.0)
    return v_lo + t * (v_hi - v_lo)


def lottery_weights(policy: torch.Tensor, grid: torch.Tensor):
    """Young's lottery of each policy on a sorted grid: (upper index j in
    [1, n − 1], weight w on grid[j], 1 − w on grid[j − 1])."""
    n = grid.shape[0]
    j = (grid < policy.unsqueeze(-1)).sum(dim=-1).clamp(1, n - 1)
    lo, hi = grid[j - 1], grid[j]
    return j, ((policy - lo) / (hi - lo)).clamp(0.0, 1.0)


def lottery_1d(policy: torch.Tensor, D: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Mass of D (..., n_a, F) moved along the wealth axis by the lottery of
    policy (..., n_a, F)."""
    j, w = lottery_weights(policy, grid)
    out = torch.zeros_like(D).scatter_add(-2, j - 1, (1.0 - w) * D)
    return out.scatter_add(-2, j, w * D)


# ── steady state ─────────────────────────────────────────────────────────────

def fixed_point(step, v0: torch.Tensor, tol: float, max_iter: int) -> torch.Tensor:
    """Iterate v ← step(v) until the largest change is ≤ tol. Every 20 steps
    past the 40th an Aitken extrapolation along the last change is tried and
    kept only where one more step from it changes less than the plain step
    did."""
    v, change, change_prev = v0, math.inf, math.inf
    for it in range(max_iter):
        v_new = step(v)
        change = float((v_new - v).abs().max())
        if it > 40 and it % 20 == 19 and math.isfinite(change):
            lam = min(max(change / max(change_prev, 1e-300), 0.0), 0.995)
            v_ex = v_new + (v_new - v) * (lam / (1.0 - lam))
            change_ex = float((step(v_ex) - v_ex).abs().max())
            if math.isfinite(change_ex) and change_ex < change:
                v_new = v_ex
        v, change_prev = v_new, change
        if change <= tol:
            return v
    raise RuntimeError(f"fixed point: change {change:.3e} > {tol:.1e} after {max_iter} steps")


def stationary(Lam: torch.Tensor) -> torch.Tensor:
    """The distribution D = Λ D (Λ column-stochastic), sum 1, by one dense
    solve with the last balance equation replaced by the sum."""
    n = Lam.shape[0]
    A = torch.eye(n, dtype=Lam.dtype, device=Lam.device) - Lam
    A[-1] = 1.0
    b = torch.zeros(n, dtype=Lam.dtype, device=Lam.device)
    b[-1] = 1.0
    return torch.linalg.solve(A, b)


def lag(x: torch.Tensor, first: torch.Tensor) -> torch.Tensor:
    """The series x (..., T) one period back, `first` (...,) in front."""
    return torch.cat([first.unsqueeze(-1).expand(*x.shape[:-1], 1), x[..., :-1]], dim=-1)
