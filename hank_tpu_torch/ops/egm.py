"""Endogenous Grid Method primitives (port of `hank_tpu/ops/egm.py`).

`interp_columns` is the gather form of the reference (`egm.py:125-135`): a
comparison-sum bracket search + two gathers + a clipped lerp per column. It
is differentiable in the query points, knots and values, and stays right
for locally non-monotone knots (`egm.py:7-9`).
"""

from __future__ import annotations

import torch

from hank_tpu_torch.ops.clip import clip, floor


def interp_columns(x: torch.Tensor, knots: torch.Tensor,
                   vals: torch.Tensor) -> torch.Tensor:
    """Column-wise linear interpolation with flat extrapolation.

    x: (n_q,) or (n_q, n_exog) queries; knots: (n_k, n_exog) per-column knot
    vectors; vals: (n_k,) or (n_k, n_exog). Returns (n_q, n_exog).
    """
    n_k, n_exog = knots.shape
    if x.ndim == 1:
        x = x[:, None].expand(x.shape[0], n_exog)
    if vals.ndim == 1:
        vals = vals[:, None].expand(vals.shape[0], n_exog)
    # idx[q, e] = #{k : knots[k, e] < x[q, e]}, clipped to a valid bracket.
    idx = (knots[None, :, :] < x[:, None, :]).sum(dim=1)
    idx = idx.clamp(1, n_k - 1)
    lo = torch.gather(knots, 0, idx - 1)
    hi = torch.gather(knots, 0, idx)
    v_lo = torch.gather(vals, 0, idx - 1)
    v_hi = torch.gather(vals, 0, idx)
    denom = hi - lo
    safe = torch.where(denom > 0, denom, torch.ones_like(denom))  # duplicate knots
    t = clip((x - lo) / safe, 0.0, 1.0)
    return v_lo + t * (v_hi - v_lo)


def egm_consumption(value_next: torch.Tensor, Pi: torch.Tensor,
                    beta: float, gamma: float) -> torch.Tensor:
    """Euler-equation inversion c = (β · E[∂V'/∂a' | e])^(−1/γ), the
    expectation over next-period productivity the matmul V' Πᵀ
    (`hank_tpu/ops/egm.py:138-146`, `KrusellSmith.jl:59`). value_next is
    (n_a, n_e). Unfloored, as in the reference; `crra_egm_step` floors E."""
    return (beta * (value_next @ Pi.T)) ** (-1.0 / gamma)


def crra_egm_step(value_next, r, w, grid, e_grid, Pi, beta, gamma, borrow_cons):
    """The canonical one-asset CRRA EGM step (`KrusellSmith.jl:43-83`).

    Returns (value, policy), both (n_a, n_e):
      E   = max(V' Πᵀ, 1e-12)                 (expectation over e')
      c   = (β E)^(−1/γ)                      (Euler inversion)
      a   = (c − w·e + a') / (1+r)            (implied wealth)
      a'  = max(interp(a ↦ grid), borrow_cons)
      c*  = max((1+r)·a + w·e − a', 1e-12)    (budget)
      V   = (1+r)·c*^(−γ)                     (envelope)
    The floors turn an infeasible Newton overshoot (e.g. r < −1) into large
    but finite residuals the line search can back away from.
    """
    n_a, n_e = grid.shape[0], e_grid.shape[0]
    policy_a = grid[:, None].expand(n_a, n_e)
    labor = e_grid[None, :].expand(n_a, n_e)

    expected = floor(value_next @ Pi.T, 1e-12)
    cmat = (beta * expected) ** (-1.0 / gamma)
    implied = (cmat - w * labor + policy_a) / (1.0 + r)
    gridded = interp_columns(grid, implied, policy_a)
    gridded = floor(gridded, borrow_cons)
    c_grid = floor((1.0 + r) * policy_a + w * labor - gridded, 1e-12)
    value = (1.0 + r) * c_grid ** (-gamma)
    return value, gridded
