"""One-asset HANK model functions, monetary-policy shock (port of
`hank_tpu/models/hank_one_asset.py`).

Household block: standard incomplete-markets EGM over bonds. Income is
endowment share e·(Y − τ) with lump-sum taxes τ = r·B̄ funding bond interest,
so goods clearing (C = Y) holds by Walras whenever the bond market clears.
The `fused_prices` hook declares this step to be the canonical one-asset
CRRA EGM of the household-sweep kernels (`ops/fused_sweep.py`) under the
effective wage s = Y − r·B̄; the kernels' consumption aggregate is C.
"""

from __future__ import annotations

import torch

from hank_tpu_torch.ops.clip import floor
from hank_tpu_torch.ops.egm import interp_columns


def endowmentY(T: int, **kwargs) -> torch.Tensor:
    """Constant unit endowment path (float64 CPU tensor)."""
    return torch.ones((T,), dtype=torch.float64)


def monetaryShock(T: int, *, size: float = -0.002, rho: float = 0.6, **kwargs) -> torch.Tensor:
    """AR(1)-decaying nominal-rate shock eps_m_t = size · ρᵗ (expansionary
    for size < 0); a float64 CPU tensor."""
    t = torch.arange(1, T + 1, dtype=torch.float64)
    return size * rho ** t


def fused_prices(xp, exog_paths, model):
    """Canonical-EGM price hook of the household-sweep kernels: income is
    (Y − τ)·e with τ = r·B̄, so the effective wage is s = Y − r·B̄ and the
    return stays r. xp is the (T-1, n_endog) endogenous block; Y is
    exogenous, so its tangent is zero under the solver's JVP."""
    endog = model.vars_of_type("endogenous")
    r = xp[:, endog.index("r")]
    Y = exog_paths["Y"].to(xp.dtype)
    return r, Y - r * model.params["Bbar"]


def ValueFunction(value_next, xvals, model):
    """One EGM step for the bond-holding household:

      1. Euler: c = (β · E[∂V'/∂b' | e])^(−1/γ)
      2. Implied bonds today: b = (c + b' − inc(e)) / (1+r)
      3. Interpolate the savings policy onto the bond grid; clamp at the
         borrowing constraint
      4. Consumption from the budget; marginal value (1+r)·c^(−γ)

    Returns {"Value", "B" (bond policy), "C" (consumption policy)}.
    """
    bonds = model.heterogeneity["bonds"]
    income = model.heterogeneity["income"]
    grid = bonds.grid
    Pi = income.transition
    n_b, n_e = bonds.n, income.n
    p = model.params
    r = xvals["r"]

    tau = r * p["Bbar"]                      # lump-sum tax funds bond interest
    inc = (xvals["Y"] - tau) * income.grid   # (n_e,) endowment share by state

    policy_b = grid[:, None].expand(n_b, n_e)
    inc_mat = inc[None, :].expand(n_b, n_e)

    expected = floor(value_next @ Pi.T, 1e-12)
    cmat = (p["β"] * expected) ** (-1.0 / p["γ"])

    implied = (cmat - inc_mat + policy_b) / (1.0 + r)
    gridded = floor(interp_columns(grid, implied, policy_b), p["borrow_cons"])

    c_grid = floor((1.0 + r) * policy_b + inc_mat - gridded, 1e-12)
    value_current = (1.0 + r) * c_grid ** (-p["γ"])
    return {"Value": value_current, "B": gridded, "C": c_grid}
