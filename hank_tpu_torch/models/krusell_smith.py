"""Krusell-Smith (1998) model functions (port of `hank_tpu/models/krusell_smith.py`).

`exogenousZ` (productivity path generator), `ValueFunction` (one EGM step,
Carroll 2006, `KrusellSmith.jl:43-83`) and the `fused_prices` hook that
declares the household step to be the canonical one-asset CRRA EGM the
household-sweep kernels implement (`ops/fused_sweep.py`).
"""

from __future__ import annotations

import torch

from hank_tpu_torch.ops.egm import crra_egm_step


def exogenousZ(T: int, *, rho: float = 0.8, z_start: float = 1.0,
               z_end: float = 2.0, shock: float = 0.0,
               generator: torch.Generator | None = None,
               sigma: float = 0.0) -> torch.Tensor:
    """T-period productivity path from `z_start` toward `z_end`:
    Z_t = z_end + (z_start + shock − z_end) · ρᵗ, plus seeded AR(1)
    innovations when σ > 0 (drawn from the explicit `generator`; the
    reference's `KrusellSmith.jl:14-20` draws unseeded `randn()`).
    Returns a float64 CPU tensor.
    """
    t = torch.arange(1, T + 1, dtype=torch.float64)
    Z = z_end + (z_start + shock - z_end) * rho ** t
    if sigma > 0.0:
        if generator is None:
            raise ValueError("stochastic exogenousZ requires an explicit torch.Generator")
        eps = torch.randn(T, generator=generator, dtype=torch.float64)
        innov = sigma * (1.0 - rho**2) ** 0.5 * eps
        Z = Z + torch.cumsum(innov * rho ** (T - t), 0) * rho ** t
    return Z


def fused_prices(xp, exog_paths, model):
    """Canonical-EGM price hook of the household-sweep kernels: KS household
    income is w·e, so the effective wage IS the wage. xp is the
    (T-1, n_endog) endogenous block."""
    endog = model.vars_of_type("endogenous")
    return xp[:, endog.index("r")], xp[:, endog.index("w")]


def ValueFunction(value_next, xvals, model):
    """One EGM step for the KS household (`KrusellSmith.jl:43-83`): maps the
    next-period marginal value (n_a, n_e) to the current marginal value and
    the savings policy on the exogenous wealth grid."""
    wealth = model.heterogeneity["wealth"]
    prod = model.heterogeneity["productivity"]
    p = model.params
    value, policy = crra_egm_step(
        value_next, xvals["r"], xvals["w"], wealth.grid, prod.grid,
        prod.transition, p["β"], p["γ"], p["borrow_cons"])
    return {"Value": value, "KD": policy}
