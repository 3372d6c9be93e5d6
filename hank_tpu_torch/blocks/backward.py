"""Household backward block: EGM policy recursion along the transition path
(port of `hank_tpu/blocks/backward.py`, `BackwardIteration.jl:46-116`).

The reference's reversed `lax.scan` is a Python loop over periods.
"""

from __future__ import annotations

from typing import Mapping

import torch


def build_xvals_path(
    x_endog: torch.Tensor,
    exog_paths: Mapping[str, torch.Tensor],
    model,
    ss_end_vars: Mapping[str, torch.Tensor],
) -> torch.Tensor:
    """The (T-1, n_v) per-period aggregate values consumed by value_fn.

    Endogenous columns come from x, exogenous ones from the shock paths,
    heterogeneous ones are the ending-SS values (`BackwardIteration.jl:66-82`).
    """
    cs = model.compspec
    Tm1 = cs.T - 1
    x_by_period = x_endog.reshape(Tm1, cs.n_endog)
    endog_names = model.vars_of_type("endogenous")
    cols = []
    for name in model.var_names():
        var_type = model.variables[name].var_type
        if var_type == "endogenous":
            cols.append(x_by_period[:, endog_names.index(name)])
        elif var_type == "exogenous":
            cols.append(exog_paths[name].to(x_endog.dtype))
        else:
            cols.append(torch.as_tensor(ss_end_vars[name], dtype=x_endog.dtype,
                                        device=x_endog.device).expand(Tm1))
    return torch.stack(cols, dim=1)


def backward_iteration(
    x_endog: torch.Tensor,
    exog_paths: Mapping[str, torch.Tensor],
    model,
    ss_end_vars: Mapping[str, torch.Tensor],
    terminal_value: torch.Tensor,
) -> dict[str, torch.Tensor]:
    """Backward EGM recursion over the T-1 transition periods.

    Returns a dict mapping each heterogeneous variable to its
    (T-1, *state_shape) policy path; policies[v][t] is the period-(t+1)
    policy.
    """
    het_keys = model.vars_of_type("heterogeneous")
    names = model.var_names()
    xvals_path = build_xvals_path(x_endog, exog_paths, model, ss_end_vars)
    value = terminal_value
    out = {k: [] for k in het_keys}
    for t in range(xvals_path.shape[0] - 1, -1, -1):
        row = xvals_path[t]
        result = model.value_fn(value, {n: row[i] for i, n in enumerate(names)}, model)
        value = result["Value"]
        for k in het_keys:
            out[k].append(result[k])
    return {k: torch.stack(v[::-1]) for k, v in out.items()}
