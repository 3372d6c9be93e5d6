"""Sequence-space assembly: time shifts, padded xMat, residual dispatch
(port of `hank_tpu/blocks/assemble.py`, `GeneralStructures.jl:266-455`).

Row order is the variable order (endogenous, heterogeneous, exogenous,
`ModelParser.jl:357`); x is period-major, `x[t*n_endog + i]`.
"""

from __future__ import annotations

from typing import Mapping

import torch


def shift_lag(x: torch.Tensor, i: int) -> torch.Tensor:
    """Shift a series back by `i` periods, filling with x[0]
    (`GeneralStructures.jl:441-444`)."""
    return torch.cat([x[:1].expand(i), x[:-i]]) if i else x


def shift_lead(x: torch.Tensor, i: int) -> torch.Tensor:
    """Shift a series forward by `i` periods, filling with x[-1]
    (`GeneralStructures.jl:453-455`)."""
    return torch.cat([x[i:], x[-1:].expand(i)]) if i else x


def ss_column(model, ss_vars: Mapping[str, torch.Tensor], dtype, device) -> torch.Tensor:
    """Steady-state variable values as one (n_v,) column."""
    return torch.stack([torch.as_tensor(ss_vars[k], dtype=dtype, device=device)
                        for k in model.var_names()])


def assemble_full_xmat(
    x_endog: torch.Tensor,
    agg_seqs: Mapping[str, torch.Tensor],
    exog_paths: Mapping[str, torch.Tensor],
    model,
    ss_start_vars: Mapping[str, torch.Tensor],
    ss_end_vars: Mapping[str, torch.Tensor],
) -> torch.Tensor:
    """The padded (n_v, T_pad) matrix for the compiled residuals
    (`GeneralStructures.jl:299-306`): [initial-SS lag columns | path |
    ending-SS lead columns]."""
    cs = model.compspec
    Tm1 = cs.T - 1
    dtype, device = x_endog.dtype, x_endog.device
    rows = [x_endog.reshape(Tm1, cs.n_endog).T]
    het = model.vars_of_type("heterogeneous")
    if het:
        rows.append(torch.stack([agg_seqs[k].to(dtype) for k in het]))
    exo = model.vars_of_type("exogenous")
    if exo:
        rows.append(torch.stack([exog_paths[k].to(dtype) for k in exo]))
    middle = torch.cat(rows, dim=0)
    left = ss_column(model, ss_start_vars, dtype, device)[:, None].expand(cs.n_v, cs.max_lag)
    right = ss_column(model, ss_end_vars, dtype, device)[:, None].expand(cs.n_v, cs.max_lead)
    return torch.cat([left, middle, right], dim=1)


def residuals(x_mat: torch.Tensor, model) -> torch.Tensor:
    """Evaluate the compiled residuals (`Aggregation.jl:20-22`)."""
    return model.residuals_fn(x_mat, model.params)
