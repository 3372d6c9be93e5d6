"""First-order (linearised) sequence-space impulse responses (port of
`hank_tpu/solvers/linear.py`).

The linear solution is one preconditioned Newton step from the
steady-state path, x_lin = x_ss − J̄⁻¹·F(x_ss; Z): one full-precision
residual and one J̄⁻¹ matvec. It is the warm start of the two-asset
production route (the GMRES-endgame-only boehl solve). The residual is the
path solver's own (`newton.residual_route`'s "auto": on the card kernel 2
or the two-asset f64 pair, on CPU tensors the plain f64 pipeline, which the
reference uses everywhere): at 50×70×5×2 on the card the plain f64 F costs
1.58 s, five times the whole route through the pair (PERF.md §6).
"""

from __future__ import annotations

from typing import Mapping

import torch

from hank_tpu_torch.ops.linalg import make_reusable_solver
from hank_tpu_torch.solvers.newton import residual_route


def linear_impulse_response(Jbar: torch.Tensor, exog_paths: Mapping[str, torch.Tensor],
                            model, ss_initial, ss_ending, *,
                            compute_residual: bool = True):
    """Linearised perfect-foresight path. Returns (x_lin, info): x_lin is
    the flat (n_endog·(T-1),) path; info holds "dx" (the deviation from the
    steady-state path), "f0_norm" = ‖F(x_ss; Z)‖ and, when
    `compute_residual`, "residual_norm" = ‖F(x_lin; Z)‖ (O(dZ²): how
    nonlinear the shock is). Norms are Python floats."""
    Tm1 = model.compspec.T - 1
    endog = model.vars_of_type("endogenous")
    x_ss = torch.stack([torch.as_tensor(ss_ending.vars[k], dtype=Jbar.dtype,
                                        device=Jbar.device) for k in endog]).repeat(Tm1)
    F = residual_route(model, ss_initial, ss_ending, exog_paths)
    f0 = F(x_ss)
    dx = -make_reusable_solver(Jbar)(f0)
    x_lin = x_ss + dx
    info = {"dx": dx, "f0_norm": float(torch.linalg.norm(f0))}
    if compute_residual:
        info["residual_norm"] = float(torch.linalg.norm(F(x_lin)))
    return x_lin, info


def irf_table(x: torch.Tensor, model, ss) -> dict[str, torch.Tensor]:
    """A flat path as named per-variable deviations from `ss`:
    {name: (T-1,) tensor of x_t − x_ss}."""
    Tm1 = model.compspec.T - 1
    endog = model.vars_of_type("endogenous")
    mat = x.reshape(Tm1, len(endog))
    return {k: mat[:, i] - ss.vars[k] for i, k in enumerate(endog)}
