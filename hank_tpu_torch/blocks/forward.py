"""Distribution forward block: push-forward + aggregation (port of
`hank_tpu/blocks/forward.py`, `ForwardIteration.jl:253-420`).

The reference's `lax.scan` is a Python loop; reverse mode goes through
torch autograd of the scatter lottery and the Markov matmul.
"""

from __future__ import annotations

from typing import Mapping

import torch

from hank_tpu_torch.ops.transition import exog_apply, lottery_apply_multi


def forward_iteration(
    policy_seqs: Mapping[str, torch.Tensor],
    model,
    D_initial: torch.Tensor,
) -> dict[str, torch.Tensor]:
    """Evolve the distribution and aggregate each heterogeneous variable:
    agg[v][t] = Σ policy[v][t] · D_{t+1}, with the distribution updated
    before aggregating (`ForwardIteration.jl:297-308`). Returns (T-1,) paths.
    """
    het_keys = model.vars_of_type("heterogeneous")
    endog_dims = model.endog_dims()
    grids = [d.grid for d in endog_dims]
    transitions = [d.transition for d in model.exog_dims()]
    policy_vars = [d.policy_var for d in endog_dims]
    k = len(endog_dims)

    first = policy_seqs[het_keys[0]]
    D = D_initial.to(first.dtype)
    aggs = {v: [] for v in het_keys}
    for t in range(first.shape[0]):
        D_half = lottery_apply_multi([policy_seqs[v][t] for v in policy_vars], D, grids)
        D = exog_apply(D_half, transitions, k)
        for v in het_keys:
            aggs[v].append(torch.sum(policy_seqs[v][t] * D))
    return {v: torch.stack(a) for v, a in aggs.items()}


def distribution_path(
    policy_seqs: Mapping[str, torch.Tensor],
    model,
    D_initial: torch.Tensor,
) -> torch.Tensor:
    """The full (T, *state_shape) distribution path (diagnostics and
    `utils/plotting.plot_distribution`): D[0] = D_initial, D[t] the
    distribution after transition step t (`hank_tpu/blocks/forward.py:63-88`)."""
    endog_dims = model.endog_dims()
    grids = [d.grid for d in endog_dims]
    transitions = [d.transition for d in model.exog_dims()]
    policy_vars = [d.policy_var for d in endog_dims]
    k = len(endog_dims)

    Ds = [D_initial]
    for t in range(policy_seqs[policy_vars[0]].shape[0]):
        D_half = lottery_apply_multi([policy_seqs[v][t] for v in policy_vars], Ds[-1], grids)
        Ds.append(exog_apply(D_half, transitions, k))
    return torch.stack(Ds)
