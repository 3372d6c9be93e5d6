"""Distribution transition ops: Young (2010) lottery + exogenous mixing
(port of `hank_tpu/ops/transition.py`).

The one-axis lottery is a comparison-sum bracket search + `scatter_add`
(out of place, so both forward- and reverse-mode AD run through it); the
joint two-axis lottery is the dense soft-one-hot contraction; the exogenous
transition is a dense matmul with the Markov matrix. State arrays are
`(*endog_shape, *exog_shape)`.
"""

from __future__ import annotations

from functools import reduce
from typing import Sequence

import torch

from hank_tpu_torch.ops.clip import clip


def searchsorted_left(grid: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """First index j with grid[j] >= p, as a comparison-sum."""
    return (grid < p[..., None]).sum(dim=-1)


def lottery_weights(policy: torch.Tensor, grid: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Bracket index jc ∈ [1, n−1] and upper weight w ∈ [0, 1] of the Young
    lottery: mass w goes to grid[jc], 1 − w to grid[jc−1]
    (`ForwardIteration.jl:54-73`). The clip kills the gradient at clamped
    states (`ForwardIteration.jl:171-184`)."""
    n = grid.shape[0]
    jc = searchsorted_left(grid, policy).clamp(1, n - 1)
    lo = grid[jc - 1]
    hi = grid[jc]
    w = clip((policy - lo) / (hi - lo), 0.0, 1.0)
    return jc, w


def lottery_apply(policy: torch.Tensor, D: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """D'[a', rest] = Σ_a weight(a → a'; policy[a, rest]) · D[a, rest] over
    axis 0 (`ForwardIteration.jl:37-78`)."""
    shape = D.shape
    n_a = shape[0]
    p2 = policy.reshape(n_a, -1)
    d2 = D.reshape(n_a, -1)
    jc, w = lottery_weights(p2, grid)
    out2 = torch.zeros_like(d2).scatter_add(0, jc - 1, (1.0 - w) * d2)
    out2 = out2.scatter_add(0, jc, w * d2)
    return out2.reshape(shape)


def exog_apply(D: torch.Tensor, transitions: Sequence[torch.Tensor],
               n_endog_axes: int) -> torch.Tensor:
    """D'[..., e'] = Σ_e Pi[e, e'] D[..., e] per exogenous axis
    (`ForwardIteration.jl:280-284`)."""
    for i, Pi in enumerate(transitions):
        axis = n_endog_axes + i
        D = torch.movedim(torch.tensordot(D, Pi, dims=([axis], [0])), -1, axis)
    return D


def forward_step(policy: torch.Tensor, D: torch.Tensor, grid: torch.Tensor,
                 transitions: Sequence[torch.Tensor],
                 n_endog_axes: int = 1) -> torch.Tensor:
    """One period of distribution evolution (`ForwardIteration.jl:95-99`)."""
    return exog_apply(lottery_apply(policy, D, grid), transitions, n_endog_axes)


def lottery_apply_multi(policies: Sequence[torch.Tensor], D: torch.Tensor,
                        grids: Sequence[torch.Tensor]) -> torch.Tensor:
    """Joint Young lottery over the k = len(policies) endogenous axes
    (`hank_tpu/ops/transition.py:209-252`); k = 1 and k = 2.

    For k = 2 the mass of each state splits over the 4 bracketing corners
    with product weights, written as the reference's dense soft-one-hot
    contraction (`_lottery_apply_2d_dense`, `:273-310`) on every device: a
    corner scatter-add would sum with float atomics on CUDA and its results
    would change from run to run.
    """
    k = len(policies)
    if k == 1:
        return lottery_apply(policies[0], D, grids[0])
    if k != 2:
        raise ValueError(f"the joint lottery takes 1 or 2 endogenous axes, got {k}")
    shape = D.shape
    n_b, n_a = shape[:2]
    d2 = D.reshape(n_b, n_a, -1)
    (jb, wb), (ja, wa) = (lottery_weights(p.reshape(n_b, n_a, -1), g)
                          for p, g in zip(policies, grids))
    Sb = _soft_one_hot(jb, wb, n_b)                # (b, a, F, n_b)
    Sa = _soft_one_hot(ja, wa, n_a)                # (b, a, F, n_a)
    out = torch.einsum("bafj,bafm->jmf", Sb * d2[..., None], Sa)
    return out.reshape(shape)


def _soft_one_hot(jc: torch.Tensor, w: torch.Tensor, n: int) -> torch.Tensor:
    """Per-axis lottery row: mass 1 − w at jc − 1 and w at jc, on a new
    trailing axis of length n."""
    t = torch.arange(n, device=jc.device)
    zero = torch.zeros((), dtype=w.dtype, device=w.device)
    return (torch.where(jc[..., None] - 1 == t, 1.0 - w[..., None], zero)
            + torch.where(jc[..., None] == t, w[..., None], zero))


def dense_endog_transition(policy: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Dense (n_a, n_a, F) lottery matrices W[a', a, f]: column (a, f) is the
    mass split of state (a, f)'s policy."""
    n_a = grid.shape[0]
    p2 = policy.reshape(n_a, -1)
    F = p2.shape[1]
    jc, w = lottery_weights(p2, grid)
    a_idx = torch.arange(n_a, device=grid.device)[:, None]
    f_idx = torch.arange(F, device=grid.device)[None, :]
    flat_lo = ((jc - 1) * n_a + a_idx) * F + f_idx
    flat_hi = (jc * n_a + a_idx) * F + f_idx
    W = torch.zeros(n_a * n_a * F, dtype=policy.dtype, device=policy.device)
    W = W.scatter_add(0, flat_lo.reshape(-1), (1.0 - w).reshape(-1))
    W = W.scatter_add(0, flat_hi.reshape(-1), w.reshape(-1))
    return W.reshape(n_a, n_a, F)


def exog_kron(transitions: Sequence[torch.Tensor]) -> torch.Tensor:
    """Row-stochastic (F, F) Kronecker product of the exogenous transitions
    (last exogenous dimension fastest)."""
    return reduce(torch.kron, transitions)


def dense_full_transition(policy: torch.Tensor, grid: torch.Tensor,
                          transitions: Sequence[torch.Tensor]) -> torch.Tensor:
    """Dense column-stochastic (n_m, n_m) one-period transition:
    Λ[(a'·F + f'), (a·F + f)] = Π_total[f, f'] · W[a', a, f]."""
    W = dense_endog_transition(policy, grid)       # (n_a', n_a, F)
    P = exog_kron(transitions)                     # (F, F)
    n_a, _, F = W.shape
    lam = torch.einsum("baf,fg->bgaf", W, P)       # [a', f', a, f]
    return lam.reshape(n_a * F, n_a * F)
