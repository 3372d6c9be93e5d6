"""Linear algebra for the solvers (port of `hank_tpu/ops/linalg.py`).

The H100 has native FP64, so dense solves and the J̄ inverse are plain f64
`torch.linalg` calls (the reference's f32-LU + refinement exists because
XLA:TPU has no f64 LU). Both are differentiable in forward and reverse mode.

- `dense_solve` / `make_reusable_solver` ↔ `J \\ z`, `gmres!(·, J̄, ·)`
  (`SteadyState.jl:197`, `NewtonRaphson.jl:97-98`)
- `invariant_dist_colstoch` ↔ `invariant_dist` (`ForwardIteration.jl:436-442`)
- `make_invariant_solver` ↔ the same, matrix-free, for large state spaces
- `gmres_matfree` ↔ `gmres!(R, J̄, ·)` with an opaque operator
- `rayleigh_quotient` ↔ `GeneralStructures.jl:559-561`
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from hank_tpu_torch.config import TINY


def dense_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Differentiable dense solve of A x = b."""
    return torch.linalg.solve(A, b)


def make_reusable_solver(A: torch.Tensor) -> Callable[[torch.Tensor], torch.Tensor]:
    """Invert A once; return `solve(b) = A⁻¹ b` with the inverse exposed as
    `solve.A_inv` (the path solver's GMRES preconditioner applies it as one
    matvec per Arnoldi step, `NewtonRaphson.jl:97-98`)."""
    A_inv = torch.linalg.inv(A)

    def solve(b: torch.Tensor) -> torch.Tensor:
        return A_inv @ b

    solve.A_inv = A_inv
    return solve


def invariant_dist_colstoch(Lam: torch.Tensor) -> torch.Tensor:
    """Stationary distribution of a column-stochastic matrix: solve
    (I − Λ) D = 0 with the last (redundant) balance row replaced by Σ D = 1.
    Stays nonsingular when a pinned state would be transient; differentiable
    in Λ (replaces `ForwardIteration.jl:480-558`)."""
    n = Lam.shape[0]
    A = torch.eye(n, dtype=Lam.dtype, device=Lam.device) - Lam
    A = torch.cat([A[:-1], torch.ones_like(A[-1:])], dim=0)
    b = torch.zeros(n, dtype=Lam.dtype, device=Lam.device)
    b[-1] = 1.0
    D = dense_solve(A, b)
    return D / torch.sum(D)


def accelerated_fixed_point(step, v0, eps: float, max_iter: int):
    """Iterate v ← step(v) until the sup-norm change is ≤ eps, with a
    safeguarded Aitken extrapolation every 20 iterations after the 40th:
    the extrapolation is kept only if one verification step shows a smaller
    one-step residual than the plain iterate's (`hank_tpu/ops/linalg.py:
    173-204`, `hank_tpu/solvers/steady_state.py:81-119`)."""
    v = v0
    diff_prev = math.inf
    diff = math.inf
    it = 0
    while diff > eps and it < max_iter:
        v_new = step(v)
        diff = float(torch.max(torch.abs(v_new - v)))
        if it % 20 == 19 and it > 40:
            lam = min(max(diff / max(diff_prev, TINY), 0.0), 0.995)
            v_ex = v_new + (v_new - v) * (lam / (1 - lam))
            d_ex = float(torch.max(torch.abs(step(v_ex) - v_ex)))
            if math.isfinite(d_ex) and d_ex < diff:
                v_new = v_ex
        v = v_new
        diff_prev = diff
        it += 1
    return v


def make_invariant_solver(apply_fn, *, eps: float = 1e-13, max_iter: int = 200_000):
    """Matrix-free stationary distribution with implicit differentiation
    (`hank_tpu/ops/linalg.py:156-251`).

    `apply_fn(params, D) -> D'` is one period of the column-stochastic
    transition as ops (the joint lottery and the Markov mixing), linear in
    D; `params` is a list of tensors (the endogenous policies). Returns
    `solve(params, D0) -> D*`, normalised to sum 1.

    Primal: the safeguarded Aitken-accelerated power iteration. Forward-mode
    rule: the implicit-function system (I − P) dD = ∂_p apply · dp on the
    sum-zero subspace, solved by `gmres_matfree` on the deflated operator
    v ↦ v − P v + mean(v) (nonsingular on the whole space for an ergodic
    chain, with the same sum-zero solution).
    """
    # The last solve: a Jacobian's `torch.func.jvp` columns rerun the
    # forward at the same policies, and get the same D* (bit for bit).
    cache = {}

    class _Invariant(torch.autograd.Function):
        @staticmethod
        def forward(D0, *params):
            key = (D0, *params)
            if "key" in cache and all(torch.equal(a, b) for a, b in zip(cache["key"], key)):
                return cache["D"].clone()
            D = accelerated_fixed_point(lambda d: apply_fn(list(params), d), D0,
                                        eps, max_iter)
            D = D / torch.sum(D)
            cache.update(key=tuple(t.clone() for t in key), D=D.detach().clone())
            return D

        @staticmethod
        def setup_context(ctx, inputs, output):
            ctx.save_for_forward(*inputs[1:], output)

        @staticmethod
        def jvp(ctx, dD0, *dparams):
            *params, D_star = ctx.saved_tensors
            shape = D_star.shape
            # P is linear in D, so its derivative along v is P applied to v.
            b = torch.func.jvp(lambda *p: apply_fn(list(p), D_star),
                               tuple(params), tuple(dparams))[1]
            b = (b - torch.sum(b) / b.numel()).reshape(-1)

            def matvec(v):
                vD = v.reshape(shape)
                return (vD - apply_fn(params, vD) + torch.sum(vD) / vD.numel()).reshape(-1)

            dD, _ = gmres_matfree(matvec, b, torch.zeros_like(b), restart=40,
                                  maxiter=8, tol=1e-12,
                                  atol=eps * float(torch.linalg.norm(b)))
            dD = dD.reshape(shape)
            return dD - torch.sum(dD) / dD.numel()

    def solve(params, D0):
        return _Invariant.apply(D0, *params)

    return solve


def _hessenberg_ls(H: torch.Tensor, beta: torch.Tensor, m: int):
    """min_y ‖β e₁ − H y‖ for the (m+1, m) upper-Hessenberg H by Givens QR
    and back substitution. Columns zeroed by a breakdown leave a ~0
    diagonal; their y entries are pinned to 0."""
    Hm = H.clone()
    g = torch.zeros(m + 1, dtype=H.dtype, device=H.device)
    g[0] = beta
    for j in range(m):
        a, c_ = Hm[j, j], Hm[j + 1, j]
        r = torch.sqrt(a * a + c_ * c_)
        safe = torch.clamp(r, min=TINY)
        cs = torch.where(r > 0, a / safe, torch.ones_like(r))
        sn = torch.where(r > 0, c_ / safe, torch.zeros_like(r))
        row_j = cs * Hm[j] + sn * Hm[j + 1]
        row_j1 = -sn * Hm[j] + cs * Hm[j + 1]
        Hm[j], Hm[j + 1] = row_j, row_j1
        gj, gj1 = g[j].clone(), g[j + 1].clone()
        g[j] = cs * gj + sn * gj1
        g[j + 1] = -sn * gj + cs * gj1
    diag = torch.diagonal(Hm[:m, :])
    good = torch.abs(diag) > TINY
    y = torch.zeros(m, dtype=H.dtype, device=H.device)
    for i in range(m):
        j = m - 1 - i
        s = g[j] - torch.dot(Hm[j, :m], y)
        y[j] = torch.where(good[j], s / torch.where(good[j], diag[j], torch.ones_like(s)),
                           torch.zeros_like(s))
    return y


def gmres_matfree(matvec: Callable[[torch.Tensor], torch.Tensor],
                  b: torch.Tensor,
                  x0: torch.Tensor,
                  M: Callable[[torch.Tensor], torch.Tensor] | None = None,
                  *,
                  restart: int = 20,
                  maxiter: int = 2,
                  tol: float = 1e-12,
                  atol: float = 0.0) -> tuple[torch.Tensor, torch.Tensor]:
    """Left-preconditioned restarted GMRES with an opaque operator
    (`hank_tpu/ops/linalg.py:254-376`, ported as it is).

    Solves M(A(d)) = M(b). Each cycle runs the full `restart`-step Arnoldi
    window: CGS2 (classical Gram-Schmidt twice), a zero basis vector on a
    happy breakdown, then the Givens least squares. Cycles stop when the
    preconditioned residual norm is ≤ max(tol·‖M b‖, atol) or after
    `maxiter` cycles. The Arnoldi steps stay on the operator's device with
    no host synchronisation; the (m+1, m) least squares runs on the host.

    Returns (x, preconditioned_residual_norm).
    """
    if M is None:
        M = lambda v: v  # noqa: E731
    m = restart
    dtype, device = b.dtype, b.device
    n = b.shape[0]

    def Ahat(v):
        return M(matvec(v))

    bhat = M(b)
    tol_abs = max(float(tol) * float(torch.linalg.norm(bhat)), float(atol))

    x = x0
    rnorm = float("inf")
    it = 0
    while rnorm > tol_abs and it < maxiter:
        r = bhat - Ahat(x)
        beta = torch.linalg.norm(r)
        V = torch.zeros((m + 1, n), dtype=dtype, device=device)
        V[0] = r / torch.clamp(beta, min=TINY)
        H = torch.zeros((m + 1, m), dtype=dtype, device=device)
        for j in range(m):
            w = Ahat(V[j])
            # Rows > j of V are still zero, so V @ w projects onto the
            # built basis only; the second pass makes CGS as stable as MGS.
            h1 = V @ w
            w = w - V.T @ h1
            h2 = V @ w
            w = w - V.T @ h2
            h = h1 + h2
            hn = torch.linalg.norm(w)
            # Happy breakdown: emit a ZERO basis vector (A·0 = 0 keeps every
            # later column zero; the least squares pins their y to 0).
            ok = hn > 1e-12 * torch.clamp(torch.linalg.norm(h), min=TINY)
            V[j + 1] = torch.where(ok, w / torch.clamp(hn, min=TINY), torch.zeros_like(w))
            H[:, j] = h
            H[j + 1, j] = torch.where(ok, hn, torch.zeros_like(hn))
        H_host = H.cpu()
        beta_host = beta.cpu()
        y = _hessenberg_ls(H_host, beta_host, m)
        # Residual against the ORIGINAL H (breakdown columns are pinned).
        e1 = torch.zeros(m + 1, dtype=dtype)
        e1[0] = beta_host
        rnorm = float(torch.linalg.norm(e1 - H_host @ y))
        x = x + V[:m].T @ y.to(device)
        it += 1
    return x, torch.tensor(rnorm, dtype=dtype)


def rayleigh_quotient(My: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """⟨y, M y⟩ / ⟨y, y⟩ given the product M y; 0 when y = 0
    (`GeneralStructures.jl:559-561`)."""
    den = torch.dot(y, y)
    pos = den > 0
    return torch.where(pos, torch.dot(y, My) / torch.where(pos, den, torch.ones_like(den)),
                       torch.zeros_like(den))
