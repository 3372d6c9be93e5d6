"""Grid construction primitives.

Capability parity with the reference's built-in grid functions
(`GeneralStructures.jl:242-261, 474-525`): the double-exponential asset grid
and the Rouwenhorst (1995) AR(1) discretization. Computed in float64 numpy at
model-build time (these run once; on-device constants afterwards).
"""

from __future__ import annotations

import numpy as np


def make_double_exponential_grid(amin: float, amax: float, n: int) -> np.ndarray:
    """Double-exponential asset grid on [amin, amax] with n points.

    More points near the origin where savings-policy nonlinearity concentrates.
    Transformation: a = amin + exp(exp(u) - 1) - 1 with u uniform on
    [0, log(1 + log(1 + amax - amin))]. Reference: `GeneralStructures.jl:474-483`.
    """
    u_max = np.log(1.0 + np.log(1.0 + amax - amin))
    u = np.linspace(0.0, u_max, n)
    return amin + np.exp(np.exp(u) - 1.0) - 1.0


def rouwenhorst(n: int, rho: float, sigma: float) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Rouwenhorst (1995) discretization of a log-AR(1).

    Returns (Pi, D, z): the (n, n) row-stochastic transition matrix, its
    stationary distribution, and the level grid normalized so E[z] = 1.
    Preferred over Tauchen for persistent processes (Kopecky-Suen 2009).
    Reference: `GeneralStructures.jl:500-525`.
    """
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

    D = invariant_dist_rowstoch(Pi)

    alpha = 2.0 * sigma / np.sqrt(n - 1)
    z = np.exp(alpha * np.arange(n))
    z = z / np.sum(z * D)
    return Pi, D, z


def invariant_dist_rowstoch(Pi: np.ndarray) -> np.ndarray:
    """Stationary distribution of a row-stochastic chain (numpy, build time).

    Linear-system trick: pin D[0] = 1, solve the remaining rows of
    (I - Pi^T) D = 0, then normalize. Reference: `ForwardIteration.jl:436-442`.
    """
    PiT = Pi.T
    n = PiT.shape[0]
    M = np.eye(n - 1) - PiT[1:, 1:]
    b = PiT[1:, 0]
    tail = np.linalg.solve(M, b)
    D = np.concatenate([[1.0], tail])
    return D / D.sum()


# ── YAML-facing wrappers (names referenced by grid_function entries) ─────────

def double_exponential(*, n: int, grid_min: float, grid_max: float) -> np.ndarray:
    """Endogenous-dimension grid function: returns a (n,) vector.

    Contract: `ModelParser.jl:20-23` — endogenous grid fns return one vector.
    """
    return make_double_exponential_grid(float(grid_min), float(grid_max), int(n))


def rouwenhorst_discretization(*, n: int, rho: float, sigma: float) -> tuple[np.ndarray, np.ndarray]:
    """Exogenous-dimension grid function: returns (grid, Pi).

    Contract: `ModelParser.jl:20-23` — exogenous grid fns return (grid, Pi).
    """
    Pi, _, z = rouwenhorst(int(n), float(rho), float(sigma))
    return z, Pi


def linear_grid(*, n: int, grid_min: float, grid_max: float) -> np.ndarray:
    """Uniform endogenous grid (extra built-in beyond the reference)."""
    return np.linspace(float(grid_min), float(grid_max), int(n))


BUILTIN_GRID_FUNCTIONS = {
    "double_exponential": double_exponential,
    "rouwenhorst_discretization": rouwenhorst_discretization,
    "linear": linear_grid,
}
