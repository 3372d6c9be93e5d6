"""The one traffic generator: reads a mix's data file and makes, from the
seed, the shock paths of every request.

A mix names its request kind ("single_path" or "ensemble", the program's
two entry points), the rows a request solves (`batch`), the shocked
variable and its path X_t = level + scale · rho^t for t = 1 … T−1, where
each of level, scale and rho is a number or a [low, high] range drawn
uniformly per path. Draws are stratified: each run of `strata`
consecutive paths takes one value in each of `strata` equal slices of the
range, in an order and at a place within its slice drawn from the seed.
So every seed sees nearly the same set of shocks, in another order.
"""

from __future__ import annotations

import numpy as np

PARAMETERS = ("level", "scale", "rho")


class Traffic:
    def __init__(self, mix: dict, T: int, seed: int):
        self.mix, self.T, self.seed = mix, T, abs(int(seed))
        self.batch = int(mix.get("batch", 1))
        self.strata = int(mix.get("strata", self.batch))
        self.var = mix["shock"]["var"]

    def _draws(self, name: str, k: np.ndarray, warm: bool) -> np.ndarray:
        """Parameter `name` of the paths with global indices k."""
        spec = self.mix["shock"][name]
        if not isinstance(spec, list):
            return np.full(k.shape, float(spec))
        lo, hi = spec
        S = self.strata
        if warm:                     # the slices' midpoints, in order
            return lo + (hi - lo) * (k % S + 0.5) / S
        out = np.empty(k.shape)
        for c in np.unique(k // S):
            rng = np.random.default_rng([self.seed, int(c), PARAMETERS.index(name)])
            perm, u = rng.permutation(S), rng.random(S)
            sel = k // S == c
            p = k[sel] % S
            out[sel] = lo + (hi - lo) * (perm[p] + u[p]) / S
        return out

    def request(self, i: int, warm: bool = False) -> tuple[dict, dict]:
        """({var: (batch, T−1) float64 paths}, {parameter: (batch,) draws})
        of request i; `warm` gives the seed-free request of the set-up."""
        k = i * self.batch + np.arange(self.batch)
        p = {n: self._draws(n, k, warm) for n in PARAMETERS}
        t = np.arange(1, self.T, dtype=np.float64)
        X = p["level"][:, None] + p["scale"][:, None] * p["rho"][:, None] ** t[None, :]
        return {self.var: X}, p
