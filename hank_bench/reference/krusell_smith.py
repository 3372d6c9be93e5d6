"""Plain reference of the Krusell-Smith (1998) economy: one-asset households
solved by the endogenous grid method (Carroll 2006), Young's lottery for
the distribution, and the four equilibrium equations

    Y  = Z · KS(−1)^α
    r + δ = α · Z · KS(−1)^(α−1)
    w  = (1 − α) · Z · KS(−1)^α
    KS = KD                       (KD: the households' savings, aggregated)

A path x stacks the endogenous (Y, KS, r, w) period by period; its residual
stacks the four equations period by period, each as left side − right side.
Batched over paths (a leading axis). Plain torch: nothing of the program.
"""

from __future__ import annotations

import torch

from hank_bench.reference.common import (fixed_point, interp_columns, lag, lottery_1d,
                                         lottery_weights, make_dimensions, stationary)

ENDOGENOUS = ("Y", "KS", "r", "w")
SHOCK = "Z"


class Economy:
    """The configuration's economy on `device`, computed in `dtype`."""

    def __init__(self, config: dict, device, dtype=torch.float64):
        dims = make_dimensions(config)
        t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa: E731
        self.grid = t(dims["wealth"][0])
        self.e, self.Pi = t(dims["productivity"][0]), t(dims["productivity"][1])
        p = config["params"]
        self.beta, self.gamma, self.alpha = p["β"], p["γ"], p["α"]
        self.delta, self.borrow = p["δ"], p["borrow_cons"]
        self.T = config["T"]
        self.dtype, self.device = dtype, device

    def to(self, dtype) -> "Economy":
        """The same economy computed in `dtype`."""
        other = object.__new__(Economy)
        other.__dict__.update(self.__dict__)
        for k in ("grid", "e", "Pi"):
            setattr(other, k, getattr(self, k).to(dtype))
        other.dtype = dtype
        return other

    # ── households ────────────────────────────────────────────────────────
    def egm(self, V: torch.Tensor, r: torch.Tensor, w: torch.Tensor):
        """One backward step: next period's marginal value V (..., n_a, n_e)
        at returns r and wages w (...,) → (this period's V, savings a')."""
        r, w = r[..., None, None], w[..., None, None]
        a, e = self.grid[:, None], self.e[None, :]
        c = (self.beta * (V @ self.Pi.T).clamp(min=1e-12)) ** (-1.0 / self.gamma)
        implied = (c - w * e + a) / (1.0 + r)
        a_next = interp_columns(self.grid, implied, a.expand(implied.shape[-2:]))
        a_next = a_next.clamp(min=self.borrow)
        cons = ((1.0 + r) * a + w * e - a_next).clamp(min=1e-12)
        return (1.0 + r) * cons ** (-self.gamma), a_next

    def push(self, a_next: torch.Tensor, D: torch.Tensor) -> torch.Tensor:
        """One period of the distribution: the lottery, then income draws."""
        return lottery_1d(a_next, D, self.grid) @ self.Pi

    # ── steady state ──────────────────────────────────────────────────────
    def household_ss(self, r: float, w: float):
        """(V*, D*, KD) of households facing constant r and w."""
        rt, wt = (torch.tensor(v, dtype=self.dtype, device=self.device) for v in (r, w))
        V0 = torch.ones(self.grid.shape[0], self.e.shape[0], dtype=self.dtype,
                        device=self.device)
        V = fixed_point(lambda v: self.egm(v, rt, wt)[0], V0, 1e-13, 20_000)
        a_next = self.egm(V, rt, wt)[1]
        D = stationary(self._transition(a_next)).reshape(a_next.shape)
        return V, D, float((a_next * D).sum())

    def _transition(self, a_next: torch.Tensor) -> torch.Tensor:
        """Dense column-stochastic Λ[(a', e'), (a, e)]."""
        n_a, n_e = a_next.shape
        j, w = lottery_weights(a_next, self.grid)
        W = torch.zeros(n_a, n_a, n_e, dtype=self.dtype, device=self.device)
        W.scatter_add_(0, (j - 1)[None], (1.0 - w)[None])
        W.scatter_add_(0, j[None], w[None])
        # W[a', a, e]; then e → e' by Π.
        return torch.einsum("bae,ef->bfae", W, self.Pi).reshape(n_a * n_e, n_a * n_e)

    def steady_state(self, vars: dict) -> tuple[torch.Tensor, dict]:
        """The equations at a steady state `vars` (the judged scalars), with
        KD from this reference's own households: (residuals, households)."""
        V, D, KD = self.household_ss(vars["r"], vars["w"])
        Z, K, a, d = vars["Z"], vars["KS"], self.alpha, self.delta
        res = torch.tensor([vars["Y"] - Z * K ** a,
                            vars["r"] + d - a * Z * K ** (a - 1.0),
                            vars["w"] - (1.0 - a) * Z * K ** a,
                            K - KD], dtype=torch.float64)
        return res, {"V": V, "D": D}

    # ── transition path ───────────────────────────────────────────────────
    def path_residual(self, x: torch.Tensor, shocks: dict, ss0: dict, ssT: dict,
                      hh0: dict, hhT: dict) -> torch.Tensor:
        """Residuals (B, 4·(T−1)) of paths x (B, 4·(T−1)) under shock paths
        {"Z": (B, T−1)}, from the initial steady state ss0 (its households
        hh0) to ssT (hhT), computed in this economy's dtype."""
        B, Tm1 = x.shape[0], self.T - 1
        X = x.to(self.dtype).reshape(B, Tm1, 4)
        Y, K, r, w = X.unbind(-1)
        Z = shocks[SHOCK].to(self.dtype)
        V = hhT["V"].to(self.dtype).expand(B, *hhT["V"].shape)
        policies = [None] * Tm1
        for t in range(Tm1 - 1, -1, -1):
            V, policies[t] = self.egm(V, r[:, t], w[:, t])
        D = hh0["D"].to(self.dtype).expand(B, *hh0["D"].shape)
        KD = []
        for t in range(Tm1):
            D = self.push(policies[t], D)
            KD.append((policies[t] * D).sum(dim=(-2, -1)))
        KD = torch.stack(KD, dim=-1)
        K_lag = lag(K, torch.full((B,), ss0["KS"], dtype=self.dtype, device=x.device))
        a, d = self.alpha, self.delta
        R = torch.stack([Y - Z * K_lag ** a,
                         r + d - a * Z * K_lag ** (a - 1.0),
                         w - (1.0 - a) * Z * K_lag ** a,
                         K - KD], dim=-1)
        return R.reshape(B, -1).to(torch.float64)
