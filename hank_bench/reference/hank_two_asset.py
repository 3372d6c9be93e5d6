"""Plain reference of the two-asset HANK economy with Calvo access to the
illiquid account and a fiscal shock.

Households hold liquid bonds b and illiquid capital claims a, with income
state e and an access flag (drawn i.i.d. with probability λ each period).
Without access the account accrues at ra up to the grid's top, the excess
paid out as liquid income, and b' follows from the endogenous grid method.
With access the household chooses total savings s and the split s = b' + a'
at the root of the first-order gap W_b − W_a (plus the χ diversification
penalty), then b' + a' from the endogenous grid method over s. The carried
value is the pair of marginal values (V_b, V_a). The distribution moves by
the joint two-axis lottery and the income and access draws. Equations:

    B = Bg
    KS = A
    ra + δ = α · KS(−1)^(α−1)
    w = (1 − α) · KS(−1)^α
    tau · w = r · Bg + G

A path x stacks the endogenous (r, ra, w, tau, KS) period by period; its
residual stacks the five equations period by period, each as left side −
right side. The household step is a frozen copy of the program's plain
version, in plain torch; nothing of the program is imported.
"""

from __future__ import annotations

import torch

from hank_bench.reference.common import (fixed_point, interp_columns, lag, lottery_weights,
                                         make_dimensions, stationary)

ENDOGENOUS = ("r", "ra", "w", "tau", "KS")
SHOCK = "G"


def _inv_marg(W, gamma):
    """W^(−1/γ); at γ = 2 as rsqrt with one Newton polish."""
    if gamma == 2.0:
        y = torch.rsqrt(W)
        return y * (1.5 - 0.5 * W * y * y)
    return W ** (-1.0 / gamma)


def _marg(c, gamma):
    """c^(−γ); at γ = 2 as 1/(c·c)."""
    return 1.0 / (c * c) if gamma == 2.0 else c ** (-gamma)


def _bracket(grid, q):
    """(index in [1, n − 1], lo, hi, t clipped to [0, 1], q strictly inside)."""
    n = grid.shape[0]
    idx = (grid < q[..., None]).sum(dim=-1).clamp(1, n - 1)
    lo, hi = grid[idx - 1], grid[idx]
    return idx, lo, hi, ((q - lo) / (hi - lo)).clamp(0.0, 1.0), (q > grid[0]) & (q < grid[-1])


def _interp_axis(W, grid, q, axis):
    """W interpolated along `axis` at queries q shaped like W's leading dims."""
    idx, _, _, t, _ = _bracket(grid, q)
    extra = W.dim() - q.dim()
    if extra:
        idx = idx.reshape(*idx.shape, *([1] * extra)).expand(*idx.shape, *W.shape[q.dim():])
        t = t.reshape(*t.shape, *([1] * extra))
    lo, hi = W.gather(axis, idx - 1), W.gather(axis, idx)
    return lo + t * (hi - lo)


def _bilinear(W, bgrid, agrid, qb, qa):
    """Value and slopes (d/db, d/da) of W(b, a, e[, S]) at (qb, qa) per e;
    slopes are 0 outside the grids."""
    ib, b_lo, b_hi, tb, in_b = _bracket(bgrid, qb)
    ia, a_lo, a_hi, ta, in_a = _bracket(agrid, qa)
    e_idx = torch.arange(W.shape[2], device=W.device).expand_as(ib)
    W00, W01 = W[ib - 1, ia - 1, e_idx], W[ib - 1, ia, e_idx]
    W10, W11 = W[ib, ia - 1, e_idx], W[ib, ia, e_idx]
    if W.dim() == 4:
        tb, ta, b_lo, b_hi, a_lo, a_hi, in_b, in_a = (
            z[..., None] for z in (tb, ta, b_lo, b_hi, a_lo, a_hi, in_b, in_a))
    val = ((1 - tb) * (1 - ta) * W00 + (1 - tb) * ta * W01
           + tb * (1 - ta) * W10 + tb * ta * W11)
    zero = torch.zeros((), dtype=val.dtype, device=val.device)
    db = torch.where(in_b, ((1 - ta) * (W10 - W00) + ta * (W11 - W01)) / (b_hi - b_lo), zero)
    da = torch.where(in_a, ((1 - tb) * (W01 - W00) + tb * (W11 - W10)) / (a_hi - a_lo), zero)
    return val, db, da


class Economy:
    """The configuration's economy on `device`, computed in `dtype`."""

    def __init__(self, config: dict, device, dtype=torch.float64):
        dims = make_dimensions(config)
        t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa: E731
        self.bgrid, self.agrid = t(dims["liquid"][0]), t(dims["illiquid"][0])
        self.e, self.Pi = t(dims["income"][0]), t(dims["income"][1])
        self.P = t(dims["access"][1])
        p = config["params"]
        self.beta, self.gamma, self.alpha, self.delta = p["β"], p["γ"], p["α"], p["δ"]
        self.borrow, self.Bg, self.chi = p["borrow_cons"], p["Bg"], p["portfolio_reg"]
        self.T = config["T"]
        self.dtype, self.device = dtype, device

    def to(self, dtype) -> "Economy":
        other = object.__new__(Economy)
        other.__dict__.update(self.__dict__)
        for k in ("bgrid", "agrid", "e", "Pi", "P"):
            setattr(other, k, getattr(self, k).to(dtype))
        other.dtype = dtype
        return other

    @property
    def shape(self):
        return (self.bgrid.shape[0], self.agrid.shape[0], self.e.shape[0], 2)

    # ── households ────────────────────────────────────────────────────────
    def bellman(self, value_next, r, ra, w, tau):
        """One backward step: value_next (2, n_b, n_a, n_e, 2), the packed
        (V_b, V_a) over (b, a, e, access), at scalar prices → (value,
        {"B", "A", "C"} policies (n_b, n_a, n_e, 2))."""
        bgrid, agrid, Pi = self.bgrid, self.agrid, self.Pi
        lam = self.P[0, 1]
        n_b, n_a, n_e, _ = self.shape
        dtype, device = value_next.dtype, value_next.device
        beta, gamma = self.beta, self.gamma
        y_e = ((1.0 - tau) * w).clamp(min=1e-9) * self.e
        btop, atop = bgrid[-1], agrid[-1]

        # Continuations on the (b', a', e) lattice: access draw, then e'.
        Vmix = (1.0 - lam) * value_next[..., 0] + lam * value_next[..., 1]
        WW = (beta * (Vmix @ Pi.T)).clamp(min=1e-12)
        Wb, Wa = WW[0], WW[1]
        WWs = WW.permute(1, 2, 3, 0)

        # No access: capped accrual, payout to the liquid budget, liquid EGM.
        a_raw = (1.0 + ra) * agrid
        a_next = torch.minimum(a_raw, atop)
        payout = a_raw - a_next
        capped = a_raw >= atop
        inc_n = payout[None, :, None] + y_e[None, None, :]
        W_n = _interp_axis(WWs, agrid, a_next[None, :, None].expand(n_b, n_a, n_e), axis=1)
        Wb_n, Wa_n = W_n[..., 0], W_n[..., 1]
        implied_b = (_inv_marg(Wb_n, gamma) + bgrid[:, None, None] - inc_n) / (1.0 + r)
        pol_b_n = interp_columns(bgrid, implied_b.reshape(n_b, n_a * n_e),
                                 bgrid[:, None].expand(n_b, n_a * n_e))
        pol_b_n = torch.minimum(pol_b_n.reshape(n_b, n_a, n_e).clamp(min=self.borrow), btop)
        pol_a_n = a_next[None, :, None].expand(n_b, n_a, n_e)
        c_n = ((1.0 + r) * bgrid[:, None, None] + inc_n - pol_b_n).clamp(min=1e-12)

        # Access: the split of total savings s, then the EGM over s.
        s_grid = bgrid * ((btop + atop) / btop)
        n_s = n_b
        s2 = s_grid[:, None].expand(n_s, n_e)
        G = Wb - Wa
        if self.chi > 0.0:
            mid = 0.5 * s2
            wsum_mid = _bilinear(Wb + Wa, bgrid, agrid, mid, mid)[0]
            pen = self.chi * wsum_mid / torch.maximum(s2, s_grid[1])
        else:
            pen = None

        def g_fun(a_s):
            gv, g_db, g_da = _bilinear(G, bgrid, agrid, s2 - a_s, a_s)
            gp = g_da - g_db
            if pen is not None:
                gv, gp = gv + pen * (a_s - 0.5 * s2), gp + pen
            return gv, gp

        zero = torch.zeros((), dtype=dtype, device=device)
        cand = torch.cat([torch.zeros((1, n_s, n_e), dtype=dtype, device=device),
                          agrid[:, None, None].expand(n_a, n_s, n_e),
                          s2[None] - bgrid[:, None, None].expand(n_b, n_s, n_e),
                          s2[None]], dim=0)
        cand = torch.minimum(cand.clamp(min=0.0), s2[None])
        g_cand = g_fun(cand)[0]
        g_lo, g_hi = g_cand[0], g_cand[-1]
        neg = g_cand < 0
        big = torch.tensor(torch.finfo(dtype).max, dtype=dtype, device=device)
        lo = torch.amax(torch.where(neg, cand, -big), dim=0)
        hi = torch.amin(torch.where(neg, big, cand), dim=0)
        g0 = torch.amax(torch.where(neg, g_cand, -big), dim=0)
        g1 = torch.amin(torch.where(neg, big, g_cand), dim=0)
        has_neg, has_pos = neg.any(dim=0), (~neg).any(dim=0)
        lo = torch.where(has_neg, lo, zero)
        g0 = torch.where(has_neg, g0, -torch.ones_like(g0))
        hi = torch.where(has_pos, hi, s2)
        g1 = torch.where(has_pos, g1, torch.ones_like(g1))
        # g is quadratic between breakpoints: its root from the ends and the
        # midpoint of the bracket.
        h = hi - lo
        gm = g_fun(0.5 * (lo + hi))[0]
        a1c = -3.0 * g0 + 4.0 * gm - g1
        a2c = 2.0 * g0 - 4.0 * gm + 2.0 * g1
        disc = (a1c * a1c - 4.0 * a2c * g0).clamp(min=0.0)
        sgn = torch.where(a1c >= 0, torch.ones_like(a1c), -torch.ones_like(a1c))
        q = -0.5 * (a1c + sgn * torch.sqrt(disc))
        one = torch.ones_like(q)
        u_a = g0 / torch.where(q.abs() > 0, q, one)
        u_b = q / torch.where(a2c.abs() > 0, a2c, one)
        in01 = (u_a >= 0.0) & (u_a <= 1.0) & (q.abs() > 0)
        u = torch.where(in01, u_a, u_b).clamp(0.0, 1.0)
        a_iter = torch.where(h > 0, lo + u * h, lo)
        # One Newton step at the root (its value; the program also takes
        # its derivative from it).
        g_at, g_a = g_fun(a_iter)
        a_star = torch.minimum((a_iter - g_at / g_a.clamp(min=1e-10)).clamp(min=0.0), s2)
        a_star = torch.where(g_lo >= 0, zero, torch.where(g_hi <= 0, s2, a_star))
        b_star = s2 - a_star
        w_ba, w_db, w_da = _bilinear(WWs, bgrid, agrid, b_star, a_star)
        wb_s, wa_s = w_ba[..., 0], w_ba[..., 1]
        wbp = w_da[..., 0] - w_db[..., 0]
        wap = w_da[..., 1] - w_db[..., 1]
        gp_s = wbp - wap
        combo_ok = ((a_star > 0.0) & (a_star < s2) & (wbp >= 0.0) & (wap <= 0.0)
                    & (gp_s > 1e-10))
        M_combo = (wbp * wa_s - wap * wb_s) / torch.where(combo_ok, gp_s, torch.ones_like(gp_s))
        W_s = torch.where(combo_ok, M_combo, torch.maximum(wb_s, wa_s))
        w_knots = _inv_marg(W_s, gamma) + s2

        w_grid = ((1.0 + r) * bgrid[:, None, None] + (1.0 + ra) * agrid[None, :, None]
                  + y_e[None, None, :])
        wq = w_grid.reshape(n_b * n_a, n_e)
        pol_s = interp_columns(wq, w_knots, s2).clamp(min=0.0)
        pol_a_a = interp_columns(pol_s, s2, a_star)
        pol_a_a = torch.minimum(pol_a_a.clamp(min=0.0), torch.minimum(pol_s, atop))
        pol_b_a = torch.minimum((pol_s - pol_a_a).clamp(min=self.borrow), btop)
        c_a = (wq - pol_b_a - pol_a_a).clamp(min=1e-12)
        pol_b_a, pol_a_a, c_a = (z.reshape(n_b, n_a, n_e) for z in (pol_b_a, pol_a_a, c_a))

        # Envelopes; without access the illiquid margin is worthless at the cap.
        Va_n = torch.where(capped[None, :, None], zero,
                           _interp_axis(Wa_n, bgrid, pol_b_n, axis=0))
        up_n, up_a = _marg(c_n, gamma), _marg(c_a, gamma)
        value = torch.stack([torch.stack([(1.0 + r) * up_n, (1.0 + r) * up_a], dim=-1),
                             torch.stack([(1.0 + ra) * Va_n, (1.0 + ra) * up_a], dim=-1)])
        return value, {"B": torch.stack([pol_b_n, pol_b_a], dim=-1),
                       "A": torch.stack([pol_a_n, pol_a_a], dim=-1),
                       "C": torch.stack([c_n, c_a], dim=-1)}

    def push(self, pol: dict, D: torch.Tensor) -> torch.Tensor:
        """One period of the distribution (n_b, n_a, n_e, 2): the joint
        lottery over (b', a'), then the income and access draws."""
        n_b, n_a, n_e, _ = self.shape
        jb, wb = lottery_weights(pol["B"], self.bgrid)
        ja, wa = lottery_weights(pol["A"], self.agrid)
        Sb = self._one_hot(jb, wb, n_b)
        Sa = self._one_hot(ja, wa, n_a)
        D = torch.einsum("baesj,baesm,baes->jmes", Sb, Sa, D)
        return torch.einsum("jmes,ef,st->jmft", D, self.Pi, self.P)

    @staticmethod
    def _one_hot(j, w, n):
        """Mass 1 − w at j − 1 and w at j, on a new last axis of length n."""
        t = torch.arange(n, device=j.device)
        zero = torch.zeros((), dtype=w.dtype, device=w.device)
        return (torch.where(j[..., None] - 1 == t, 1.0 - w[..., None], zero)
                + torch.where(j[..., None] == t, w[..., None], zero))

    # ── steady state ──────────────────────────────────────────────────────
    def household_ss(self, vars: dict):
        """(V*, D*, {"B", "A", "C"} aggregates) at constant prices."""
        prices = [torch.tensor(vars[k], dtype=self.dtype, device=self.device)
                  for k in ("r", "ra", "w", "tau")]
        V0 = torch.ones((2, *self.shape), dtype=self.dtype, device=self.device)
        V = fixed_point(lambda v: self.bellman(v, *prices)[0], V0, 1e-12, 50_000)
        pol = self.bellman(V, *prices)[1]
        D = stationary(self._transition(pol)).reshape(self.shape)
        return V, D, {k: float((pol[k] * D).sum()) for k in pol}

    def _transition(self, pol: dict) -> torch.Tensor:
        """Dense column-stochastic Λ[(b', a', e', s'), (b, a, e, s)]."""
        n_b, n_a, n_e, _ = self.shape
        N = n_b * n_a * n_e * 2
        jb, wb = lottery_weights(pol["B"].reshape(-1), self.bgrid)
        ja, wa = lottery_weights(pol["A"].reshape(-1), self.agrid)
        cols = torch.arange(N, device=self.device)
        W = torch.zeros(n_b * n_a, N, dtype=self.dtype, device=self.device)
        for db, fb in ((-1, 1.0 - wb), (0, wb)):
            for da, fa in ((-1, 1.0 - wa), (0, wa)):
                W.index_put_(((jb + db) * n_a + ja + da, cols), fb * fa, accumulate=True)
        # Exogenous (e, s) of each column, and its draw of (e', s').
        PP = torch.kron(self.Pi, self.P)                          # [(e,s), (e',s')]
        f = cols % (n_e * 2)
        return (W[:, None, :] * PP[f].T[None, :, :]).reshape(N, N)

    def steady_state(self, vars: dict) -> tuple[torch.Tensor, dict]:
        """The equations at a steady state `vars` (the judged scalars), with
        B and A from this reference's own households."""
        V, D, agg = self.household_ss(vars)
        K, a, d = vars["KS"], self.alpha, self.delta
        res = torch.tensor([agg["B"] - self.Bg,
                            K - agg["A"],
                            vars["ra"] + d - a * K ** (a - 1.0),
                            vars["w"] - (1.0 - a) * K ** a,
                            vars["tau"] * vars["w"] - (vars["r"] * self.Bg + vars["G"])],
                           dtype=torch.float64)
        return res, {"V": V, "D": D}

    # ── transition path ───────────────────────────────────────────────────
    def path_residual(self, x: torch.Tensor, shocks: dict, ss0: dict, ssT: dict,
                      hh0: dict, hhT: dict) -> torch.Tensor:
        """Residuals (B, 5·(T−1)) of paths x (B, 5·(T−1)) under shock paths
        {"G": (B, T−1)}, one path at a time, in this economy's dtype."""
        return torch.stack([self._one_path(x[b], shocks[SHOCK][b], ss0, hh0, hhT)
                            for b in range(x.shape[0])])

    def _one_path(self, x, G, ss0, hh0, hhT):
        Tm1 = self.T - 1
        r, ra, w, tau, K = x.to(self.dtype).reshape(Tm1, 5).unbind(-1)
        G = G.to(self.dtype)
        V = hhT["V"].to(self.dtype)
        pols = [None] * Tm1
        for t in range(Tm1 - 1, -1, -1):
            V, pols[t] = self.bellman(V, r[t], ra[t], w[t], tau[t])
        D = hh0["D"].to(self.dtype)
        agg = {k: [] for k in ("B", "A", "C")}
        for t in range(Tm1):
            D = self.push(pols[t], D)
            for k in agg:
                agg[k].append((pols[t][k] * D).sum())
        Bh, Ah = torch.stack(agg["B"]), torch.stack(agg["A"])
        K_lag = lag(K, torch.tensor(ss0["KS"], dtype=self.dtype, device=x.device))
        a, d = self.alpha, self.delta
        R = torch.stack([Bh - self.Bg, K - Ah, ra + d - a * K_lag ** (a - 1.0),
                         w - (1.0 - a) * K_lag ** a, tau * w - (r * self.Bg + G)], dim=-1)
        return R.reshape(-1).to(torch.float64)
