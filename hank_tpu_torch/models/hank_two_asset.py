"""Two-asset HANK model functions, Calvo-access portfolio, fiscal shock
(port of `hank_tpu/models/hank_two_asset.py`).

Household state (liquid b, illiquid a, income e, access flag). Without
access the account accrues up to the grid cap, a' = min((1+ra)·a, a_max),
the excess paid out as liquid income, and the liquid choice is a standard
EGM. With access (i.i.d. probability λ) the household picks total savings s
and the portfolio split s = b' + a' at the root of the FOC gap
g(a') = W_b − W_a (+ the χ diversification penalty), then an EGM over s.
The carried value packs the two marginal values (V_b, V_a):
`ValueFunction.n_values = 2`. The module header of the reference explains
the economics, the cap valuation and the χ regularisation.

Ported in its gather/elementwise form (the reference's CPU default, exact
in f64). The reference's hat-basis lowerings and `one_minus` are TPU
workarounds and are not ported. The split root is the analytic
piecewise-quadratic breakpoint root, differentiated by one Newton step at
the detached root (the implicit-function derivative). Floors and clips go
through `ops/clip.py`, so derivatives split at a tie as in JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from hank_tpu_torch.ops.clip import clip, floor
from hank_tpu_torch.ops.egm import interp_columns


def fiscalShock(T: int, *, size: float = 0.01, rho: float = 0.8, **kwargs) -> torch.Tensor:
    """Transitory government-spending path G_t = size · ρᵗ, t = 1..T
    (tax-financed). Returns a float64 CPU tensor."""
    t = torch.arange(1, T + 1, dtype=torch.float64)
    return size * rho ** t


def access_process(n: int = 2, lam: float = 0.1):
    """I.i.d. Calvo access dimension: state 0 = locked, 1 = can rebalance.
    Returns (grid, Π) with identical rows (the draw ignores the current
    state)."""
    grid = np.array([0.0, 1.0])
    Pi = np.array([[1.0 - lam, lam], [1.0 - lam, lam]])
    return grid, Pi


def fused2_prices(xp, exog_paths, model):
    """Price hook of the two-asset household sweep (`ops/fused_sweep2.py`):
    the household takes the (r, ra, w, tau) endogenous columns as they are.
    Declaring it asserts that the Bellman step is `ValueFunction` below."""
    endog = model.vars_of_type("endogenous")
    return tuple(xp[:, endog.index(k)] for k in ("r", "ra", "w", "tau"))


def _crra_inv_marg(W, gamma):
    """W**(-1/γ); at γ = 2 as rsqrt with one Newton polish (the reference's
    form)."""
    if float(gamma) == 2.0:
        y = torch.rsqrt(W)
        return y * (1.5 - 0.5 * W * y * y)
    return W ** (-1.0 / gamma)


def _crra_marg(c, gamma):
    """c**(-γ); at γ = 2 as 1/(c·c)."""
    if float(gamma) == 2.0:
        return 1.0 / (c * c)
    return c ** (-gamma)


def _bracket(grid: torch.Tensor, q: torch.Tensor):
    """Count bracket of q in a sorted grid: (idx ∈ [1, n-1], lo, hi, t, interior)
    with t = clip((q − lo)/(hi − lo), 0, 1) and `interior` the open grid
    interval (slopes are zero outside it: flat extrapolation)."""
    n = grid.shape[0]
    idx = (grid < q[..., None]).sum(dim=-1).clamp(1, n - 1)
    lo, hi = grid[idx - 1], grid[idx]
    t = clip((q - lo) / (hi - lo), 0.0, 1.0)
    interior = (q > grid[0]) & (q < grid[-1])
    return idx, lo, hi, t, interior


def _interp_axis(W: torch.Tensor, grid: torch.Tensor, q: torch.Tensor, axis: int):
    """Piecewise-linear value of W along `axis` at queries q of W's shape
    (`_interp_val_slope`'s value, flat extrapolation); W may carry extra
    trailing dimensions."""
    idx, _, _, t, _ = _bracket(grid, q)
    extra = W.dim() - q.dim()
    if extra:
        idx = idx.reshape(*idx.shape, *([1] * extra)).expand(*idx.shape, *W.shape[q.dim():])
        t = t.reshape(*t.shape, *([1] * extra))
    Wlo = torch.gather(W, axis, idx - 1)
    Whi = torch.gather(W, axis, idx)
    return Wlo + t * (Whi - Wlo)


def _bilinear(W: torch.Tensor, bgrid, agrid, qb, qa):
    """Bilinear value and axis slopes of W(b, a, e[, S]) at (qb, qa) per e.

    qb, qa: (..., n_e) queries. W is (n_b, n_a, n_e) or stacked
    (n_b, n_a, n_e, S) surfaces sharing the queries. Returns (val, d/dqb,
    d/dqa), shaped like the queries (with a trailing S for stacked W);
    slopes are zero outside the grids (flat extrapolation)."""
    ib, b_lo, b_hi, tb, in_b = _bracket(bgrid, qb)
    ia, a_lo, a_hi, ta, in_a = _bracket(agrid, qa)
    n_e = W.shape[2]
    e_idx = torch.arange(n_e, device=W.device).expand_as(ib)
    W00 = W[ib - 1, ia - 1, e_idx]
    W01 = W[ib - 1, ia, e_idx]
    W10 = W[ib, ia - 1, e_idx]
    W11 = W[ib, ia, e_idx]
    if W.dim() == 4:
        tb, ta, b_lo, b_hi, a_lo, a_hi, in_b, in_a = (
            z[..., None] for z in (tb, ta, b_lo, b_hi, a_lo, a_hi, in_b, in_a))
    val = ((1 - tb) * (1 - ta) * W00 + (1 - tb) * ta * W01
           + tb * (1 - ta) * W10 + tb * ta * W11)
    zero = torch.zeros((), dtype=val.dtype, device=val.device)
    db = torch.where(in_b, ((1 - ta) * (W10 - W00) + ta * (W11 - W01)) / (b_hi - b_lo), zero)
    da = torch.where(in_a, ((1 - tb) * (W01 - W00) + tb * (W11 - W10)) / (a_hi - a_lo), zero)
    return val, db, da


def ValueFunction(value_next, xvals, model):
    """One Bellman step of the Calvo-access two-asset household.

    value_next: (2, n_b, n_a, n_e, 2) packed (∂V/∂b, ∂V/∂a) over the state
    (b, a, e, access). Returns {"Value": same packing, "B", "A", "C"}, the
    policies (n_b, n_a, n_e, 2).
    """
    liquid = model.heterogeneity["liquid"]
    illiq = model.heterogeneity["illiquid"]
    income = model.heterogeneity["income"]
    access = model.heterogeneity["access"]
    bgrid, agrid = liquid.grid, illiq.grid
    Pi = income.transition
    lam = access.transition[0, 1]                  # i.i.d. access probability
    n_b, n_a, n_e = liquid.n, illiq.n, income.n
    dtype, device = value_next.dtype, value_next.device

    p = model.params
    beta, gamma = p["β"], p["γ"]
    r, ra, tau, w = xvals["r"], xvals["ra"], xvals["tau"], xvals["w"]
    y_e = floor((1.0 - tau) * w, 1e-9) * income.grid               # (n_e,)
    btop, atop = bgrid[-1], agrid[-1]

    # 1. Continuations on the (b', a', e) lattice: expectation over the
    #    i.i.d. access draw, then over e'.
    Vmix = (1.0 - lam) * value_next[..., 0] + lam * value_next[..., 1]   # (2, b, a, e)
    WW = floor(beta * (Vmix @ Pi.T), 1e-12)
    Wb, Wa = WW[0], WW[1]
    WWs = WW.permute(1, 2, 3, 0)                                   # (b, a, e, 2)

    # ── No access: capped accrual, payout into the liquid budget, liquid EGM.
    a_raw = (1.0 + ra) * agrid                                     # (n_a,)
    a_next = torch.minimum(a_raw, atop)
    payout = a_raw - a_next                                        # ≥ 0, top only
    capped = a_raw >= atop
    inc_n = payout[None, :, None] + y_e[None, None, :]             # (1, n_a, n_e)
    # Both surfaces at the capped-accrual point a_next (a function of a only).
    W_n = _interp_axis(WWs, agrid, a_next[None, :, None].expand(n_b, n_a, n_e), axis=1)
    Wb_n, Wa_n = W_n[..., 0], W_n[..., 1]
    c_end_n = _crra_inv_marg(Wb_n, gamma)
    implied_b = (c_end_n + bgrid[:, None, None] - inc_n) / (1.0 + r)
    pol_b_n = interp_columns(bgrid, implied_b.reshape(n_b, n_a * n_e),
                             bgrid[:, None].expand(n_b, n_a * n_e))
    # Policies stay inside the grid box: the lottery sends off-grid mass to
    # the last node, and aggregates must match that truncated distribution.
    pol_b_n = torch.minimum(floor(pol_b_n.reshape(n_b, n_a, n_e), p["borrow_cons"]), btop)
    pol_a_n = a_next[None, :, None].expand(n_b, n_a, n_e)
    c_n = floor((1.0 + r) * bgrid[:, None, None] + inc_n - pol_b_n, 1e-12)

    # ── Access: optimal split + EGM over total savings on s_grid.
    s_grid = bgrid * ((btop + atop) / btop)                        # (n_s,)
    n_s = n_b
    s2 = s_grid[:, None].expand(n_s, n_e)
    G = Wb - Wa                                                    # FOC gap surface
    chi = float(p.get("portfolio_reg", 0.0))
    if chi > 0.0:
        mid = 0.5 * s2
        wsum_mid, _, _ = _bilinear(Wb + Wa, bgrid, agrid, mid, mid)
        pen_slope = chi * wsum_mid / torch.maximum(s2, s_grid[1])  # (n_s, n_e)
    else:
        pen_slope = None

    def g_fun(G_, pen_, a_s):
        """FOC gap g = G(s − a', a') (+ penalty) along the budget line and
        its exact slope (increasing in a')."""
        gv, g_db, g_da = _bilinear(G_, bgrid, agrid, s2 - a_s, a_s)
        gp = g_da - g_db
        if pen_ is not None:
            gv = gv + pen_ * (a_s - 0.5 * s2)
            gp = gp + pen_
        return gv, gp

    # The root is found on detached surfaces (its iterations carry no
    # derivative); between consecutive breakpoints (a-knots, b-knots and the
    # endpoints of [0, s]) g is an exact quadratic.
    G0 = G.detach()
    pen0 = pen_slope.detach() if pen_slope is not None else None
    zero = torch.zeros((), dtype=dtype, device=device)
    cand = torch.cat([torch.zeros((1, n_s, n_e), dtype=dtype, device=device),
                      agrid[:, None, None].expand(n_a, n_s, n_e),
                      s2[None] - bgrid[:, None, None].expand(n_b, n_s, n_e),
                      s2[None]], dim=0)
    cand = torch.minimum(floor(cand, 0.0), s2[None])               # (K, n_s, n_e)
    g_cand, _ = g_fun(G0, pen0, cand)
    g_lo, g_hi = g_cand[0], g_cand[-1]
    # Monotone bracket without a sort: the largest negative candidate and
    # the smallest non-negative one.
    neg = g_cand < 0
    big = torch.tensor(torch.finfo(dtype).max, dtype=dtype, device=device)
    lo = torch.amax(torch.where(neg, cand, -big), dim=0)
    hi = torch.amin(torch.where(neg, big, cand), dim=0)
    g0 = torch.amax(torch.where(neg, g_cand, -big), dim=0)
    g1 = torch.amin(torch.where(neg, big, g_cand), dim=0)
    has_neg = neg.any(dim=0)
    has_pos = (~neg).any(dim=0)
    lo = torch.where(has_neg, lo, zero)
    g0 = torch.where(has_neg, g0, -torch.ones_like(g0))
    hi = torch.where(has_pos, hi, s2)
    g1 = torch.where(has_pos, g1, torch.ones_like(g1))
    # Quadratic on [lo, hi] from the endpoints and the midpoint, u = (a'−lo)/h;
    # the citardauq root covers the linear limit a2 → 0.
    h = hi - lo
    gm, _ = g_fun(G0, pen0, 0.5 * (lo + hi))
    a0 = g0
    a1c = -3.0 * g0 + 4.0 * gm - g1
    a2c = 2.0 * g0 - 4.0 * gm + 2.0 * g1
    disc = floor(a1c * a1c - 4.0 * a2c * a0, 0.0)
    sgn = torch.where(a1c >= 0, torch.ones_like(a1c), -torch.ones_like(a1c))
    q = -0.5 * (a1c + sgn * torch.sqrt(disc))
    one = torch.ones_like(q)
    u_a = a0 / torch.where(q.abs() > 0, q, one)                    # citardauq root
    u_b = q / torch.where(a2c.abs() > 0, a2c, one)                 # classic root
    in01 = (u_a >= 0.0) & (u_a <= 1.0) & (q.abs() > 0)
    u = clip(torch.where(in01, u_a, u_b), 0.0, 1.0)
    a_iter = torch.where(h > 0, lo + u * h, lo).detach()

    # One Newton step at the detached root with the slope held constant:
    # the primal is unchanged and the derivative is the implicit-function
    # one, −g_θ/g_a.
    g_at, g_a = g_fun(G, pen_slope, a_iter)
    g_a = floor(g_a.detach(), 1e-10)
    a_star = torch.minimum(floor(a_iter - g_at / g_a, 0.0), s2)
    # Corners: the marginal unit is strictly better in one asset over [0, s].
    a_star = torch.where(g_lo >= 0, zero, torch.where(g_hi <= 0, s2, a_star))
    b_star = s2 - a_star
    # Both surfaces at the split point.
    w_ba, w_db, w_da = _bilinear(WWs, bgrid, agrid, b_star, a_star)
    wb_s, wa_s = w_ba[..., 0], w_ba[..., 1]
    # Marginal value of savings as the slope-weighted combination of the two
    # surfaces, M̂ = (wb'·wa − wa'·wb)/g' (first-order insensitive to split
    # error, and its derivative is the envelope one); max(wb, wa) at corners
    # and where the slopes degrade.
    wbp = w_da[..., 0] - w_db[..., 0]                              # ≥ 0 interior
    wap = w_da[..., 1] - w_db[..., 1]                              # ≤ 0 interior
    gp_s = wbp - wap
    combo_ok = ((a_star > 0.0) & (a_star < s2) & (wbp >= 0.0) & (wap <= 0.0)
                & (gp_s > 1e-10))
    M_combo = (wbp * wa_s - wap * wb_s) / torch.where(combo_ok, gp_s, torch.ones_like(gp_s))
    W_s = torch.where(combo_ok, M_combo, torch.maximum(wb_s, wa_s))  # (n_s, n_e)

    c_end_s = _crra_inv_marg(W_s, gamma)
    w_knots = c_end_s + s2                                         # (n_s, n_e)

    # On-grid cash-on-hand and savings policy through the endogenous w-grid.
    w_grid = ((1.0 + r) * bgrid[:, None, None] + (1.0 + ra) * agrid[None, :, None]
              + y_e[None, None, :])
    wq = w_grid.reshape(n_b * n_a, n_e)
    pol_s = floor(interp_columns(wq, w_knots, s2), 0.0)            # (n_b·n_a, n_e)
    pol_a_a = interp_columns(pol_s, s2, a_star)                    # split at s*
    pol_a_a = torch.minimum(floor(pol_a_a, 0.0), torch.minimum(pol_s, atop))
    pol_b_a = torch.minimum(floor(pol_s - pol_a_a, p["borrow_cons"]), btop)
    # Consumption from the final clipped policies: the budget identity holds
    # exactly at every state.
    c_a = floor(wq - pol_b_a - pol_a_a, 1e-12)
    pol_b_a = pol_b_a.reshape(n_b, n_a, n_e)
    pol_a_a = pol_a_a.reshape(n_b, n_a, n_e)
    c_a = c_a.reshape(n_b, n_a, n_e)

    # ── Envelopes. No access: the illiquid margin accrues at (1+ra) below
    # the cap (W_a at (b', a')) and is worthless at the cap.
    Wa_n_at_b = _interp_axis(Wa_n, bgrid, pol_b_n, axis=0)
    Va_margin_n = torch.where(capped[None, :, None], zero, Wa_n_at_b)
    up_n = _crra_marg(c_n, gamma)
    up_a = _crra_marg(c_a, gamma)
    value = torch.stack([torch.stack([(1.0 + r) * up_n, (1.0 + r) * up_a], dim=-1),
                         torch.stack([(1.0 + ra) * Va_margin_n, (1.0 + ra) * up_a], dim=-1)])
    return {
        "Value": value,
        "B": torch.stack([pol_b_n, pol_b_a], dim=-1),
        "A": torch.stack([pol_a_n, pol_a_a], dim=-1),
        "C": torch.stack([c_n, c_a], dim=-1),
    }


ValueFunction.n_values = 2
