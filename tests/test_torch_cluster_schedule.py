"""PyTorch port: the schedule of the one-asset cluster sweep, on the CPU.

`household_sweep_cluster_kernel<S, TANGENT, BATCHED>` (`hank_tpu_torch/csrc/
household_sweep_cluster.cu`) is held bit for bit to the global-state
instantiations `household_sweep_ranged_kernel<S, TANGENT, BATCHED, true>`
and to the one-block kernels on the card. Every state's arithmetic is the
ranged kernel's, expression for expression; the cluster changes who
computes a state, where its inputs come from and when. The functions below
transcribe both schedules of the whole sweep in numpy, with a tangent in
float32 and in float64 and values only in float64 (kernel 2's form), with
the kernels' roundings (an FMA is one rounding of the exact product plus the
addend: the product of two float32 is exact in float64, and rounding that
sum to float32 is the FMA but for a double rounding; in float64 Dekker's
exact product and an error-free sum stand for it; either form is shared by
both schedules):

  - the one-block order (`sweep_one_block`): one block of 1024 threads
    over all n = n_a·n_e states of each stage, the expectation summed over
    k = 0..n_e−1, the Markov mix over e = 0..n_e−1, each aggregate as
    thread tid's fold over states tid, tid + 1024, … then the tree over the
    1024 partials (its levels to 32, then five warp-shuffle strides);
  - the cluster (`sweep_cluster`): C ≤ min(n_e, 8) blocks (min(n_e, 8) on
    a single path; a batch takes the size `fused_sweep2.batch_cluster`
    picks), block r owning the income rows e ≡ r (mod C) in row slots
    e // C of its own buffers;
    X (V, then D) and Y (D_half) and, with a tangent, theirs in two buffers by
    period parity; the expectation and the mix reading the other rows from
    their owners, in the same order; one barrier a half-period; block 0
    replaying period t's aggregates, the one-block fold and tree over every
    row's D_{t+1} read from its owner, after the next barrier (the last
    period's after one more); the fallback rows counted per block and
    summed in rank order. Every access of another block's buffer is
    logged per barrier phase, and no buffer is read by another block in a
    phase in which its owner writes it.

They are held equal bit for bit, outputs and fallback counts, on seeded
inputs shaped as the EGM meets them at 40×5 (near the steady state, with
two knots of the grid swapped, with a NaN in V_T), at 40×9 and 40×17
(clusters of 8, blocks holding two or three rows) and at a 1200×7-shaped
case, on clusters of every size C = 1 … min(n_e, 8); a batch of B = 3
paths (`sweep_cluster_batch`: one cluster a path, each writing its own
slice of one policy scratch, its own output row and its own two counts)
gives each row's single-path bits. The cluster's shared memory
(`cluster_smem_bytes`) is transcribed and its limits at n_e = 7 stated, and
the batched launches' cluster-size rule is held at 1200×7-shaped counts.
"""

import numpy as np
import pytest
import torch

from hank_tpu_torch.model.grids import make_double_exponential_grid, rouwenhorst
from hank_tpu_torch.ops.fused_sweep2 import batch_cluster

torch.set_num_threads(1)
f32, f64 = np.float32, np.float64
K_THREADS = 1024
MAX_CLUSTER = 8
SMEM = 232_448                  # dynamic shared memory of one block (227 KB)


# ── arithmetic ─────────────────────────────────────────────────────────────

def _split(x):
    t = 134217729.0 * x          # 2^27 + 1: Veltkamp's split
    hi = t - (t - x)
    return hi, x - hi


def fma(a, b, c, dt):
    """a·b + c rounded once (float32), or by the exact product and an
    error-free sum (float64)."""
    with np.errstate(all="ignore"):
        if dt == f32:
            return (np.asarray(a, f64) * np.asarray(b, f64) + np.asarray(c, f64)).astype(f32)
        a, b, c = (np.asarray(v, f64) for v in (a, b, c))
        p = a * b
        ah, al = _split(a)
        bh, bl = _split(b)
        e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
        s = p + c
        bb = s - p
        t = (p - (s - bb)) + (c - bb)
        out = s + (t + e)
        return np.where(np.isfinite(out), out, p + c)


def spow(a, b, dt):
    with np.errstate(all="ignore"):
        return np.power(np.asarray(a, dt), dt(b)).astype(dt)


def sel(cond, a, b, dt):
    return np.where(cond, a, b).astype(dt)


# ── the per-state arithmetic both schedules share ──────────────────────────

def grid_tables(g, dt):
    """glo, ghi, iup, idn: the hat basis' neighbours and slopes."""
    n_a = g.shape[0]
    lo = np.concatenate([[g[0] - (g[1] - g[0])], g[:-1]]).astype(dt)
    hi = np.concatenate([g[1:], [g[-1] + (g[-1] - g[-2])]]).astype(dt)
    with np.errstate(all="ignore"):
        return lo, hi, (dt(1) / (g - lo)).astype(dt), (dt(1) / (hi - g)).astype(dt)


def euler(E, dE, lab_e, g, pr, dt):
    """Steps 1-3 after the expectation: the floor, the Euler inversion and
    the implied wealth, with their tangents."""
    r, w, dr, dw, beta, gamma = pr
    tiny, one_r, inv_g = dt(1e-12), dt(1) + r, dt(-1) / gamma
    with np.errstate(all="ignore"):
        live = E > tiny
        E = sel(live, E, tiny, dt)
        c = spow((beta * E).astype(dt), inv_g, dt)
        implied = ((fma(-w, lab_e, c, dt) + g).astype(dt) / one_r).astype(dt)
        dc = sel(live, ((inv_g * c).astype(dt) / E).astype(dt) * dE, dt(0), dt)
        dY = (fma(-dw, lab_e, dc, dt) / one_r).astype(dt) - ((implied * dr).astype(dt)
                                                             / one_r).astype(dt)
    return implied, dY.astype(dt)


def row_monotone(K):
    return bool(np.all(K[:-1] <= K[1:]))


def policy(K, dK, lab_e, g, pr, borrow, dt):
    """Steps 4-6 on one income row: the bracket (the count of knots below
    the query, which the binary search on a monotone row returns), the lerp
    and its tangent, the borrowing clip, the budget and the envelope.
    Returns (pol, dpol, V, dV), (n_a,) each."""
    r, w, dr, dw, beta, gamma = pr
    tiny, one_r = dt(1e-12), dt(1) + r
    n_a = g.shape[0]
    with np.errstate(all="ignore"):
        cnt = (K[None, :] < g[:, None]).sum(1)
        jb = np.clip(cnt, 1, n_a - 1)
        lo, hi = K[jb - 1], K[jb]
        vlo, vhi = g[jb - 1], g[jb]
        den = (hi - lo).astype(dt)
        safe = sel(den > 0, den, dt(1), dt)
        tw = np.fmin(np.fmax(((g - lo).astype(dt) / safe).astype(dt), dt(0)), dt(1)).astype(dt)
        span = (vhi - vlo).astype(dt)
        pol = fma(tw, span, vlo, dt)
        interior = (g > lo) & (g <= hi) & (den > 0)
        dlo, dhi = dK[jb - 1], dK[jb]
        dtw = sel(interior, (-fma(tw, (dhi - dlo).astype(dt), dlo, dt) / safe).astype(dt),
                  dt(0), dt)
        dpol = (dtw * span).astype(dt)
        unbound = pol > borrow
        pol = sel(unbound, pol, borrow, dt)
        cg_raw = (fma(one_r, g, (w * lab_e).astype(dt), dt) - pol).astype(dt)
        cg_live = cg_raw > tiny
        cg = sel(cg_live, cg_raw, tiny, dt)
        cpow = spow(cg, -gamma, dt)
        V = (one_r * cpow).astype(dt)
        dpol = sel(unbound, dpol, dt(0), dt)
        dcg = sel(cg_live, (fma(dr, g, (dw * lab_e).astype(dt), dt) - dpol).astype(dt),
                  dt(0), dt)
        env = ((((one_r * -gamma).astype(dt) * cpow).astype(dt) / cg).astype(dt)
               * dcg).astype(dt)
        dV = fma(dr, cpow, env, dt)
    return pol, dpol, V, dV


def clamp(pol, dpol, D, g, dt):
    """The forward clamp of one row: the clipped policy, dQ = dpol·D, and
    whether the row is non-decreasing."""
    p = np.fmin(np.fmax(pol, g[0]), g[-1]).astype(dt)
    return p, (dpol * D).astype(dt), row_monotone(p)


def lottery(P, dQ, D, dD, g, tables, dt):
    """D_half and its tangent on one row: for each destination b the sum
    over the sources a in order of hat_b(p_a)·D_a, sources outside
    (g_{b-1}, g_{b+1}] skipped (the range the binary search gives on a
    monotone row holds only sources inside)."""
    glo, ghi, iup, idn = tables
    acc, dacc = np.zeros_like(g), np.zeros_like(g)
    with np.errstate(all="ignore"):
        for a in range(g.shape[0]):
            p = P[a]
            inside = (p > glo) & (p <= ghi)
            up = ((p - glo).astype(dt) * iup).astype(dt)
            down = ((ghi - p).astype(dt) * idn).astype(dt)
            hat = sel(down < up, down, up, dt)
            slope = sel(p > g, -idn, iup, dt)
            acc = sel(inside, fma(hat, D[a], acc, dt), acc, dt)
            term = fma(hat, dD[a], (slope * dQ[a]).astype(dt), dt)
            dacc = sel(inside, (dacc + term).astype(dt), dacc, dt)
    return acc, dacc


def aggregate_terms(s, pol, dpol, Dn, dDn, g_b, lab_e, pr, dt):
    """One state's terms added to a thread's four partial sums s = [s0, s2,
    s1, s3] (savings, consumption and their tangents)."""
    r, w, dr, dw, beta, gamma = pr
    tiny, one_r = dt(1e-12), dt(1) + r
    with np.errstate(all="ignore"):
        cg_raw = (fma(one_r, g_b, (w * lab_e).astype(dt), dt) - pol).astype(dt)
        cg_live = cg_raw > tiny
        cg = sel(cg_live, cg_raw, tiny, dt)
        dcg = sel(cg_live, (fma(dr, g_b, (dw * lab_e).astype(dt), dt) - dpol).astype(dt),
                  dt(0), dt)
        return [fma(pol, Dn, s[0], dt), fma(cg, Dn, s[1], dt),
                (s[2] + fma(dpol, Dn, (pol * dDn).astype(dt), dt)).astype(dt),
                (s[3] + fma(dcg, Dn, (cg * dDn).astype(dt), dt)).astype(dt)]


def tree(partials, dt):
    """The block's tree over the 1024 partials of each sum: levels 512 … 32
    by barrier, then strides 16 … 1 by warp shuffle (a lane past the warp
    reads its own value); lane 0 holds the sum."""
    red = [np.array(p, dt) for p in partials]
    s = K_THREADS // 2
    while s >= 32:
        for q in red:
            q[:s] = (q[:s] + q[s:2 * s]).astype(dt)
        s //= 2
    out = []
    for q in red:
        v = q[:32].copy()
        for s in (16, 8, 4, 2, 1):
            v = (v + np.concatenate([v[s:], v[32 - s:]])).astype(dt)
        out.append(v[0])
    return out


def fold_aggregates(t, D_all, dD_all, pols, dpols, g, lab, pr, dt):
    """Period t's four aggregates: thread tid folds the states idx = tid,
    tid + 1024, … < n of (D_{t+1}, dD_{t+1}) in the one-block order, then
    the tree. D_all etc. are (n,) in the global order idx = e·n_a + b."""
    n_a = g.shape[0]
    n = D_all.shape[0]
    tid = np.arange(K_THREADS)
    s = [np.zeros(K_THREADS, dt) for _ in range(4)]
    for k in range(-(-n // K_THREADS)):
        idx = tid + K_THREADS * k
        live = idx < n
        i = np.where(live, idx, 0)
        e2, b = i // n_a, i % n_a
        new = aggregate_terms(s, pols[t].reshape(-1)[i], dpols[t].reshape(-1)[i], D_all[i],
                              dD_all[i], g[b], lab[e2], pr[t], dt)
        s = [np.where(live, q_new, q_old).astype(dt) for q_new, q_old in zip(new, s)]
    s0, s2, s1, s3 = tree(s, dt)
    return s0, s1, s2, s3          # agg, dagg, aggc, daggc


# ── the one-block order ────────────────────────────────────────────────────

def values_only(out):
    """(agg, aggc) of the four aggregates: what a values-only sweep returns.
    The primal arithmetic does not read a tangent, so a sweep without one
    gives the primal rows' bits (the transcription keeps zero tangents)."""
    return out[[0, 2]]


def sweep_one_block(inp, dt, tangent=True):
    """The global-state (and one-block) kernel's schedule. Returns the
    (4, Tm1) aggregates (agg, dagg, aggc, daggc), or without a tangent the
    (2, Tm1) (agg, aggc), and the fallback counts."""
    V_T, D0, g, lab, Pi, pr, borrow = inp
    n_e, n_a = V_T.shape
    Tm1 = len(pr)
    tables = grid_tables(g, dt)
    V, dV = V_T.copy(), np.zeros_like(V_T)
    pols, dpols = np.zeros((Tm1, n_e, n_a), dt), np.zeros((Tm1, n_e, n_a), dt)
    fell_k = fell_p = 0
    for t in range(Tm1 - 1, -1, -1):
        E, dE = np.zeros_like(V), np.zeros_like(V)
        for k in range(n_e):
            E = fma(Pi[:, k:k + 1], V[k][None, :], E, dt)
            dE = fma(Pi[:, k:k + 1], dV[k][None, :], dE, dt)
        Y, dY = euler(E, dE, lab[:, None], g[None, :], pr[t], dt)
        Vn, dVn = np.zeros_like(V), np.zeros_like(V)
        for e in range(n_e):
            fell_k += not row_monotone(Y[e])
            pols[t, e], dpols[t, e], Vn[e], dVn[e] = policy(Y[e], dY[e], lab[e], g, pr[t],
                                                           borrow, dt)
        V, dV = Vn, dVn
    D, dD = D0.copy(), np.zeros_like(D0)
    out = np.zeros((4, Tm1), dt)
    for t in range(Tm1):
        Yh, dYh = np.zeros_like(D), np.zeros_like(D)
        for e in range(n_e):
            P, dQ, mono = clamp(pols[t, e], dpols[t, e], D[e], g, dt)
            fell_p += not mono
            Yh[e], dYh[e] = lottery(P, dQ, D[e], dD[e], g, tables, dt)
        Dn, dDn = np.zeros_like(D), np.zeros_like(D)
        for e in range(n_e):
            Dn = fma(Pi[e][:, None], Yh[e][None, :], Dn, dt)
            dDn = fma(Pi[e][:, None], dYh[e][None, :], dDn, dt)
        out[:, t] = fold_aggregates(t, Dn.reshape(-1), dDn.reshape(-1), pols, dpols, g, lab,
                                    pr, dt)
        D, dD = Dn, dDn
    return (out if tangent else values_only(out)), (fell_k, fell_p)


# ── the cluster ────────────────────────────────────────────────────────────

class Cluster:
    """The blocks' shared buffers X, dX (V backward, D forward) and Y, dY
    (D_half forward), two period parities each, row slot gi of block r
    holding income row r + gi·C; every access of another block's buffer and
    every write, by barrier phase."""

    def __init__(self, C, n_e, n_a, dt, tangent=True):
        self.C, self.n_a = C, n_a
        self.G = -(-n_e // C)
        names = ("X", "dX", "Y", "dY") if tangent else ("X", "Y")
        self.mem = {(r, name): np.zeros((2, self.G, n_a), dt)
                    for r in range(C) for name in names}
        self.phase = 0
        self.remote_reads, self.writes = set(), set()

    def own(self, r, n_e):
        return list(range(r, n_e, self.C))

    def row(self, reader, name, parity, e):
        owner, gi = e % self.C, e // self.C
        if owner != reader:
            self.remote_reads.add((self.phase, owner, name, parity))
        return self.mem[(owner, name)][parity, gi]

    def put(self, r, name, parity, e, values):
        assert e % self.C == r
        self.writes.add((self.phase, r, name, parity))
        self.mem[(r, name)][parity, e // self.C] = values

    def barrier(self):
        self.phase += 1

    def hazards(self):
        """Buffers another block read in a phase in which their owner wrote
        them (the phase's blocks run in no order)."""
        return self.remote_reads & self.writes


def cluster_of(n_e):
    return min(n_e, MAX_CLUSTER)


def sweep_cluster(inp, dt, tangent=True, C=None, scratch=None):
    """The cluster kernel's schedule (module docstring) on a cluster of C
    blocks (default `cluster_of(n_e)`), with or without a tangent (without:
    no dX, dY buffers; the tangent arithmetic runs on zeros and is
    dropped). `scratch`: the (Tm1, n_e, n_a) policy scratch to write, a
    path's slice of a batch's. Returns what `sweep_one_block` returns, and
    the Cluster (its phases and accesses)."""
    V_T, D0, g, lab, Pi, pr, borrow = inp
    n_e, n_a = V_T.shape
    Tm1 = len(pr)
    C = cluster_of(n_e) if C is None else C
    cl = Cluster(C, n_e, n_a, dt, tangent)
    tables = grid_tables(g, dt)
    pols = np.zeros((Tm1, n_e, n_a), dt) if scratch is None else scratch
    dpols = np.zeros((Tm1, n_e, n_a), dt)
    fell = [[0, 0] for _ in range(C)]
    zero = np.zeros(n_a, dt)

    def put(r, name, parity, e, values):
        if tangent or not name.startswith("d"):
            cl.put(r, name, parity, e, values)

    def row(r, name, parity, e):
        return cl.row(r, name, parity, e) if tangent or not name.startswith("d") else zero

    for r in range(C):                          # V_T in the buffer period Tm1-1 reads
        for e in cl.own(r, n_e):
            put(r, "X", Tm1 & 1, e, V_T[e])
            put(r, "dX", Tm1 & 1, e, np.zeros(n_a, dt))
    cl.barrier()
    for t in range(Tm1 - 1, -1, -1):
        for r in reversed(range(C)):
            Y = {}
            for e in cl.own(r, n_e):
                E, dE = np.zeros(n_a, dt), np.zeros(n_a, dt)
                for k in range(n_e):
                    E = fma(Pi[e, k], row(r, "X", (t + 1) & 1, k), E, dt)
                    dE = fma(Pi[e, k], row(r, "dX", (t + 1) & 1, k), dE, dt)
                Y[e] = euler(E, dE, lab[e], g, pr[t], dt)
            for e in cl.own(r, n_e):
                fell[r][0] += not row_monotone(Y[e][0])
                pols[t, e], dpols[t, e], V, dV = policy(*Y[e], lab[e], g, pr[t], borrow, dt)
                put(r, "X", t & 1, e, V)
                put(r, "dX", t & 1, e, dV)
        cl.barrier()
    out = np.zeros((4, Tm1), dt)

    def aggregates(t):
        """Block 0: every row's D_{t+1} from its owner, the one-block fold."""
        D_all = np.concatenate([row(0, "X", (t + 1) & 1, e) for e in range(n_e)])
        dD_all = np.concatenate([row(0, "dX", (t + 1) & 1, e) for e in range(n_e)])
        out[:, t] = fold_aggregates(t, D_all, dD_all, pols, dpols, g, lab, pr, dt)

    def clamp_and_lottery(r, t):
        for e in cl.own(r, n_e):
            D, dD = row(r, "X", t & 1, e), row(r, "dX", t & 1, e)
            P, dQ, mono = clamp(pols[t, e], dpols[t, e], D, g, dt)
            fell[r][1] += not mono
            Yh, dYh = lottery(P, dQ, D, dD, g, tables, dt)
            put(r, "Y", t & 1, e, Yh)
            put(r, "dY", t & 1, e, dYh)

    for r in range(C):                          # D_0 in buffer 0, then period 0's lottery
        for e in cl.own(r, n_e):
            put(r, "X", 0, e, D0[e])
            put(r, "dX", 0, e, np.zeros(n_a, dt))
        clamp_and_lottery(r, 0)
    cl.barrier()
    for t in range(Tm1):
        for r in reversed(range(C)):
            for e2 in cl.own(r, n_e):
                Dn, dDn = np.zeros(n_a, dt), np.zeros(n_a, dt)
                for e in range(n_e):
                    Dn = fma(Pi[e, e2], row(r, "Y", t & 1, e), Dn, dt)
                    dDn = fma(Pi[e, e2], row(r, "dY", t & 1, e), dDn, dt)
                put(r, "X", (t + 1) & 1, e2, Dn)
                put(r, "dX", (t + 1) & 1, e2, dDn)
            if r == 0 and t > 0:
                aggregates(t - 1)
            if t + 1 < Tm1:
                clamp_and_lottery(r, t + 1)
        cl.barrier()
    aggregates(Tm1 - 1)
    cl.barrier()
    counts = tuple(sum(f[i] for f in fell) for i in (0, 1))
    return (out if tangent else values_only(out)), counts, cl


def sweep_cluster_batch(inp, prs, dt, tangent=True, C=None):
    """B = len(prs) paths of the cluster schedule in one launch, path b on
    its own cluster with prices prs[b]: its policies into its slice of one
    (B, Tm1, n_e, n_a) scratch (offset b·Tm1·n), its aggregates into row b
    of a (B, k, Tm1) output and its counts at 2b of a (2B,) array, as
    `path_offset<BATCHED>` places them. Returns (out, counts, scratch)."""
    V_T = inp[0]
    n_e, n_a = V_T.shape
    B, Tm1 = len(prs), len(prs[0])
    scratch = np.full(B * Tm1 * n_e * n_a, np.nan, dt)
    out = np.full((B, 4 if tangent else 2, Tm1), np.nan, dt)
    counts = np.full(2 * B, -1)
    per_path = Tm1 * n_e * n_a
    for b, pr in enumerate(prs):
        view = scratch[b * per_path:(b + 1) * per_path].reshape(Tm1, n_e, n_a)
        out[b], counts[2 * b:2 * b + 2], _ = sweep_cluster((*inp[:5], pr, inp[6]), dt,
                                                           tangent, C, scratch=view)
    return out, counts, scratch


# ── inputs ─────────────────────────────────────────────────────────────────

def inputs(dt, n_a, n_e, Tm1, seed=0, case="near"):
    """Seeded inputs shaped as the EGM meets them (`tests/test_torch_sweep_bits.py`'s
    recipe): V_T the marginal value of a consumption rule rising in wealth,
    a seeded D0, Krusell-Smith's β, γ and prices with noise. `case`:
    "swapped" swaps two knots of the grid (the fallback branches), "nan"
    puts a NaN in V_T."""
    rng = np.random.default_rng(seed)
    grid = make_double_exponential_grid(0.0, 200.0, n_a)
    Pi, _, z = rouwenhorst(n_e, 0.966, 0.283)
    r0, w0 = 0.01, 0.9
    c = 0.05 * grid[None, :] + 0.9 * w0 * z[:, None] + 0.3
    V = (1 + r0) * c ** -2.0                              # (n_e, n_a): the kernel layout
    D = rng.uniform(0.5, 1.5, (n_e, n_a))
    paths = np.stack([r0 * (1 + 0.05 * rng.normal(size=Tm1)),
                      w0 * (1 + 0.02 * rng.normal(size=Tm1)),
                      0.01 * rng.normal(size=Tm1), 0.01 * rng.normal(size=Tm1)], 1)
    if case == "swapped":
        k = n_a // 2
        grid[[k, k + 1]] = grid[[k + 1, k]]
    if case == "nan":
        V[2, 17] = np.nan
    pr = [tuple(dt(v) for v in (*row, 0.982, 2.0)) for row in paths]   # r, w, dr, dw, β, γ
    return (V.astype(dt), (D / D.sum()).astype(dt), grid.astype(dt), z.astype(dt),
            Pi.astype(dt), pr, dt(0.0))


def same_bits(a, b):
    return a.shape == b.shape and bool(np.array_equal(a.view(np.uint8), b.view(np.uint8)))


CASES = [(40, 5, 11, "near"), (40, 5, 11, "swapped"), (40, 5, 11, "nan"),
         (40, 9, 6, "near"), (40, 17, 4, "swapped"), (1200, 7, 3, "near")]
# (dtype, tangent): kernel 1's and kernels 3-4's form, the f64 tangent
# sweep's, kernel 2's.
FORMS = {"f32": (f32, True), "f64": (f64, True), "f64_values": (f64, False)}


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("n_a,n_e,Tm1,case", CASES,
                         ids=[f"{a}x{e}_{c}" for a, e, _, c in CASES])
def test_cluster_schedule_is_bit_for_bit_the_one_block_order(form, n_a, n_e, Tm1, case):
    """Every aggregate (and its tangent), and both fallback counts, equal
    bit for bit on a cluster of every size C = 1 … min(n_e, 8); no buffer
    is read by another block in a phase its owner writes it; 2(T−1) + 3
    cluster barriers in all (one after V_T is loaded, one a half-period,
    one before the last aggregates, one before the blocks leave). The
    1200×7 case takes the single path's C = 7 and the other sizes down to
    the least whose blocks fit (3 in f32 with a tangent and in f64 without;
    the f64 tangent sweep, which has no batched form, 7 alone)."""
    dt, tangent = FORMS[form]
    inp = inputs(dt, n_a, n_e, Tm1, seed=n_a + n_e, case=case)
    ref, ref_counts = sweep_one_block(inp, dt, tangent)
    sizes = range(1, cluster_of(n_e) + 1)
    if n_a == 1200:
        sizes = [C for C in sizes
                 if cluster_smem_bytes(dt().itemsize, n_a, n_e, tangent, C) <= SMEM]
        assert min(sizes) == (7 if (dt, tangent) == (f64, True) else 3)
    for C in sizes:
        out, counts, cl = sweep_cluster(inp, dt, tangent, C)
        assert same_bits(out, ref), C
        assert counts == ref_counts, C
        assert not cl.hazards(), C
        assert cl.phase == 2 * Tm1 + 3
        assert cl.remote_reads or C == 1
    if case == "near":
        assert np.isfinite(out).all() and counts == (0, 0)
    if case == "swapped":
        assert counts[1] > 0
    if case == "nan":
        assert counts[0] > 0


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("n_e,C", [(5, 5), (5, 2), (9, 4), (7, 7)])
def test_batched_cluster_rows_are_bit_for_bit_single_paths(form, n_e, C):
    """A batch of B = 3 paths (seeded prices each, the second grid's knots
    swapped for its fallback rows) on clusters of C: row b's aggregates and
    counts are bit for bit a single-path cluster launch on row b (C =
    min(n_e, 8)) and the one-block order's, and the paths' policy slices
    tile the scratch with no element written twice or left unwritten."""
    dt, tangent = FORMS[form]
    inp = inputs(dt, 40, n_e, 5, seed=21 + n_e, case="swapped")
    prs = [inputs(dt, 40, n_e, 5, seed=30 + b)[5] for b in range(3)]
    out, counts, scratch = sweep_cluster_batch(inp, prs, dt, tangent, C)
    assert np.isfinite(scratch).all()
    for b, pr in enumerate(prs):
        row_inp = (*inp[:5], pr, inp[6])
        single, single_counts, _ = sweep_cluster(row_inp, dt, tangent)
        ref, ref_counts = sweep_one_block(row_inp, dt, tangent)
        assert same_bits(out[b], single) and same_bits(out[b], ref)
        assert tuple(counts[2 * b:2 * b + 2]) == single_counts == ref_counts
        assert single_counts[1] > 0
    assert not same_bits(out[0], out[1])


@pytest.mark.parametrize("tangent", [True, False], ids=["tangent", "values"])
def test_a_cluster_schedule_with_one_buffer_would_race(tangent):
    """The check bites: with Y in one buffer (both parities in slot 0) the
    mix of period t reads rows that their owners overwrite with period
    t+1's lottery in the same phase, with a tangent (Y, dY) and without
    (Y alone)."""
    inp = inputs(f32, 40, 5, 4, seed=3)
    _, _, cl = sweep_cluster(inp, f32, tangent)
    names = {name for _, name in cl.mem}
    assert names == ({"X", "dX", "Y", "dY"} if tangent else {"X", "Y"})
    single = {(phase, owner, name, 0) for phase, owner, name, _ in cl.remote_reads
              if name in ("Y", "dY")}
    writes = {(phase, r, name, 0) for phase, r, name, _ in cl.writes if name in ("Y", "dY")}
    assert single & writes


# ── shared memory ──────────────────────────────────────────────────────────

def cluster_smem_bytes(size, n_a, n_e, tangent=True, C=None):
    """`cluster_smem_bytes<S, TANGENT>`: per block of a cluster of C
    (default `cluster_of(n_e)`), the state (X, Y twice and P: 5 G·n_a
    values; with their tangents 10 G·n_a), the grid tables (5 n_a), labor,
    Pi, the reduction slots and the row flags (3 G ints and two counts)."""
    C = cluster_of(n_e) if C is None else C
    G = -(-n_e // C)
    return (size * ((10 if tangent else 5) * G * n_a + 5 * n_a + n_e + n_e * n_e
                    + (4 if tangent else 2) * K_THREADS) + 4 * (3 * G + 2))


def last_n_a(size, n_e, tangent=True):
    n_a = 2
    while cluster_smem_bytes(size, n_a + 1, n_e, tangent) <= SMEM:
        n_a += 1
    return n_a


def test_cluster_shared_memory_limits_at_seven_incomes():
    """At n_e = 7 (a cluster of 7, one row a block) the f32 tangent cluster
    kernel (kernel 1's and kernels 3-4's places) takes n_a ≤ 3597, the f64
    one n_a ≤ 1660 and the f64 values-only one (kernel 2's) n_a ≤ 2694:
    1200×7 fits all three, which the one-block kernels 1 (n_a ≤ 1147), 3-4
    (≤ 1148) and 2 (≤ 1036) and the f64 tangent sweep (≤ 529) do not. A
    batch on clusters of 4 (two rows a block) still takes 1200×7 in f32
    with a tangent (136,640 B a block), and on clusters of 3 in f32 with a
    tangent and in f64 without; not on clusters of 2."""
    assert (last_n_a(4, 7), last_n_a(8, 7), last_n_a(8, 7, False)) == (3597, 1660, 2694)
    assert cluster_smem_bytes(8, 1200, 7) == 8 * (12000 + 6000 + 7 + 49 + 4096) + 20
    assert cluster_smem_bytes(8, 1200, 7, False) == 112_852
    assert cluster_smem_bytes(4, 1200, 7, True, 4) == 136_640
    assert cluster_smem_bytes(4, 1200, 7, True, 3) <= SMEM < cluster_smem_bytes(4, 1200, 7,
                                                                                 True, 2)
    assert cluster_smem_bytes(8, 1200, 7, False, 3) <= SMEM < cluster_smem_bytes(8, 1200, 7,
                                                                                  False, 2)


@pytest.mark.parametrize("n_e", range(1, 21))
def test_cluster_takes_rows_over_at_most_eight_blocks(n_e):
    """One row a block up to 8 incomes, then ⌈n_e/8⌉ row slots a block;
    every block owns at least one row; the count grows with the slots."""
    C = cluster_of(n_e)
    G = -(-n_e // C)
    owned = [len(range(r, n_e, C)) for r in range(C)]
    assert C == min(n_e, 8) and sum(owned) == n_e and min(owned) >= 1 and max(owned) == G
    assert cluster_smem_bytes(8, 100, n_e) - cluster_smem_bytes(8, 99, n_e) == 8 * (10 * G + 5)
    assert cluster_smem_bytes(8, 100, n_e, False) - cluster_smem_bytes(8, 99, n_e, False) == \
        8 * (5 * G + 5)


def rule_at_1200x7(B, clusters):
    """`batch_cluster` as the batched one-asset launches ask it at 1200×7 in
    f32 with a tangent: the n_e = 7 rows over C = 7 … 1 blocks, the
    transcribed count per block, `clusters[C]` clusters the card holds."""
    return batch_cluster(B, 7, cluster_of(7),
                         lambda C: cluster_smem_bytes(4, 1200, 7, True, C) <= SMEM,
                         lambda C: clusters.get(C, 0))


def test_batched_cluster_size_rule_at_1200x7():
    """One path takes C = 7. At B = 16 on a card that holds 15 clusters of
    7 and 16 of each smaller size, C = 7 costs two waves of one row (2) and
    C = 6, 5 and 4 one wave of two rows (2): the tie goes to the larger C,
    7; with 16 clusters of 7 it is one wave. At B = 64 the least ⌈B /
    clusters(C)⌉ · ⌈7 / C⌉ wins (C = 4: 2 · 2); sizes whose blocks do not
    fit (C ≤ 2 in f32 with a tangent) are never taken, however cheap."""
    card = {7: 15, 6: 16, 5: 16, 4: 16, 3: 16}
    assert rule_at_1200x7(1, card) == 7
    assert rule_at_1200x7(16, card) == 7
    assert rule_at_1200x7(16, {**card, 7: 16}) == 7
    card = {7: 15, 6: 18, 5: 22, 4: 33, 3: 44, 2: 66, 1: 132}
    assert rule_at_1200x7(64, card) == 4
    assert rule_at_1200x7(1000, card) == 4          # C = 1 would cost 56 < 62
